"""On-device batch assembly in the PyTorch port
(``data/device_batcher.assemble_batch``) against the port's host
``BatchBuilder.build`` bit for bit and JAX's ``assemble_batch``, for the
same graph ids (JAX: ``tests/test_cv_ondevice.py:17``, on the absent
``mutag`` fixture; here on generated TU data)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.data.device_batcher import (
    DeviceDataset as JaxDeviceDataset,
)
from graph_transformer_tpu.data.device_batcher import (
    assemble_batch as jax_assemble,
)
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.device_batcher import (
    DeviceDataset,
    assemble_batch,
)
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset

FIELDS = ("x", "graph_id", "node_gidx", "node_mask", "labels")


@pytest.mark.parametrize("B,kw", [
    (4, dict(num_graphs=30, num_classes=3, mean_nodes=12, seed=0,
             reddit_like=False)),
    (7, dict(num_graphs=20, num_classes=2, mean_nodes=20, seed=4,
             reddit_like=True))])
def test_assemble_batch_matches_host_builder_and_jax(B, kw):
    """Five random id sets (and the B largest graphs, which fill n_pad):
    features, graph ids (B on padding), node ids (0 on padding), mask and
    labels equal the host builder's bit for bit and JAX's; ``neigh`` is
    each row's own slot and the edge arrays one-element stubs."""
    ds, dj = synthetic_powerlaw_dataset("S", **kw), jax_synthetic("S", **kw)
    builder = BatchBuilder(ds, batch_size=B, num_neighbors=3)
    dd, ddj = DeviceDataset.from_dataset(ds, "cpu"), \
        JaxDeviceDataset.from_dataset(dj)
    rng = np.random.default_rng(B)
    sets = [rng.choice(ds.num_graphs, size=B, replace=False)
            for _ in range(5)]
    sets.append(np.argsort(ds.graph_num_nodes)[-B:])
    for gids in sets:
        host = builder.build(gids)
        dev = assemble_batch(dd, torch.as_tensor(gids), builder.n_pad)
        ref = jax_assemble(ddj, jnp.asarray(gids, jnp.int32), builder.n_pad)
        for f in FIELDS:
            a = getattr(dev, f)
            assert a.dtype == getattr(host, f).dtype, f
            torch.testing.assert_close(a, getattr(host, f), rtol=0, atol=0)
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(
                ref, f)))
        assert dev.n_pad == builder.n_pad and dev.num_graphs == B
        np.testing.assert_array_equal(dev.neigh[:, 0].numpy(),
                                      np.arange(builder.n_pad))
        assert dev.edge_src.shape == (1,)
