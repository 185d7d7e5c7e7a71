"""Data layer of the PyTorch port against the JAX package: datasets, padded
batches, neighbor/tag tables and CV splits must be equal array for array."""

import dataclasses

import numpy as np
import pytest

from graph_transformer_tpu.data import splits as jax_splits
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu.ops.pallas_sampled_encoder import (
    setup_fused_tables as jax_fused_tables,
)
from graph_transformer_tpu.sampling.pallas_sampler import (
    build_neighbor_table as jax_neighbor_table,
)
from graph_transformer_tpu_torch.data import splits as torch_splits
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    setup_fused_tables,
)

DS_FIELDS = ("node_feat", "nbr_offsets", "nbr_ids", "graph_offsets", "labels")


def _assert_ds_equal(a, b):
    for f in DS_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.num_classes == b.num_classes and a.name == b.name


@pytest.mark.parametrize("kw", [
    dict(reddit_like=True),
    dict(reddit_like=False),
    dict(heavy_tail=True, mean_nodes=60),
])
def test_synthetic_dataset_equal(kw):
    args = dict(num_graphs=16, mean_nodes=40, seed=0)
    args.update(kw)
    _assert_ds_equal(jax_synthetic("S", **args),
                     synthetic_powerlaw_dataset("S", **args))


def test_synthetic_dataset_default_seed_equal():
    _assert_ds_equal(jax_synthetic(seed=0), synthetic_powerlaw_dataset(seed=0))


def test_batch_builder_equal():
    kw = dict(num_graphs=12, mean_nodes=30, seed=0, reddit_like=False)
    dj, dt = jax_synthetic("S", **kw), synthetic_powerlaw_dataset("S", **kw)
    bj = JaxBuilder(dj, batch_size=4, num_neighbors=8, seed=5,
                    backend="numpy")
    bt = BatchBuilder(dt, batch_size=4, num_neighbors=8, seed=5)
    assert (bj.n_pad, bj.e_pad) == (bt.n_pad, bt.e_pad)
    pairs = [(bj.build([0, 1, 2, 3]), bt.build([0, 1, 2, 3])),
             (bj.sample(), bt.sample()), (bj.sample(), bt.sample())]
    pairs += list(zip((b for b, _ in bj.eval_batches(range(6))),
                      (b for b, _ in bt.eval_batches(range(6)))))
    for a, b in pairs:
        for f in dataclasses.fields(a):
            x = np.asarray(getattr(a, f.name))
            y = getattr(b, f.name).numpy()
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name


def test_neighbor_and_fused_tables_equal():
    # heavy tail: root hubs beyond the 128-entry rows take the subsample
    kw = dict(num_graphs=4, mean_nodes=500, seed=1, heavy_tail=True,
              reddit_like=False)
    dj, dt = jax_synthetic("H", **kw), synthetic_powerlaw_dataset("H", **kw)
    assert int(dt.degrees.max()) > 128
    tj = jax_neighbor_table(dj, hub_seed=7)
    tt = build_neighbor_table(dt, hub_seed=7)
    np.testing.assert_array_equal(tj, tt)
    fj, ft = jax_fused_tables(dj.node_feat, tj), setup_fused_tables(
        dt.node_feat, tt)
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                      np.asarray(b).reshape(-1))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_fused_tables_reject_continuous_features():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((200, 3)).astype(np.float32)
    table = np.zeros((200, 128), np.int32)
    assert setup_fused_tables(feat, table) is None
    assert jax_fused_tables(feat, table) is None


@pytest.mark.parametrize("fold", [0, 3, 9])
def test_separate_data_idx_equal(fold):
    labels = np.random.default_rng(2).integers(0, 3, 97)
    for a, b in zip(jax_splits.separate_data_idx(labels, fold),
                    torch_splits.separate_data_idx(labels, fold)):
        np.testing.assert_array_equal(a, b)


def test_separate_data_idx_fallback_equal():
    """The machine with the card has no sklearn: the port's one numpy route
    (no sklearn import, no fallback) gives JAX's folds, which sklearn
    makes."""
    assert jax_splits._HAVE_SKLEARN
    assert not hasattr(torch_splits, "_HAVE_SKLEARN")
    labels = np.random.default_rng(3).integers(0, 2, 50)
    for fold in range(10):
        for a, b in zip(jax_splits.separate_data_idx(labels, fold),
                        torch_splits.separate_data_idx(labels, fold)):
            np.testing.assert_array_equal(a, b)
