"""The port's graph pooling (``ops/sparse.graph_sum_pool``): a one-hot
product, which adds in a fixed order on the card where ``index_add_`` (JAX's
``segment_sum``) adds with float atomics.  On the CPU it is held against
``index_add_`` within float32 rounding and against JAX's ``graph_sum_pool``
on the same inputs, with padding rows (graph id B) dropped.  The card test
``test_training_steps_repeat_bit_for_bit`` checks that two runs repeat."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.sparse import graph_sum_pool as jax_pool
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.ops.sparse import graph_sum_pool


def index_add_pool(node_vec, graph_id, num_graphs):
    pooled = torch.zeros(num_graphs + 1, node_vec.shape[1],
                         dtype=node_vec.dtype)
    pooled.index_add_(0, graph_id.to(torch.int64), node_vec)
    return pooled[:num_graphs]


def case(B, sizes, D, seed, pad):
    """node_vec [N, D] and graph ids, graph g holding sizes[g] rows in
    order, then ``pad`` padding rows of graph id B."""
    rng = np.random.default_rng(seed)
    gid = np.concatenate([np.repeat(np.arange(B), sizes),
                          np.full(pad, B)]).astype(np.int32)
    x = rng.standard_normal((len(gid), D)).astype(np.float32) * 10.0
    return x, gid


@pytest.mark.parametrize("B,sizes,D,pad", [
    (1, [5], 3, 0), (4, [3, 1, 7, 2], 19, 5), (16, list(range(1, 33, 2)), 65,
                                               100),
    (3, [0, 4, 2], 7, 9)])
def test_pool_matches_index_add_and_jax(B, sizes, D, pad):
    """Float32 rounding: each pooled value within 1e-5 of its magnitude
    (the sums of at most 31 rows of |x| < ~50) of ``index_add_`` and of
    JAX; an empty graph pools to 0; padding rows (large values here) never
    reach a graph."""
    x, gid = case(B, sizes, D, seed=B + D, pad=pad)
    x[len(gid) - pad:] = 1e6
    got = graph_sum_pool(torch.from_numpy(x), torch.from_numpy(gid), B)
    want = index_add_pool(torch.from_numpy(x), torch.from_numpy(gid), B)
    ref = np.asarray(jax_pool(jnp.asarray(x), jnp.asarray(gid), B))
    assert got.shape == (B, D) and got.dtype == torch.float32
    scale = np.abs(x[: len(gid) - pad]).sum() + 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * scale)
    for g, n in enumerate(sizes):
        if n == 0:
            assert not got[g].any()


def test_pool_of_a_batch_and_its_gradient():
    """On a host batch (padding rows of graph id B, zeroed by the node
    mask as the model masks them) the pooling and its gradient equal
    ``index_add_``'s: the gradient of row n is the cotangent of its graph,
    0 for padding."""
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, num_classes=2,
                                    mean_nodes=9, seed=2, reddit_like=False)
    b = BatchBuilder(ds, 4, 3, seed=1).build([0, 5, 7, 11])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b.n_pad, 6)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    mask = b.node_mask[:, None]
    (dx,) = torch.autograd.grad(
        (graph_sum_pool(x * mask, b.graph_id, 4) * g).sum(), x)
    (dx_ref,) = torch.autograd.grad(
        (index_add_pool(x * mask, b.graph_id, 4) * g).sum(), x)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=0)
    real = b.node_mask > 0
    torch.testing.assert_close(dx[real], g[b.graph_id[real].long()])
    assert not dx[~real].any()
