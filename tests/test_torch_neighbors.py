"""The port's CSR neighborhood sampling (``sampling/neighbors.py``) against
the JAX package's.

JAX draws its neighbor positions with ``jax.random.randint``; the tests draw
the same positions with the same key and hand them to the port
(``neighborhoods_given``, and ``csr_draws`` replaced inside
``resample_batch_neighbors``), which must then give JAX's arrays exactly,
dtype included.  The port's own draws (``csr_draws``, keyed by a seed) are
checked for range, repetition and uniformity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.data.batching import BatchBuilder
from graph_transformer_tpu.data.tu import GraphDataset as JaxGraphDataset
from graph_transformer_tpu.sampling import neighbors as jnb
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.sampling import neighbors as nb

SIZES = (7, 1, 12, 5, 9)  # graph 1 is a lone isolated node


def dataset():
    """Five graphs with random edges; node 7 (graph 1), the last node of
    graph 2 and the last node of all (the end of the id array) are
    isolated."""
    r = np.random.default_rng(21)
    bounds = np.r_[0, np.cumsum(SIZES)]
    nbrs = [set() for _ in range(bounds[-1])]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        last = hi - 1 if hi - lo > 1 else hi  # keep each last node bare
        for _ in range(2 * (hi - lo)):
            if last - lo < 2:
                break
            a, b = r.integers(lo, last, 2)
            if a != b:
                nbrs[a].add(int(b))
                nbrs[b].add(int(a))
    iso = [v for v, s in enumerate(nbrs) if not s]
    offsets = np.r_[0, np.cumsum([len(s) for s in nbrs])].astype(np.int64)
    ids = np.concatenate([sorted(s) for s in nbrs]).astype(np.int32)
    n = bounds[-1]
    kw = dict(name="nbr", node_feat=np.eye(n, dtype=np.float32),
              nbr_offsets=offsets, nbr_ids=ids,
              graph_offsets=bounds.astype(np.int64),
              labels=np.arange(len(SIZES), dtype=np.int32) % 2, num_classes=2)
    return JaxGraphDataset(**kw), GraphDataset(**kw), iso


def jax_draws(key, jcsr, node_gidx, k):
    """The positions JAX's ``sample_neighborhoods`` draws with ``key``."""
    deg = jcsr.degrees[node_gidx]
    return jax.random.randint(key, (node_gidx.shape[0], k), 0,
                              jnp.maximum(deg, 1)[:, None], dtype=jnp.int32)


def equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 4])
def test_neighborhoods_given_matches_jax(k):
    """Every node and a repeated one, given JAX's draws: JAX's ids, the
    isolated nodes filled with themselves."""
    dj, dt, iso = dataset()
    assert len(iso) >= 3 and iso[-1] == dj.num_nodes - 1
    jcsr, csr = jnb.DeviceCSR.from_dataset(dj), nb.DeviceCSR.from_dataset(dt)
    nodes = np.r_[np.arange(dj.num_nodes), 3, iso[-1]].astype(np.int32)
    key = jax.random.key(k)
    want = jnb.sample_neighborhoods(key, jcsr, jnp.asarray(nodes), k)
    r = jax_draws(key, jcsr, jnp.asarray(nodes), k)
    got = nb.neighborhoods_given(csr, torch.from_numpy(nodes),
                                 torch.from_numpy(np.array(r)))
    equal(got, want)
    assert np.all(got.numpy()[iso] == np.array(iso)[:, None])


@pytest.mark.parametrize("graphs", [[0, 1, 2], [3, 1], [3]])
def test_batch_neighborhoods_match_jax(graphs, monkeypatch):
    """On a padded ``BatchBuilder`` batch (padding rows carry global id 0):
    ``global_to_local`` with and without the mask, and
    ``resample_batch_neighbors`` given JAX's draws, array for array.  (JAX's
    numpy builder cannot take graph 4, whose last node's list starts at the
    end of the id array; ``test_neighborhoods_given_matches_jax`` covers
    that node.)"""
    dj, dt, _ = dataset()
    bb = BatchBuilder(dj, batch_size=3, num_neighbors=3, pad_multiple=8,
                      seed=0, backend="numpy")
    b = bb.build(graphs)
    gidx, mask = np.asarray(b.node_gidx), np.asarray(b.node_mask)
    assert mask.sum() < bb.n_pad  # the batch has padding rows
    jcsr, csr = jnb.DeviceCSR.from_dataset(dj), nb.DeviceCSR.from_dataset(dt)
    key = jax.random.key(sum(graphs))
    neigh_g = jnb.sample_neighborhoods(key, jcsr, jnp.asarray(gidx), 3)
    tg, tm = torch.from_numpy(gidx), torch.from_numpy(mask)
    tn = torch.from_numpy(np.array(neigh_g))
    for m, tmask in ((jnp.asarray(mask), tm), (None, None)):
        equal(nb.global_to_local(tn, tg, dj.num_nodes, tmask),
              jnb.global_to_local(neigh_g, jnp.asarray(gidx), dj.num_nodes, m))
    r = torch.from_numpy(np.array(jax_draws(key, jcsr, jnp.asarray(gidx), 3)))
    monkeypatch.setattr(nb, "csr_draws", lambda seed, deg, k: r)
    got = nb.resample_batch_neighbors(0, csr, tg, tm, 3, dt.num_nodes)
    want = jnb.resample_batch_neighbors(key, jcsr, jnp.asarray(gidx),
                                        jnp.asarray(mask), 3, dj.num_nodes)
    equal(got, want)
    n_real = int(mask.sum())
    assert got.numpy()[:n_real].max() < n_real


@pytest.mark.parametrize("max_degree", [None, 2])
def test_padded_neighbor_table_matches_jax(max_degree):
    dj, dt, _ = dataset()
    got = nb.build_padded_neighbor_table(dt, max_degree)
    want = jnb.build_padded_neighbor_table(dj, max_degree)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_port_draws_in_range_repeat_and_uniform():
    """``csr_draws``: within ``[0, max(deg, 1))``, 0 for isolated nodes, the
    same for a seed and different for another, and each position of a
    degree-d list drawn about 1/d of the time; the port's own
    ``sample_neighborhoods`` and ``resample_batch_neighbors`` then give
    real neighbors, self at slot 0, and self-pointing padding."""
    _, dt, iso = dataset()
    csr = nb.DeviceCSR.from_dataset(dt)
    deg = csr.degrees
    r = nb.csr_draws(9, deg, 2000)
    assert r.dtype == torch.int64
    assert torch.all(r >= 0) and torch.all(r < deg.clamp_min(1)[:, None])
    assert not torch.any(r[iso])
    assert torch.equal(r, nb.csr_draws(9, deg, 2000))
    assert not torch.equal(r, nb.csr_draws(10, deg, 2000))
    for v in torch.nonzero(deg > 1).flatten().tolist():
        d = int(deg[v])
        freq = torch.bincount(r[v], minlength=d).double() / 2000
        assert torch.all((freq - 1.0 / d).abs() < 5 * (1.0 / d / 2000) ** 0.5
                         + 1e-3)
    nodes = torch.arange(dt.num_nodes, dtype=torch.int32)
    neigh = nb.sample_neighborhoods(3, csr, nodes, 5).numpy()
    assert neigh.dtype == np.int32 and neigh.shape == (dt.num_nodes, 6)
    for v in range(dt.num_nodes):
        lo, hi = dt.nbr_offsets[v], dt.nbr_offsets[v + 1]
        assert neigh[v, 0] == v
        assert set(neigh[v].tolist()) <= set(dt.nbr_ids[lo:hi].tolist()) | {v}
    gidx = torch.tensor([8, 9, 10, 11, 0, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    local = nb.resample_batch_neighbors(3, csr, gidx, mask, 4, dt.num_nodes)
    assert torch.equal(local[4:], torch.tensor([[4] * 5, [5] * 5],
                                               dtype=torch.int32))
    assert int(local[:4].max()) < 4
