"""The port's C++ batch assembler (``native/batcher.cpp``, ``batcher.py``)
and ``data/batching.BatchBuilder``'s backends against the JAX package's.

1. With the default backend on both sides (JAX's ``"auto"`` takes its
   assembler), the port's builder equals JAX's array for array: ``x``,
   ``neigh``, the node and edge arrays, masks and labels, over several
   seeds, batches and fanouts, and ``whole_dataset_batch`` alike.
2. The ``numpy`` backends still equal each other.
3. The assembler's own rules: slot 0 is the node itself, every neighbor is
   a neighbor in its own graph (or the node itself where it has none),
   padding rows point at themselves, the edges are the graphs' own;
   overflow raises as in JAX's ``tests/test_native.py:109``.
4. A failed build raises with the compiler's message (no fallback).
"""

import fcntl
import time
from pathlib import Path

import numpy as np
import pytest

import graph_transformer_tpu.native.batcher as jax_native
from graph_transformer_tpu.data import batching as jbatching
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu_torch.data import batching as tbatching
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.native import batcher, build

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("x", "neigh", "graph_id", "node_gidx", "node_mask", "edge_src",
          "edge_dst", "edge_mask", "labels")


def jax_assembler():
    """Load JAX's assembler library in this process.  Its build writes the
    library in place, so workers that start together take a lock, and a
    load that meets a library another process is still writing is tried
    again."""
    lock = ROOT / "build" / "native" / ".jax_batcher.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for attempt in range(5):
            try:
                return jax_native._load()
            except OSError:
                if attempt == 4:
                    raise
                time.sleep(1.0)


def datasets(seed, **kw):
    kw = dict(num_graphs=30, mean_nodes=14, seed=seed, reddit_like=False,
              **kw)
    return jax_synthetic("S", **kw), synthetic_powerlaw_dataset("S", **kw)


def assert_equal(bt, bj):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)), err_msg=f)


@pytest.mark.parametrize("seed,K", [(0, 8), (3, 4), (5, 1)])
def test_default_builder_equals_jax_default(seed, K):
    jax_assembler()
    dj, dt = datasets(seed)
    bj = jbatching.BatchBuilder(dj, 4, K, seed=seed + 10)
    bt = tbatching.BatchBuilder(dt, 4, K, seed=seed + 10)
    assert bj._native is not None and bt._native is not None
    assert (bt.n_pad, bt.e_pad) == (bj.n_pad, bj.e_pad)
    assert_equal(bt.build([0, 7, 2, 9]), bj.build([0, 7, 2, 9]))
    for _ in range(3):
        assert_equal(bt.sample(), bj.sample())
    for (t, nt), (j, nj) in zip(bt.eval_batches(np.arange(6)),
                                bj.eval_batches(np.arange(6))):
        assert nt == nj
        assert_equal(t, j)


def test_whole_dataset_batch_equals_jax_default():
    jax_assembler()
    dj, dt = datasets(2, heavy_tail=True)
    assert_equal(tbatching.whole_dataset_batch(dt, 5, seed=4),
                 jbatching.whole_dataset_batch(dj, 5, seed=4))


def test_numpy_backends_equal():
    dj, dt = datasets(1)
    bj = jbatching.BatchBuilder(dj, 4, 6, seed=2, backend="numpy")
    bt = tbatching.BatchBuilder(dt, 4, 6, seed=2, backend="numpy")
    assert bt._native is None
    for _ in range(3):
        assert_equal(bt.sample(), bj.sample())


def test_backends_differ_only_in_neighborhoods():
    """Same arrays but the draws: the assembler's come from its own
    generator, not numpy's."""
    _, dt = datasets(3)
    a = tbatching.BatchBuilder(dt, 4, 8, seed=0).build(np.arange(4))
    b = tbatching.BatchBuilder(dt, 4, 8, seed=0,
                               backend="numpy").build(np.arange(4))
    for f in FIELDS:
        same = np.array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
        assert same == (f != "neigh"), f


@pytest.mark.parametrize("seed", [0, 4])
def test_assembled_neighborhoods_are_graph_neighbors(seed):
    _, ds = datasets(seed, heavy_tail=True)
    bb = tbatching.BatchBuilder(ds, 5, 6, seed=seed)
    b = bb.build([1, 4, 8, 3, 11])
    n = int(b.node_mask.sum())
    neigh, gidx = b.neigh.numpy(), b.node_gidx.numpy()
    gid = b.graph_id.numpy()
    np.testing.assert_array_equal(neigh[:n, 0], np.arange(n))
    for v in range(n):
        s, e = ds.nbr_offsets[gidx[v]], ds.nbr_offsets[gidx[v] + 1]
        allowed = set(ds.nbr_ids[s:e].tolist()) or {gidx[v]}
        assert set(gidx[neigh[v, 1:]].tolist()) <= allowed
        assert (gid[neigh[v]] == gid[v]).all()
    np.testing.assert_array_equal(
        neigh[n:], np.tile(np.arange(n, bb.n_pad)[:, None], (1, 7)))
    assert (gid[n:] == 5).all() and (b.x.numpy()[n:] == 0).all()
    e = int(b.edge_mask.sum())
    src, dst = b.edge_src.numpy()[:e], b.edge_dst.numpy()[:e]
    assert (gid[src] == gid[dst]).all()
    assert e == int(ds.degrees[gidx[:n]].sum())


def test_overflow_raises_as_jax():
    _, ds = datasets(0)
    na = batcher.NativeBatchAssembler(ds)
    with pytest.raises(ValueError, match="nodes"):
        na.assemble(np.arange(30), 4, n_pad=64, e_pad=100_000, seed=0)
    with pytest.raises(ValueError, match="edges"):
        na.assemble(np.arange(8), 4, n_pad=4096, e_pad=8, seed=0)
    with pytest.raises(IndexError):
        na.assemble(np.array([30]), 4, n_pad=4096, e_pad=100_000, seed=0)
    with pytest.raises(ValueError, match="unknown backend"):
        tbatching.BatchBuilder(ds, 4, 4, backend="cpp")


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(build, "HERE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "TARGETS", {"batcher": "bad.cpp"})
    monkeypatch.setattr(batcher, "_lib", None)
    with pytest.raises(RuntimeError, match="bad.cpp") as err:
        tbatching.BatchBuilder(datasets(0)[1], 4, 4)
    assert "error" in str(err.value)
