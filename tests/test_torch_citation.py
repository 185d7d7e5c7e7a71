"""The port's node datasets (``data/citation.py``) against the JAX package's
loaders, array for array: karate (the port's constants against networkx's
graph), the SBM generator, a Planetoid fixture written as
``tests/test_planetoid_loader.py`` writes it (with Citeseer's missing test
rows), PPI, npz and ``from_arrays``; ``dense_adj`` and its size guard;
``whole_dataset_batch`` (both packages' default builders, their C++
assemblers); the multiplex
bridge raising until its port."""

import numpy as np
import pytest

from graph_transformer_tpu.data import batching as jbatching
from graph_transformer_tpu.data import citation as jcit
from graph_transformer_tpu_torch.data import batching as tbatching
from graph_transformer_tpu_torch.data import citation as tcit
from test_planetoid_loader import _write_fixture, _write_ppi_fixture
from test_torch_batcher import jax_assembler

GRAPH_FIELDS = ("node_feat", "nbr_offsets", "nbr_ids", "graph_offsets",
                "labels")
NODE_FIELDS = ("node_labels", "train_mask", "val_mask", "test_mask")


def assert_same(a, b):
    """Every array of two NodeGraphDatasets equal, dtype included."""
    assert (a.name, a.num_classes) == (b.name, b.num_classes)
    assert a.graph.num_classes == b.graph.num_classes
    for f in GRAPH_FIELDS:
        x, y = getattr(a.graph, f), getattr(b.graph, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in NODE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [{}, dict(train_fraction=0.3, seed=4)])
def test_karate_equals_jax(kw):
    assert_same(tcit.karate_club(**kw), jcit.karate_club(**kw))
    assert len(tcit.KARATE_EDGES) == 78


@pytest.mark.parametrize("kw", [{}, dict(num_nodes=60, num_classes=4,
                                         feature_dim=160, seed=3)])
def test_sbm_equals_jax(kw):
    assert_same(tcit.sbm_synthetic(**kw), jcit.sbm_synthetic(**kw))


@pytest.mark.parametrize("name", ["cora", "citeseer"])
def test_planetoid_equals_jax(tmp_path, name):
    """The fixture leaves test node 14 out of ``tx`` (Citeseer's gap)."""
    _write_fixture(str(tmp_path), name)
    a = tcit.load_planetoid(name, data_dir=str(tmp_path))
    assert_same(a, jcit.load_planetoid(name, data_dir=str(tmp_path)))
    np.testing.assert_array_equal(a.graph.node_feat[14], 0.0)
    assert_same(tcit.load_node_dataset(name, data_dir=str(tmp_path)), a)
    with pytest.raises(FileNotFoundError):
        tcit.load_planetoid(name, data_dir=str(tmp_path / "none"))


@pytest.mark.parametrize("graph_index", [0, 1])
def test_ppi_equals_jax(tmp_path, graph_index):
    _write_ppi_fixture(str(tmp_path))
    assert_same(tcit.load_ppi(str(tmp_path), graph_index=graph_index),
                jcit.load_ppi(str(tmp_path), graph_index=graph_index))


@pytest.mark.parametrize("masks", [False, True])
def test_npz_and_from_arrays_equal_jax(tmp_path, masks):
    rng = np.random.default_rng(5)
    n = 30
    arrays = dict(src=rng.integers(0, n, 80), dst=rng.integers(0, n, 80),
                  features=rng.standard_normal((n, 7)).astype(np.float32),
                  labels=(rng.random((n, 4)) < 0.5).astype(np.float32))
    if masks:
        arrays.update(train_mask=rng.random(n) < 0.5,
                      val_mask=np.zeros(n, bool),
                      test_mask=rng.random(n) < 0.3)
    path = str(tmp_path / "g.npz")
    np.savez(path, **arrays)
    assert_same(tcit.load_npz(path), jcit.load_npz(path))
    assert_same(tcit.from_arrays("g", **arrays),
                jcit.from_arrays("g", **arrays))


def test_dense_adj_and_its_guard():
    a, b = tcit.karate_club(), jcit.karate_club()
    for n_pad in (None, 40):
        x, y = a.dense_adj(n_pad), b.dense_adj(n_pad)
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert a.dense_adj().sum() == 2 * len(tcit.KARATE_EDGES)
    with pytest.raises(ValueError, match="dense_adj"):
        a.dense_adj(n_pad=a.DENSE_ADJ_MAX_NODES + 1)
    ma, mb = a.to_multiplex(size_x=8), b.to_multiplex(size_x=8)
    assert ma.name == mb.name == "karate+sim"
    for f in ("x", "labels", "train_mask", "test_mask"):
        np.testing.assert_allclose(getattr(ma, f), getattr(mb, f), atol=1e-6)
    np.testing.assert_array_equal(ma.adj[:, :, 0], mb.adj[:, :, 0])


def test_whole_dataset_batch_equals_jax():
    """Both packages' default builders, which take their C++ assemblers."""
    jax_assembler()
    ds = tcit.sbm_synthetic(num_nodes=60, seed=1)
    t = tbatching.whole_dataset_batch(ds.graph, 4, pad_multiple=32, seed=9)
    j = jbatching.whole_dataset_batch(jcit.sbm_synthetic(
        num_nodes=60, seed=1).graph, 4, pad_multiple=32, seed=9)
    assert t.n_pad == 64
    for f in ("x", "neigh", "graph_id", "node_gidx", "node_mask", "edge_src",
              "edge_dst", "edge_mask", "labels"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError, match="unknown node dataset"):
        tcit.load_node_dataset("nope")
    assert sorted(tcit.NODE_DATASETS) == sorted(jcit.NODE_DATASETS)
