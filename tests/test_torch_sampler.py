"""The two-pass path's neighbor sampler of the PyTorch port (the plain
version of kernel K7, ``sampling/neighbor_table.sample_neighbors``).

The JAX sampler draws from the TPU's PRNG and is skipped off the TPU
(``tests/test_pallas_sampler.py:75-115``), so its draws are not compared.
The port's draws are held against K1's (both read the counters of
``ops/random.py``) and against the graph: slot 0 is the node, every other id
a neighbor of it (the node itself when it has none), and a hub's draws come
from its 128-entry subsample row."""

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.data.tu import (
    GraphDataset,
    synthetic_powerlaw_dataset,
)
from graph_transformer_tpu_torch.ops.attention import EncoderParams
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    sampled_forward_plain,
)
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    sample_neighbors,
    sample_neighbors_plain,
)

HEAVY = dict(num_graphs=3, mean_nodes=300, seed=1, reddit_like=False,
             heavy_tail=True)


@pytest.fixture(scope="module")
def graph():
    ds = synthetic_powerlaw_dataset("H", **HEAVY)
    table = build_neighbor_table(ds, hub_seed=0)
    n = ds.num_nodes
    return (ds, torch.from_numpy(table),
            torch.from_numpy(ds.degrees.astype(np.int32)),
            torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("K", [4, 16])
def test_draws_equal_k1_draws(graph, K):
    """For one seed K7's ids are the table entries K1's plain forward draws
    (a codebook dataset then gets the same neighborhoods on both paths)."""
    ds, rows, deg, gidx = graph
    n = ds.num_nodes
    ids = sample_neighbors_plain(1234, rows, deg, gidx, K)
    assert ids.shape == (n, K + 1) and ids.dtype == torch.int32
    p = EncoderParams(1, 2, 4).stacked()
    _, res = sampled_forward_plain(
        rows, deg, gidx, torch.zeros(int(n), 2), p, K + 1, 1, 0.0, 1234,
        mm=torch.float32)
    assert torch.equal(ids[:, 1:].long(), rows.long().gather(1, res["draws"]))
    assert not torch.equal(ids, sample_neighbors_plain(1235, rows, deg, gidx,
                                                       K))


def test_ids_are_the_node_and_its_neighbors(graph):
    ds, rows, deg, gidx = graph
    ids = sample_neighbors_plain(7, rows, deg, gidx, 16).long()
    assert torch.equal(ids[:, 0], gidx.long())
    n = ds.num_nodes
    src = np.repeat(np.arange(n), np.diff(ds.nbr_offsets))
    edges = set((src * n + ds.nbr_ids).tolist())
    keys = (torch.arange(n)[:, None] * n + ids[:, 1:]).flatten().tolist()
    assert all(k in edges for k in keys)


def test_hub_rows_draw_from_their_subsample(graph):
    ds, rows, deg, gidx = graph
    hubs = torch.from_numpy(np.flatnonzero(ds.degrees > 128))
    assert len(hubs) > 0
    ids = sample_neighbors_plain(9, rows[hubs], deg[hubs], gidx[hubs], 16)
    in_row = (rows[hubs].long()[:, None, :] == ids[:, 1:].long()[:, :, None])
    assert bool(in_row.any(-1).all())
    # the draws spread over the subsample, not a few of its entries
    assert len(set(ids[:, 1:].flatten().tolist())) > 8 * len(hubs)


def test_isolated_node_draws_itself():
    """Node 3 has no edge: its row holds itself, and so do its draws."""
    ds = GraphDataset(
        name="T", node_feat=np.eye(4, dtype=np.float32),
        nbr_offsets=np.array([0, 1, 3, 4, 4]),
        nbr_ids=np.array([1, 0, 2, 1], np.int32),
        graph_offsets=np.array([0, 4]), labels=np.zeros(1, np.int32),
        num_classes=1)
    rows = torch.from_numpy(build_neighbor_table(ds))
    deg = torch.from_numpy(ds.degrees.astype(np.int32))
    gidx = torch.arange(4, dtype=torch.int32)
    ids = sample_neighbors_plain(5, rows, deg, gidx, 6)
    assert ids[3].tolist() == [3] * 7
    assert set(ids[0, 1:].tolist()) == {1}
    assert set(ids[1, 1:].tolist()) <= {0, 2}


def test_cpu_tensors_take_the_plain_version(graph):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; any node ids may fill slot 0."""
    ds, rows, deg, gidx = graph
    sel = torch.randperm(ds.num_nodes, generator=torch.Generator()
                         .manual_seed(0))[:50]
    before = sample_neighbors.launches
    got = sample_neighbors(3, rows[sel], deg[sel], gidx[sel] + 1000, 8)
    assert sample_neighbors.launches == before
    assert torch.equal(got, sample_neighbors_plain(3, rows[sel], deg[sel],
                                                   gidx[sel] + 1000, 8))
    assert torch.equal(got[:, 0], gidx[sel] + 1000)
