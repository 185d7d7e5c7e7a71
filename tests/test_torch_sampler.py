"""The two-pass path's neighbor sampler of the PyTorch port (the plain
version of kernel K7, ``sampling/neighbor_table.sample_neighbors``).

The JAX sampler draws from the TPU's PRNG and is skipped off the TPU
(``tests/test_pallas_sampler.py:75-115``), so its draws are not compared.
The port's draws are held against K1's (both read the counters of
``ops/random.py``) and against the graph: slot 0 is the node, every other id
a neighbor of it (the node itself when it has none), and a hub's draws come
from its 128-entry subsample row.  The sampling stage of a training step
(``sample_neighborhoods``: K7's draws at a batch's rows, their feature rows
and their batch slots) is held against ``sample_neighbors_plain`` and the
feature gather, and its slots against the batch's own layout."""

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.data.batching import BatchBuilder
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
    sample_neighborhoods,
    sample_neighborhoods_plain,
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


SMALL = dict(num_graphs=20, mean_nodes=15, seed=2, reddit_like=False)


def rows_of(ds, where, seed=0):
    """(node_gidx int32, node_mask float32) of the rows a sampling stage
    sees: every node of ``ds`` in order (``graph``), or a ``BatchBuilder``
    batch with its padding rows (``batch``)."""
    if where == "graph":
        return (torch.arange(ds.num_nodes, dtype=torch.int32),
                torch.ones(ds.num_nodes))
    b = BatchBuilder(ds, 2, 4, seed=seed).sample()
    assert bool((b.node_mask == 0).any())
    return b.node_gidx, b.node_mask


@pytest.mark.parametrize("where", ["graph", "batch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [4, 16])
def test_neighborhoods_are_the_draws_and_their_rows(graph, K, dtype, where):
    """K7's sampling stage draws ``sample_neighbors_plain``'s ids from the
    dataset's table at the batch's node ids and writes ``x_global[ids]``,
    bit for bit, in ``x_global``'s dtype; on CPU tensors the wrapper is the
    plain version and launches nothing."""
    ds, table, deg, _ = graph
    gidx, mask = rows_of(ds, where)
    x_global = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (ds.num_nodes, 7)).astype(np.float32)).to(getattr(torch, dtype))
    g = gidx.long()
    ids = sample_neighbors_plain(404, table[g], deg[g], gidx, K)
    feat, slots, got = sample_neighborhoods_plain(
        404, table, deg, x_global, gidx, mask, K, with_ids=True)
    assert torch.equal(got, ids)
    assert feat.dtype == x_global.dtype and feat.shape == (len(g), K + 1, 7)
    assert torch.equal(feat, x_global[ids.long()])
    assert slots.dtype == torch.int64 and slots.shape == ids.shape
    before = sample_neighborhoods.launches
    wrapped = sample_neighborhoods(404, table, deg, x_global, gidx, mask, K)
    assert sample_neighborhoods.launches == before and wrapped[2] is None
    assert torch.equal(wrapped[0], feat) and torch.equal(wrapped[1], slots)


@pytest.mark.parametrize("data", ["heavy", "small"])
@pytest.mark.parametrize("K", [4, 16])
def test_slots_are_the_batch_rows_of_the_neighbors(K, data):
    """A real row's slots hold its draws (``node_gidx[slot] == id``) within
    its own graph, slot 0 itself; a padding row's slots are its own row."""
    ds = synthetic_powerlaw_dataset(
        "H", **(HEAVY if data == "heavy" else SMALL))
    table = torch.from_numpy(build_neighbor_table(ds, hub_seed=0))
    deg = torch.from_numpy(ds.degrees.astype(np.int32))
    x_global = torch.zeros(ds.num_nodes, 3)
    for seed in range(3):
        b = BatchBuilder(ds, 8 if data == "small" else 2, K,
                         seed=seed).sample()
        _, slots, ids = sample_neighborhoods_plain(
            seed, table, deg, x_global, b.node_gidx, b.node_mask, K,
            with_ids=True)
        N = b.n_pad
        real = b.node_mask > 0
        rows = torch.arange(N)[:, None].expand(N, K + 1)
        assert bool((~real).any())
        assert int(slots.min()) >= 0 and int(slots.max()) < N
        assert torch.equal(b.node_gidx.long()[slots[real]], ids[real].long())
        assert torch.equal(b.graph_id[slots[real]],
                           b.graph_id[real][:, None].expand(-1, K + 1))
        assert torch.equal(slots[real][:, 0], torch.arange(N)[real])
        assert torch.equal(slots[~real], rows[~real])
