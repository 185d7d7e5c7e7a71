"""The parallel layer's host side (``graph_transformer_tpu_torch/parallel/``)
against the JAX package's, array for array on the same numpy inputs: the
LPT graph partition and its balance, the sharded batch builder, the
edge-balanced node ranges (with the non-divisible and min-crossing cases of
``tests/test_edge_partition.py:246-525``), the remap, the halo and overlap
plans, the interior fraction and the cost model at explicit, equal hardware
figures; the cost model's defaults are the H100's; the bootstrap, the mesh's
shape rule and each rank's block of a host array (no process is spawned);
``params_from_jax`` of ``HaloUnsupParams``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu.parallel import edge_partition as jep
from graph_transformer_tpu.parallel import mesh as jmesh
from graph_transformer_tpu.parallel import spmd as jspmd
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.parallel import bootstrap
from graph_transformer_tpu_torch.parallel import edge_partition as ep
from graph_transformer_tpu_torch.parallel.mesh import Mesh, mesh_shape_for
from graph_transformer_tpu_torch.parallel.spmd import (
    batch_pspec,
    param_pspec,
    shard_batch,
    shard_params,
)
from graph_transformer_tpu_torch.weights import params_from_jax
from test_torch_batcher import jax_assembler

FIELDS = ("x", "neigh", "graph_id", "node_gidx", "node_mask", "edge_src",
          "edge_dst", "edge_mask", "labels")


def datasets(**kw):
    return jax_synthetic(**kw), synthetic_powerlaw_dataset(**kw)


def equal_dataclasses(a, b):
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_graph_partition_and_balance(n_shards):
    dj, dt = datasets(num_graphs=32, mean_nodes=60, seed=0)
    ids = np.random.default_rng(n_shards).permutation(32)[:20]
    sj = jep.partition_graphs_by_edges(dj, ids, n_shards)
    st = ep.partition_graphs_by_edges(dt, ids, n_shards)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    assert ep.edge_balance(dt, st) == jep.edge_balance(dj, sj)


def test_sharded_batch_builder():
    """``build`` and ``sample`` (both on the C++ assembler, the default of
    both packages) array for array, twice in a row."""
    jax_assembler()
    dj, dt = datasets(num_graphs=32, mean_nodes=60, seed=0)
    kw = dict(n_shards=4, batch_size=4, num_neighbors=4, pad_multiple=64,
              seed=3)
    bj, bt = jep.ShardedBatchBuilder(dj, **kw), ep.ShardedBatchBuilder(dt,
                                                                        **kw)
    assert bt.n_pad_local == bj.n_pad_local
    per = [np.arange(i * 8, i * 8 + 4) for i in range(4)]
    for got, want in ((bt.build(per), bj.build(per)),
                      (bt.sample(), bj.sample()), (bt.sample(), bj.sample())):
        assert got.x.shape[0] == 4
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)


NODE_CASES = {
    # (degrees, shards, pad_multiple, neigh, crossing_window)
    "power-law": lambda r: (np.sort(r.zipf(1.7, 4096).clip(max=2000))[::-1],
                            8, 8, None, 0.1),
    "not divisible": lambda r: (r.zipf(1.8, 29).clip(max=50), 4, 2, None, 0.1),
    "degenerate": lambda r: (np.zeros(10, np.int64), 3, 4, None, 0.1),
    "min-crossing": lambda r: (
        np.ones(40, np.int64), 2, 2,
        np.concatenate([np.arange(40)[:, None], (np.arange(40) // 10 * 10)[
            :, None] + r.integers(0, 10, (40, 3))], 1).astype(np.int32), 0.3),
    "min-crossing zipf": lambda r: (
        r.zipf(1.8, 200).clip(max=30), 4, 8,
        np.concatenate([np.arange(200)[:, None], r.integers(0, 200, (200, 4))],
                       1).astype(np.int32), 0.1),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_node_partition_remap_and_plans(case):
    deg, S, pad, neigh, window = NODE_CASES[case](np.random.default_rng(7))
    pj = jep.partition_nodes_by_edges(deg, S, pad, neigh, window)
    pt = ep.partition_nodes_by_edges(deg, S, pad, neigh, window)
    equal_dataclasses(pt, pj)
    n = len(deg)
    rng = np.random.default_rng(1)
    if neigh is None:
        neigh = rng.integers(0, n, (n, 4)).astype(np.int32)
        neigh[:, 0] = np.arange(n)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    (nj, xj), (nt, xt) = (jep.apply_node_partition(pj, neigh, x),
                          ep.apply_node_partition(pt, neigh, x))
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(xt, xj)
    hj, ht = jep.build_halo_plan(nj, S), ep.build_halo_plan(nt, S)
    equal_dataclasses(ht, hj)
    assert ht.halo_size == hj.halo_size
    equal_dataclasses(ep.build_overlap_plan(ht), jep.build_overlap_plan(hj))
    assert ep.build_overlap_plan(ht).sizes == jep.build_overlap_plan(hj).sizes
    assert ep.interior_fraction(ht) == jep.interior_fraction(hj)


@pytest.mark.parametrize("n_shards,n,k1,local", [
    (4, 32, 4, 0.0), (2, 8, 2, 0.0), (8, 2048, 9, 0.8), (1, 12, 3, 0.0)])
def test_halo_plans_and_cost_model(n_shards, n, k1, local):
    """Random and mostly-local tables; the cost model at explicit, equal
    hardware figures, for 1 and 2 layers and a valid fraction."""
    rng = np.random.default_rng(n)
    neigh = rng.integers(0, n, (n, k1)).astype(np.int32)
    n_local = n // n_shards
    base = (np.arange(n) // n_local) * n_local
    near = rng.random((n, k1)) < local
    neigh = np.where(near, base[:, None] + rng.integers(0, n_local, (n, k1)),
                     neigh).astype(np.int32)
    neigh[:, 0] = np.arange(n)
    hj, ht = jep.build_halo_plan(neigh, n_shards), ep.build_halo_plan(
        neigh, n_shards)
    equal_dataclasses(ht, hj)
    equal_dataclasses(ep.build_overlap_plan(ht), jep.build_overlap_plan(hj))
    hw = dict(bytes_per_elt=4, flops_per_s=5e13)
    for layers, valid in ((1, 1.0), (2, 0.9)):
        want = jep.halo_cost_model(hj, n_local, 64, layers, 1024,
                                   ici_bytes_per_s=2e11, valid_fraction=valid,
                                   **hw)
        got = ep.halo_cost_model(ht, n_local, 64, layers, 1024,
                                 link_bytes_per_s=2e11, valid_fraction=valid,
                                 **hw)
        assert got == want


def test_halo_plan_refuses_uneven_split():
    neigh = np.tile(np.arange(10, dtype=np.int32)[:, None], (1, 3))
    with pytest.raises(ValueError, match="split evenly"):
        ep.build_halo_plan(neigh, 4)


def test_cost_model_defaults_are_the_h100s():
    """NVLink 4's 450 GB/s a direction and 989 TFLOP/s of dense bf16 (the
    H100 SXM5's published figures); no TPU figure."""
    neigh = np.random.default_rng(0).integers(0, 64, (64, 5)).astype(np.int32)
    neigh[:, 0] = np.arange(64)
    plan = ep.build_halo_plan(neigh, 4)
    m = ep.halo_cost_model(plan, 16, 32, 1, 256)
    want = ep.halo_cost_model(plan, 16, 32, 1, 256, link_bytes_per_s=4.5e11,
                              flops_per_s=9.89e14)
    assert m == want
    assert m["t_collective_s"] == m["collective_bytes_per_step"] / 4.5e11
    src = open(ep.__file__).read()
    assert "4.5e10" not in src and "1.97e14" not in src


def test_params_from_jax_learns_halo_params():
    jp = jep.init_halo_unsup_params(jax.random.key(0), 2, 8, 16, 40,
                                    num_timesteps=2)
    tree = {f"encoders.{i}.{f.name}": np.asarray(getattr(enc, f.name))
            for i, enc in enumerate(jp.encoders)
            for f in dataclasses.fields(enc)}
    tree["ss.weight"] = np.asarray(jp.ss.weight)
    tree["ss.bias"] = np.asarray(jp.ss.bias)
    tp = ep.init_halo_unsup_params(0, 2, 8, 16, 40, num_timesteps=2)
    tp.load_state_dict(params_from_jax(tree))
    sd = tp.state_dict()
    assert set(sd) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


def test_bootstrap_without_coordinator(monkeypatch):
    monkeypatch.delenv(bootstrap.ENV_COORDINATOR, raising=False)
    assert bootstrap.initialize_from_env("gloo", "cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        bootstrap.check_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        bootstrap.check_backend("mpi", "cpu")
    assert bootstrap.device_for(3, "cpu") == torch.device("cpu")


def test_mesh_shape_rule():
    for n, m in ((8, 2), (4, 1), (6, 3)):
        assert mesh_shape_for(n, m) == jmesh.mesh_shape_for(n, m)
    with pytest.raises(ValueError, match="divisible"):
        mesh_shape_for(6, 4)


def rank_mesh(pos, shape=(2, 2)):
    """Rank ``pos`` of a (data, model) mesh, without a process group."""
    d, m = shape
    return Mesh({"data": d, "model": m}, tuple(range(d * m)), pos,
                {"data": None, "model": None}, torch.device("cpu"))


def test_each_rank_takes_its_own_block():
    """``host_local_array`` / ``put_tree`` under the specs of
    ``batch_pspec`` and ``param_pspec``: the blocks of the ranks tile the
    host array (JAX's ``param_pspec`` names the same dimensions)."""
    a = np.arange(8 * 6).reshape(8, 6)
    blocks = {pos: bootstrap.host_local_array(a, rank_mesh(pos),
                                              ("data", "model"))
              for pos in range(4)}
    np.testing.assert_array_equal(blocks[0].numpy(), a[:4, :3])
    np.testing.assert_array_equal(blocks[3].numpy(), a[4:, 3:])
    with pytest.raises(ValueError, match="split"):
        bootstrap.host_local_array(np.zeros((3, 2)), rank_mesh(0), ("data",))
    _, dt = datasets(num_graphs=8, mean_nodes=20, seed=1)
    from graph_transformer_tpu_torch.data.batching import BatchBuilder

    batch = BatchBuilder(dt, 4, 3, pad_multiple=16, seed=0,
                         backend="numpy").build(range(4))
    locals_ = [shard_batch(batch, rank_mesh(pos)) for pos in (0, 2)]
    for f in FIELDS:
        want = getattr(batch, f)
        got = [getattr(b, f) for b in locals_]
        if f == "labels":
            assert all(torch.equal(g, want) for g in got)
        else:
            assert torch.equal(torch.cat(got), want), f
    assert set(dataclasses.asdict(batch_pspec())) == set(FIELDS)
    params = {"w_ff1": torch.randn(2, 4, 16), "b_ff1": torch.randn(2, 16),
              "w_ff2": torch.randn(2, 16, 4), "w_in": torch.randn(2, 4, 12)}
    spec = param_pspec(params, 16)
    jspec = jspmd.param_pspec(params, 16)
    assert {k: tuple(v) for k, v in jspec.items()} == spec
    halves = [shard_params(params, rank_mesh(pos), 16) for pos in (0, 1)]
    assert torch.equal(torch.cat([h["w_ff1"] for h in halves], 2),
                       params["w_ff1"])
    assert torch.equal(torch.cat([h["w_ff2"] for h in halves], 1),
                       params["w_ff2"])
    assert torch.equal(halves[1]["w_in"], params["w_in"])
