"""The parallel layer's four regimes, each checked against one device — port
of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:31-265``).

    python -m graph_transformer_tpu_torch.parallel.dryrun --ranks 4 \\
        --backend gloo --device cpu          # or --device cuda

runs the regimes once in a group of one rank in this process (the
reference), then in ``--ranks`` spawned ranks (``parallel/launch.py``), and
prints each regime's parity delta:

1. **Sharded graph-granular step** (``spmd.py``): U2GNNSup's batch split
   over ``data`` by node ranges, the feed-forward leaves over ``model`` (a
   (2, 2) mesh at 4 ranks, JAX's rule), on the batch's own neighborhoods, in
   float32 at rate 0: the loss against one rank's, every gradient leaf
   after the reductions and the gather by the leaf rule (cosine > 0.999,
   relative L2 1e-4); then a step in the configuration's dtype at rate 0.5,
   its loss finite.
2. **Node-partitioned halo step** (``edge_partition.make_halo_train_step``,
   ``deterministic=True``): the loss and the gradients against one rank's.
3. **Overlapped halo step** on the edge-balanced, padded partition of
   ``partition_nodes_by_edges``: against the masked blocking step on the
   same ranks — each row's encoder output (bit for bit on the card), the
   loss within 1e-6 relative — and each schedule's ms a step at rate 0.5.
4. **Sharded folds** (``TenfoldVmapRunner(shard_folds=n)``, n the largest
   divisor of the fold count within the ranks): each fold's epoch losses
   and accuracies equal bit for bit to the unsharded runner's.

Every regime counts its kernels' launches a step per rank.  On the card the
ranks share it (``cuda:{rank % device_count}``); the ms are then those of
one card shared by the ranks, not of a multi-card machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder, GraphBatch
from graph_transformer_tpu_torch.data.tu import (
    GraphDataset,
    synthetic_powerlaw_dataset,
)
from graph_transformer_tpu_torch.models.u2gnn_sup import (
    COMPUTE_DTYPES,
    U2GNNSup,
)
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.parallel import bootstrap
from graph_transformer_tpu_torch.parallel.edge_partition import (
    HaloUnsupParams,
    apply_node_partition,
    build_halo_plan,
    build_overlap_plan,
    halo_cost_model,
    halo_gather,
    interior_fraction,
    make_halo_train_step,
    partition_nodes_by_edges,
)
from graph_transformer_tpu_torch.parallel.launch import free_port, launch
from graph_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    local_mesh,
    make_mesh,
)
from graph_transformer_tpu_torch.parallel.spmd import (
    make_spmd_train_step,
    shard_batch,
    sup_spmd_loss,
)
from graph_transformer_tpu_torch.train.optim import ClippedAdam
from graph_transformer_tpu_torch.train.tenfold_vmap import TenfoldVmapRunner
from graph_transformer_tpu_torch.utils.profiling import (
    read_launches,
    reset_launches,
)

LOSS_RTOL = 1e-5  # a sharded loss against one rank's (float32)
OVERLAP_RTOL = 1e-6  # overlapped against blocking: the loss, each row
OVERLAP_GRAD_REL_L2 = 1e-5  # overlapped against blocking: each gradient
LEAF_COSINE, LEAF_REL_L2 = 0.999, 1e-4  # the port's float32 leaf rules
HALO_LR = 1e-3  # JAX's dry run: optax.adam(1e-3), no clipping


@dataclasses.dataclass
class Regime1:
    """U2GNNSup's configuration (``compute_dtype`` float32 for the parity
    step; ``train_dtype`` for the step at rate 0.5), initial ``state``, one
    host ``batch`` (CPU tensors, its padded node and edge axes divisible by
    every data axis it runs on) and the step's ``seed``."""

    cfg: ExperimentConfig
    feature_dim: int
    num_classes: int
    state: Dict[str, torch.Tensor]
    batch: GraphBatch
    seed: int
    train_dtype: str = "float32"


@dataclasses.dataclass
class Halo:
    """A graph's features ``x`` [N, D] and neighborhoods ``neigh`` [N, K+1]
    (self slot 0), the halo model's size; ``deg`` [N] and
    ``pad_multiple`` give regime 3's partition; ``param_seed`` the initial
    weights where ``state`` is None (regime 3: the table's size depends on
    the partition).  ``sample_ids`` / ``probs``: given candidates and P(k)
    table for the deterministic step (tests hand JAX's);
    ``return_gathered``: return the rank's first exchange."""

    x: np.ndarray
    neigh: np.ndarray
    layers: int
    ff_hidden: int
    num_timesteps: int
    nsampled: int
    seed: int
    state: Optional[Dict[str, torch.Tensor]] = None
    deg: Optional[np.ndarray] = None
    pad_multiple: int = 2
    param_seed: int = 0
    sample_ids: Optional[torch.Tensor] = None
    probs: Optional[torch.Tensor] = None
    return_gathered: bool = False


@dataclasses.dataclass
class Regime4:
    ds: GraphDataset
    cfg: ExperimentConfig
    folds: list
    epochs: int = 1


@dataclasses.dataclass
class Inputs:
    r1: Regime1
    r2: Halo
    r3: Halo
    r4: Regime4
    timed_steps: int = 0  # regime 3's timed steps a schedule (0: none)


# ------------------------------------------------------------------ helpers
def model_parallel_for(world: int) -> int:
    """JAX's rule: a (world/2, 2) mesh at 4 or more even ranks."""
    return 2 if world % 2 == 0 and world >= 4 else 1


def fold_ranks(num_folds: int, world: int) -> int:
    """The largest divisor of the fold count within ``world``."""
    return max(d for d in range(1, world + 1) if num_folds % d == 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launched() -> Dict[str, int]:
    return {k: v for k, v in read_launches().items() if v}


def _cpu(grads: Dict[str, torch.Tensor],
         mesh: Mesh) -> Optional[Dict[str, torch.Tensor]]:
    """The summed gradients (equal on every rank) on the host, from the
    mesh's first rank only."""
    if mesh.ranks.index(mesh.rank):
        return None
    return {n: g.detach().float().cpu() for n, g in grads.items()}


def leaf_check(label: str, got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor], cosine: float = LEAF_COSINE,
               rel_l2: float = LEAF_REL_L2) -> float:
    """Every leaf of ``got`` against ``want``: cosine > ``cosine`` and
    relative L2 <= ``rel_l2``; returns the worst relative L2, raises on a
    miss."""
    worst = 0.0
    for name, w in want.items():
        g = got[name].double().flatten()
        w = w.double().flatten()
        nw = float(w.norm())
        rel = float((g - w).norm()) / max(nw, 1e-30)
        cos = float(g @ w) / max(float(g.norm()) * nw, 1e-30)
        if nw > 0.0 and (cos <= cosine or rel > rel_l2):
            raise AssertionError(f"{label}: leaf {name} cosine {cos:.6f}, "
                                 f"relative L2 {rel:.3e}")
        worst = max(worst, rel)
    return worst


# ---------------------------------------------------------------- regime 1
def regime1(mesh: Mesh, r1: Regime1) -> dict:
    cfg, dev = r1.cfg, mesh.device
    model = U2GNNSup(r1.feature_dim, r1.num_classes, cfg.model)
    local = shard_batch(r1.batch, mesh)
    out = {"mesh": (mesh.axis_size("data"), mesh.axis_size("model")),
           "rows": int(local.n_pad)}

    def step_for(dtype):
        m = U2GNNSup(r1.feature_dim, r1.num_classes, dataclasses.replace(
            cfg.model, compute_dtype=dtype)) if dtype != \
            cfg.model.compute_dtype else model
        return make_spmd_train_step(
            sup_spmd_loss(m, mesh), mesh, cfg.model.ff_hidden_size,
            r1.state, cfg.train.learning_rate, cfg.train.grad_clip_norm)

    step = step_for(cfg.model.compute_dtype)
    reset_launches()
    loss = step(local, None)
    _sync(dev)
    out.update(loss=float(loss), grads=_cpu(step.last_grads, mesh),
               launches=_launched())
    step = step_for(r1.train_dtype)
    reset_launches()
    t0 = time.perf_counter()
    loss = step(local, r1.seed)
    _sync(dev)
    out.update(loss_train=float(loss), launches_train=_launched(),
               ms_train=(time.perf_counter() - t0) * 1e3)
    return out


def regime1_reference(r1: Regime1, device) -> dict:
    """The loss (with the ACT ponder cost, as the trainer adds it) and
    gradients of U2GNNSup's own deterministic two-pass pass on the whole
    batch on one device (no group)."""
    cfg = r1.cfg
    model = U2GNNSup(r1.feature_dim, r1.num_classes, cfg.model).to(device)
    model.load_state_dict(r1.state)
    b = r1.batch.to(device)
    x = b.x.to(COMPUTE_DTYPES[cfg.model.compute_dtype])[b.neigh.long()]
    scores, ponder = model(b, neigh_feat=x, return_ponder=True)
    act_weight = (cfg.model.act_loss_weight
                  if cfg.model.recurrence == "act" else 0.0)
    loss = soft_cross_entropy(scores, label_smoothing(
        b.labels, r1.num_classes, cfg.model.label_smoothing)) \
        + act_weight * ponder
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return {"loss": float(loss.detach()), "grads": {
        n: g.detach().float().cpu() for n, g in zip(names, grads)}}


# ------------------------------------------------------------ regimes 2, 3
def halo_params(h: Halo, total_nodes: int, device) -> HaloUnsupParams:
    params = HaloUnsupParams(h.layers, h.x.shape[1], h.ff_hidden, total_nodes,
                             h.num_timesteps, h.param_seed)
    if h.state is not None:
        params.load_state_dict(h.state)
    return params.to(device)


def halo_step(mesh: Mesh, h: Halo, params: HaloUnsupParams, total_nodes: int,
              **kw):
    opt = ClippedAdam(params.parameters(), HALO_LR, math.inf)
    return make_halo_train_step(opt, mesh, total_nodes, h.nsampled,
                                h.num_timesteps, **kw)


def regime2(mesh: Mesh, h: Halo) -> dict:
    n, dev = h.x.shape[0], mesh.device
    W = mesh.axis_size("data")
    plan = build_halo_plan(h.neigh, W)
    params = halo_params(h, n, dev)
    step = halo_step(mesh, h, params, n, deterministic=True)
    reset_launches()
    loss = step(params, h.x, plan, h.seed, sample_ids=h.sample_ids,
                probs=h.probs)
    _sync(dev)
    out = {"loss": float(loss), "grads": _cpu(step.last_grads, mesh),
           "launches": _launched(), "halo_rows": plan.halo_size,
           "interior": interior_fraction(plan),
           "cost": halo_cost_model(plan, n // W, h.x.shape[1], h.layers,
                                   h.ff_hidden, h.num_timesteps)}
    if h.return_gathered:  # this rank's first exchange, of the features
        s, nl = mesh.axis_index("data"), n // W
        x_local = torch.from_numpy(h.x[s * nl:(s + 1) * nl]).to(dev)
        out["gathered"] = halo_gather(x_local, *plan.shard(s, dev),
                                      mesh).cpu()
    # JAX's stochastic step (dropout folded with the rank): finite
    params = halo_params(h, n, dev)
    out["loss_stochastic"] = float(halo_step(mesh, h, params, n)(
        params, h.x, plan, h.seed))
    return out


def regime3(mesh: Mesh, h: Halo, timed_steps: int = 0) -> dict:
    dev, W = mesh.device, mesh.axis_size("data")
    part = partition_nodes_by_edges(h.deg, W, pad_multiple=h.pad_multiple)
    neigh_p, x_p = apply_node_partition(part, h.neigh, h.x)
    plan = build_halo_plan(neigh_p, W)
    oplan = build_overlap_plan(plan)
    n_new = part.num_new_nodes
    valid = part.valid.astype(np.float32)
    out = {"n_local": part.n_local, "halo_rows": plan.halo_size,
           "interior": interior_fraction(plan), "sizes": oplan.sizes,
           "valid_fraction": float(valid.mean())}
    runs = {}
    for name, kw in (("overlap", dict(overlap=True)),
                     ("blocking", dict(masked=True))):
        params = halo_params(h, n_new, dev)
        step = halo_step(mesh, h, params, n_new, deterministic=True, **kw)
        reset_launches()
        loss = step(params, x_p, plan, h.seed, oplan, valid)
        _sync(dev)
        runs[name] = (float(loss), step.last_h, step.last_grads,
                      _launched())
    (lo, ho, go, launch_o), (lb, hb, gb, launch_b) = (runs["overlap"],
                                                      runs["blocking"])
    same = (ho == hb).all(dim=-1)
    out.update(loss_overlap=lo, loss_blocking=lb,
               rows=int(same.numel()), rows_equal=int(same.sum()),
               max_row_diff=float((ho - hb).abs().max()),
               grad_rel_l2=max(float((go[k] - gb[k]).norm())
                               / max(float(gb[k].norm()), 1e-30) for k in gb),
               launches_overlap=launch_o, launches_blocking=launch_b)
    # each schedule's time a step at rate 0.5 (its loss finite)
    for name, kw in (("overlap", dict(overlap=True)),
                     ("blocking", dict(masked=True))):
        params = halo_params(h, n_new, dev)
        step = halo_step(mesh, h, params, n_new, **kw)
        loss = step(params, x_p, plan, h.seed + 1, oplan, valid)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(timed_steps):
            loss = step(params, x_p, plan, h.seed + 2 + i, oplan, valid)
        _sync(dev)
        out[f"loss_stochastic_{name}"] = float(loss)
        if timed_steps:
            out[f"ms_{name}"] = (time.perf_counter() - t0) * 1e3 / timed_steps
    if timed_steps:  # a step's gradient all-reduces alone, leaf by leaf
        grads = [torch.zeros_like(p) for p in params.parameters()]
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            for g in grads:
                all_reduce(g, mesh, "data")
        _sync(dev)
        out["ms_grad_all_reduce"] = ((time.perf_counter() - t0) * 1e3
                                     / timed_steps)
        out["grad_bytes"] = sum(4 * g.numel() for g in grads)
    return out


# ---------------------------------------------------------------- regime 4
def regime4(mesh: Mesh, r4: Regime4, device) -> Optional[dict]:
    """The runner on the folds, sharded over ``mesh``'s ranks (unsharded
    on one); None on a rank outside the mesh."""
    if not mesh.member:
        return None
    n = mesh.axis_size("data")
    reset_launches()
    t0 = time.perf_counter()
    runner = TenfoldVmapRunner(r4.ds, r4.cfg, folds=r4.folds, shard_folds=n,
                               device=device, mesh=mesh if n > 1 else None)
    losses, accs = [], []
    for _ in range(r4.epochs):
        losses.append(runner.train_epoch())
        accs.append(runner.evaluate())
    _sync(torch.device(device))
    return {"ranks": n, "folds_per_rank": len(runner.own),
            "own": runner.own, "lr_scales": runner.lr_scales.copy(),
            "steps_per_epoch": runner.steps_per_epoch,
            "losses": np.stack(losses), "accs": np.stack(accs),
            "steps": r4.epochs * runner.steps_per_epoch * len(runner.own),
            "launches": _launched(), "s": time.perf_counter() - t0}


# ------------------------------------------------------------------ drivers
def run_regimes(device, inputs: Inputs) -> dict:
    """Every regime on the initialised group's ranks (this rank's results).
    The meshes are made first, in one order on every rank."""
    device = torch.device(device)
    if device.type == "cpu":  # CPU ranks share the host's cores
        torch.set_num_threads(1)
    start = time.time()
    world = dist.get_world_size()
    mesh1 = make_mesh(model_parallel_for(world), device=device)
    mesh_h = make_mesh(1, device=device)
    mesh_cv = make_mesh(1, ranks=range(fold_ranks(len(inputs.r4.folds),
                                                  world)), device=device)
    out = {"rank": dist.get_rank(), "world": world,
           "backend": dist.get_backend(), "device": str(device),
           "start": start, "meshes_s": time.time() - start}
    for name, fn in (("r1", lambda: regime1(mesh1, inputs.r1)),
                     ("r2", lambda: regime2(mesh_h, inputs.r2)),
                     ("r3", lambda: regime3(mesh_h, inputs.r3,
                                            inputs.timed_steps)),
                     ("r4", lambda: regime4(mesh_cv, inputs.r4, device))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
    return out


def run_world1(backend: str, device, inputs: Inputs,
               timeout_s: int = 120) -> dict:
    """:func:`run_regimes` in a group of this process alone (the backend's
    own code path at world size 1), then the group torn down."""
    device = bootstrap.check_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        return run_regimes(device, inputs)
    finally:
        bootstrap.destroy()


def check(ref: dict, results: List[dict], log=None,
          expect: Optional[Dict[str, dict]] = None) -> dict:
    """Every rank's results against the world-1 run ``ref``; prints each
    regime's delta, raises AssertionError on a gate it misses.  ``expect``
    (regime → kernel → launches a step) checks the launch counts."""
    log = log or (lambda m: print(m, flush=True))
    world = len(results)
    d = {}
    r0 = results[0]
    for res in results:
        r1, want = res["r1"], ref["r1"]
        delta = abs(r1["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-30)
        if delta > LOSS_RTOL:
            raise AssertionError(f"regime1 rank {res['rank']}: loss "
                                 f"{r1['loss']} against {want['loss']}")
        d["r1_loss"] = max(d.get("r1_loss", 0.0), delta)
        if not math.isfinite(r1["loss_train"]):
            raise AssertionError(f"regime1 rate-0.5 loss {r1['loss_train']}")
    d["r1_grad_rel_l2"] = leaf_check("regime1", r0["r1"]["grads"],
                                     ref["r1"]["grads"])
    log(f"regime1 ok (sharded graph-granular on a {r0['r1']['mesh']} mesh, "
        f"loss={r0['r1']['loss']:.6f}, 1-rank parity delta="
        f"{d['r1_loss']:.2e}, worst leaf relative L2 "
        f"{d['r1_grad_rel_l2']:.2e}; rate 0.5 loss "
        f"{r0['r1']['loss_train']:.4f})")

    for res in results:
        r2, want = res["r2"], ref["r2"]
        delta = abs(r2["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-30)
        if delta > LOSS_RTOL or not math.isfinite(r2["loss_stochastic"]):
            raise AssertionError(f"regime2 rank {res['rank']}: loss "
                                 f"{r2['loss']} against {want['loss']}, "
                                 f"stochastic {r2['loss_stochastic']}")
        d["r2_loss"] = max(d.get("r2_loss", 0.0), delta)
    d["r2_grad_rel_l2"] = leaf_check("regime2", r0["r2"]["grads"],
                                     ref["r2"]["grads"])
    log(f"regime2 ok (node-partitioned halo over {world} ranks, "
        f"{r0['r2']['halo_rows']} export rows a rank, "
        f"loss={r0['r2']['loss']:.4f}, 1-rank parity delta={d['r2_loss']:.2e}"
        f", worst leaf relative L2 {d['r2_grad_rel_l2']:.2e})")

    for res in results:
        # On the card every row equals the blocking step's bit for bit (the
        # kernels compute a row alone); the CPU's plain products block their
        # sums by the launch's row count, so there a row is held within
        # OVERLAP_RTOL instead.
        r3, rank = res["r3"], res["rank"]
        delta = abs(r3["loss_overlap"] - r3["loss_blocking"]) / max(
            abs(r3["loss_blocking"]), 1e-30)
        if delta > OVERLAP_RTOL or not all(math.isfinite(
                r3[f"loss_stochastic_{k}"]) for k in ("overlap", "blocking")):
            raise AssertionError(f"regime3 rank {rank}: overlapped "
                                 f"{r3['loss_overlap']} against blocking "
                                 f"{r3['loss_blocking']}")
        differing = r3["rows"] - r3["rows_equal"]
        if (differing and res["device"].startswith("cuda")) or \
                r3["max_row_diff"] > OVERLAP_RTOL:
            raise AssertionError(f"regime3 rank {rank}: {differing} of "
                                 f"{r3['rows']} rows differ from the blocking "
                                 f"step's (max {r3['max_row_diff']:.3e})")
        if r3["grad_rel_l2"] > OVERLAP_GRAD_REL_L2:
            raise AssertionError(f"regime3 rank {rank}: gradients' relative "
                                 f"L2 {r3['grad_rel_l2']:.3e} from the "
                                 "blocking step's")
        d["r3_loss"] = max(d.get("r3_loss", 0.0), delta)
        d["r3_rows_differing"] = d.get("r3_rows_differing", 0) + differing
        d["r3_max_row_diff"] = max(d.get("r3_max_row_diff", 0.0),
                                   r3["max_row_diff"])
        d["r3_grad_rel_l2"] = max(d.get("r3_grad_rel_l2", 0.0),
                                  r3["grad_rel_l2"])
    log(f"regime3 ok (overlapped halo, edge-balanced partition of "
        f"{r0['r3']['n_local']} rows a rank, interior fraction "
        f"{r0['r3']['interior']:.3f}, loss={r0['r3']['loss_overlap']:.4f}, "
        f"overlap-vs-blocking delta={d['r3_loss']:.2e}, rows differing "
        f"{d['r3_rows_differing']} (max {d['r3_max_row_diff']:.2e}), worst "
        f"gradient relative L2 {d['r3_grad_rel_l2']:.2e})")

    want = ref["r4"]
    runs = [res["r4"] for res in results if res["r4"] is not None]
    for r4 in runs:
        if not (np.array_equal(r4["losses"], want["losses"])
                and np.array_equal(r4["accs"], want["accs"])):
            raise AssertionError(f"regime4: sharded losses {r4['losses']}, "
                                 f"accuracies {r4['accs']} against "
                                 f"{want['losses']}, {want['accs']}")
    log(f"regime4 ok (folds over {runs[0]['ranks']} ranks, "
        f"{runs[0]['folds_per_rank']} a rank, equal bit for bit to the "
        f"unsharded runner; mean acc={float(np.mean(runs[0]['accs'][-1])):.4f})")
    if expect:
        d["launches"] = check_launches(results, expect)
    return d


def per_step_launches(res: dict) -> Dict[str, dict]:
    """Each regime's launches a step (regime 4's over its steps and eval
    batches as counted), by regime key."""
    out = {"r1": res["r1"]["launches"], "r1_train": res["r1"]["launches_train"],
           "r2": res["r2"]["launches"],
           "r3_overlap": res["r3"]["launches_overlap"],
           "r3_blocking": res["r3"]["launches_blocking"]}
    if res["r4"] is not None:
        out["r4"] = res["r4"]["launches"]
    return out


def check_launches(results: List[dict], expect: Dict[str, dict]) -> dict:
    """Every rank's launches by regime equal to ``expect`` (regime key →
    kernel → count; regime 4's are functions of the rank's result)."""
    got = {}
    for res in results:
        for key, counts in per_step_launches(res).items():
            want = expect[key](res) if callable(expect[key]) else expect[key]
            if counts != want:
                raise AssertionError(f"rank {res['rank']} {key}: launches "
                                     f"{counts}, expected {want}")
            got[f"{key}@{res['rank']}"] = counts
    return got


def dryrun_multichip(world: int, backend: str = "gloo", device="cuda",
                     inputs: Optional[Inputs] = None, timeout_s: int = 300,
                     log=None) -> dict:
    """The four regimes at ``world`` ranks, each checked against a group of
    one rank: at world 1 in this process alone (regime 1 then against the
    model's own pass on one device, regime 2 against the step without a
    group); past 1 also in ``world`` spawned ranks.  Returns the results
    and the deltas."""
    inputs = inputs or tiny_inputs()
    one = run_world1(backend, device, inputs, timeout_s)
    if world == 1:
        ref = dict(one)
        ref["r1"] = regime1_reference(inputs.r1, torch.device(device))
        ref["r2"] = regime2(local_mesh(device), inputs.r2)
        results = [one]
    else:
        ref = one
        results = launch(run_regimes, world, inputs, backend=backend,
                         device=device, timeout_s=timeout_s)
    return {"results": results, "ref": ref,
            "deltas": check(ref, results, log)}


# ------------------------------------------------------------------- inputs
def tiny_inputs() -> Inputs:
    """JAX's dry-run shapes: 16 graphs of ~24 nodes, batch 8, K = 4, T = 2,
    two U2GNN layers, ff 64; a 32-node halo graph of D = 8, K = 3, two
    layers, ff 16, 8 candidates; 40 graphs of ~12 nodes over 10 folds at
    batch 4, ff 16, 1 epoch.  Sizes split over 1, 2 and 4 ranks."""
    ds = synthetic_powerlaw_dataset(num_graphs=16, mean_nodes=24, seed=0)
    B, K, FF = 8, 4, 64
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=B, num_neighbors=K, pad_multiple=32),
        model=ModelConfig(num_timesteps=2, num_hidden_layers=2,
                          ff_hidden_size=FF),
        train=TrainConfig(learning_rate=5e-4))
    batch = BatchBuilder(ds, B, K, pad_multiple=32, seed=0,
                         backend="numpy").build(list(range(B)))
    model = U2GNNSup(ds.feature_dim, ds.num_classes, cfg.model, seed=0)
    r1 = Regime1(cfg, ds.feature_dim, ds.num_classes,
                 {k: v.clone() for k, v in model.state_dict().items()},
                 batch, seed=1)
    rng = np.random.default_rng(0)
    n, K2, D2 = 32, 3, 8
    neigh = rng.integers(0, n, size=(n, K2 + 1)).astype(np.int32)
    neigh[:, 0] = np.arange(n)
    x = rng.standard_normal((n, D2)).astype(np.float32)
    r2 = Halo(x, neigh, layers=2, ff_hidden=16, num_timesteps=1, nsampled=8,
              seed=3, param_seed=2)
    n_old = n - 3  # not divisible by the ranks: padding is exercised
    deg = rng.zipf(1.8, n_old).clip(max=40)
    neigh_o = rng.integers(0, n_old, size=(n_old, K2 + 1)).astype(np.int32)
    neigh_o[:, 0] = np.arange(n_old)
    r3 = Halo(rng.standard_normal((n_old, D2)).astype(np.float32), neigh_o,
              layers=2, ff_hidden=16, num_timesteps=1, nsampled=8, seed=5,
              deg=deg, param_seed=4)
    cv_ds = synthetic_powerlaw_dataset(num_graphs=40, mean_nodes=12, seed=1)
    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)

    cv_cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=3, pad_multiple=8),
        model=ModelConfig(num_timesteps=1, num_hidden_layers=1,
                          ff_hidden_size=16),
        train=TrainConfig(num_epochs=1))
    r4 = Regime4(cv_ds, cv_cfg,
                 stratified_kfold_indices(cv_ds.labels, 10, seed=0))
    return Inputs(r1, r2, r3, r4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--backend", choices=bootstrap.BACKENDS, default="gloo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=int, default=300)
    a = p.parse_args(argv)
    if os.environ.get(bootstrap.ENV_COORDINATOR):  # one rank of a launch
        dev = bootstrap.device_for(int(os.environ[bootstrap.ENV_PROCESS_ID]),
                                   a.device)
        bootstrap.initialize_from_env(a.backend, dev, a.timeout)
        try:
            res = run_regimes(dev, tiny_inputs())
        finally:
            bootstrap.destroy()
        print(f"rank {res['rank']} of {res['world']}: regime losses "
              f"{res['r1']['loss']:.6f}, {res['r2']['loss']:.4f}, "
              f"{res['r3']['loss_overlap']:.4f}", flush=True)
        return 0
    dryrun_multichip(a.ranks, a.backend, a.device, timeout_s=a.timeout)
    print("dryrun_multichip ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
