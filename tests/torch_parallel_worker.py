"""Rank-side code of ``tests/test_torch_parallel.py``.  The spawned ranks
import this module and the port only (never JAX)."""

import time

import torch

from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops.losses import label_smoothing
from graph_transformer_tpu_torch.parallel.dryrun import (
    fold_ranks,
    model_parallel_for,
    regime1,
    regime4,
    run_regimes,
)
from graph_transformer_tpu_torch.parallel.edge_partition import (
    make_shard_map_train_step,
)
from graph_transformer_tpu_torch.parallel.mesh import make_mesh
from graph_transformer_tpu_torch.train.optim import ClippedAdam


def shard_map_rank(device, case: dict) -> dict:
    """JAX's ``test_shard_map_dp_step_matches_replicated_gradients`` step
    on this rank: the sum-convention loss of U2GNNSup's deterministic pass
    on its shard of the stacked batch."""
    mesh = make_mesh(1, device=device)
    model = U2GNNSup(case["D"], case["C"], case["cfg"])
    params = {k: v.clone().to(device).requires_grad_(True)
              for k, v in case["state"].items()}
    opt = ClippedAdam(list(params.values()), 1e-3, 0.5)

    def loss_fn(p, local, seed):
        scores = torch.func.functional_call(
            model, p, (local,), {"neigh_feat": local.x[local.neigh.long()]})
        t = label_smoothing(local.labels, case["C"], 0.1)
        return -(t * torch.log_softmax(scores, dim=-1)).sum()

    step = make_shard_map_train_step(loss_fn, opt, mesh)
    loss = step(params, case["stacked"], None)
    return {"loss": float(loss),
            "grads": {k: g.cpu() for k, g in step.last_grads.items()}}


def cv_on_device_rank(device, r4) -> dict:
    """``run_cv_on_device`` with its folds over the largest divisor of the
    fold count within the ranks (every rank makes the mesh)."""
    import torch.distributed as dist

    from graph_transformer_tpu_torch.train.cv_ondevice import (
        run_cv_on_device)

    n = fold_ranks(len(r4.folds), dist.get_world_size())
    mesh = make_mesh(1, ranks=range(n), device=device)
    if not mesh.member:
        return None
    best, _, _, losses, accs = run_cv_on_device(
        r4.ds, r4.cfg, folds=r4.folds, return_history=True,
        epochs_per_dispatch=1, device=device, mesh=mesh)
    return {"best": best, "losses": losses, "accs": accs}


def worker(device, inputs, shard_map_case, per_layer, plateau) -> dict:
    """The dry run's regimes, then JAX's shard_map step, the on-device CV
    over ranks, regime 1 on a per-layer encoder configuration
    (``per_layer``, a ``dryrun.Regime1``) and regime 4 past the plateau
    rule's window (``plateau``, a ``dryrun.Regime4``)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    out = run_regimes(device, inputs)
    out["shard_map"] = shard_map_rank(device, shard_map_case)
    out["cv_on_device"] = cv_on_device_rank(device, inputs.r4)
    out["per_layer"] = regime1(make_mesh(model_parallel_for(world),
                                         device=device), per_layer)
    out["plateau"] = regime4(make_mesh(1, ranks=range(fold_ranks(
        len(plateau.folds), world)), device=device), plateau, device)
    return out


def sleeper(device, seconds) -> None:
    time.sleep(seconds)
