"""Sharded batches, parameters and the train step — port of
``graph_transformer_tpu/parallel/spmd.py`` on ``torch.distributed``.

JAX annotates shardings and lets GSPMD insert the collectives.  The port
places them by hand, on the same layout:

- **Batches** shard their node and edge axes over ``data``
  (:func:`batch_pspec`): each data rank holds a contiguous slice of the
  padded block-diagonal batch (its ``x``, ``neigh``, ``graph_id``,
  ``node_mask`` rows), the labels replicated.
- **Parameters**: every leaf dimension equal to ``ff_hidden`` shards over
  ``model`` (:func:`param_pspec`: ``w_ff1 [T, D, F]``, ``b_ff1 [T, F]``,
  ``w_ff2 [T, F, D]``), everything else is replicated.  A sharded leaf is
  stored at rest as this rank's ``model`` slice, and so are its Adam
  moments (:class:`SpmdTrainStep`).  The port's kernels fuse the FFN with
  the residual and the LayerNorm, so the step does what GSPMD does around a
  kernel it cannot split: ``all_gather`` the slices over ``model`` before
  the kernels run, and let each rank update its own slice from the summed
  gradient.
- **The step's loss equals one device's.**  :func:`sup_spmd_loss` runs
  U2GNNSup's own two-pass forward on a node-range shard
  (``torch.func.functional_call`` with a ``regather``): the first layer's
  neighborhoods gather the batch's rows (``all_gather`` of ``x`` over
  ``data``), each U2GNN layer encodes only the local rows, the next layer
  re-gathers from every rank's output (:func:`~.mesh.gather_rows`, whose
  backward sums the readers' cotangents), each rank sum-pools its rows into
  partial graph vectors and scores them with the head (the bias on data
  rank 0 only), and the partial scores are summed over ``data``
  (:func:`~.mesh.sum_across`) before the replicated loss.  Any encoder
  configuration of the model runs so, the per-layer ones included.  Each rank's
  backward then yields its share of every gradient, and one ``all_reduce``
  over ``data`` gives the full gradient on every rank.  The gradient is not
  summed over ``model``: a model group's ranks hold the same rows and
  compute the same shares.

Neighborhoods are the batch's own (``batch.neigh``, the trainer's
``host_sampling`` path): a device draw keyed by local rows would give a
shard other neighbors than one device draws.  Dropout masks are keyed by
element within a kernel launch, so a sharded step drops other elements
than one device; parity holds at rate 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.parallel.bootstrap import put_tree
from graph_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    gather_rows,
    sum_across,
)
from graph_transformer_tpu_torch.train.optim import ClippedAdam, global_norm


def P(*axes) -> tuple:
    """A partition spec: one mesh axis name, or None, per dimension."""
    return tuple(axes)


# --------------------------------------------------------------------- specs
def batch_pspec() -> GraphBatch:
    """Spec tree of a GraphBatch: node and edge axes over ``data``."""
    return GraphBatch(
        x=P("data", None), neigh=P("data", None), graph_id=P("data"),
        node_gidx=P("data"), node_mask=P("data"), edge_src=P("data"),
        edge_dst=P("data"), edge_mask=P("data"),
        labels=P())  # tiny; replicated


def param_pspec(params: Dict[str, torch.Tensor], ff_hidden: int) -> dict:
    """Every ``ff_hidden``-sized dimension over ``model``, the rest
    replicated, leaf by leaf (the sampled-softmax table ``[V, D]`` stays
    replicated)."""
    def spec_for(shape):
        dims = ["model" if d == ff_hidden else None for d in shape]
        return P(*dims) if any(dims) else P()

    return {name: spec_for(p.shape) for name, p in params.items()}


# ------------------------------------------------------------------ placement
def shard_batch(batch: GraphBatch, mesh: Mesh) -> GraphBatch:
    """This rank's block of a host batch (CPU tensors), on its device."""
    return put_tree(batch, mesh, batch_pspec())


def _model_dim(spec: tuple) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 ff_hidden: int) -> Dict[str, torch.Tensor]:
    """This rank's block of every leaf under :func:`param_pspec`, on its
    device (a copy, so the caller's tensors are not aliased)."""
    spec = param_pspec(params, ff_hidden)
    return {n: put_tree({n: p.detach().cpu()}, mesh, {n: spec[n]})[n]
            .clone() for n, p in params.items()}


# ------------------------------------------------------------------ the loss
def sup_spmd_loss(model: U2GNNSup, mesh: Mesh) -> Callable:
    """``loss_fn(params, local_batch, seed)``: U2GNNSup's label-smoothed
    cross entropy (plus the ACT ponder cost, as the trainer adds it) on a
    node-range shard, with the full parameters ``params`` keyed as
    ``model.state_dict()``.  The model's own two-pass forward runs through
    ``torch.func.functional_call`` on the shard, its re-gather between
    U2GNN layers reading every rank's rows (:func:`~.mesh.gather_rows`),
    the head's bias zeroed off data rank 0; the partial scores are summed
    over ``data`` (:func:`~.mesh.sum_across`).  ``seed`` None is the
    deterministic pass (rate 0, no head dropout); a seed drops out as the
    model's two-pass training does."""
    cfg = model.cfg
    first = mesh.axis_index("data") == 0
    n_data = mesh.axis_size("data")
    act_weight = cfg.act_loss_weight if cfg.recurrence == "act" else 0.0

    def loss_fn(params, local: GraphBatch, seed: Optional[int]):
        neigh = local.neigh.to(torch.int64)
        x_all = all_gather(local.x, mesh, "data").reshape(-1, local.x.shape[1])
        if not first:
            params = {**params, "head_b": torch.zeros_like(params["head_b"])}
        scores, ponder = torch.func.functional_call(model, params, (local,), {
            "neigh_feat": x_all[neigh], "seed": seed, "return_ponder": True,
            "regather": lambda o: gather_rows(o, mesh, "data")[neigh]})
        scores = sum_across(scores, mesh, "data")
        targets = label_smoothing(local.labels, model.num_classes,
                                  cfg.label_smoothing)
        loss = soft_cross_entropy(scores, targets)
        if act_weight:  # a mean over rows: the shards' means, averaged
            loss = loss + act_weight * sum_across(ponder, mesh,
                                                  "data") / n_data
        return loss

    return loss_fn


# ------------------------------------------------------------------ the step
class SpmdTrainStep:
    """The clipped-Adam step of ``loss_fn`` over a (data, model) mesh.

    ``params`` (full leaves, e.g. ``model.state_dict()``) are stored as
    :func:`shard_params` gives them, and Adam's moments alike.  A call:
    ``all_gather`` the ``model`` slices into full leaves, the loss and its
    gradients on this rank's shard, one ``all_reduce`` of the gradients over
    ``data`` (``last_grads``, full, equal on every rank), the global norm
    from them, and each rank's update of its own slices.  Returns the loss
    (replicated)."""

    def __init__(self, loss_fn: Callable, mesh: Mesh, ff_hidden: int,
                 params: Dict[str, torch.Tensor], learning_rate: float,
                 grad_clip_norm: float = 0.5):
        self.loss_fn, self.mesh = loss_fn, mesh
        self.spec = param_pspec(params, ff_hidden)
        self.params = shard_params(params, mesh, ff_hidden)
        self.opt = ClippedAdam(list(self.params.values()), learning_rate,
                               grad_clip_norm)
        self.last_grads: Optional[Dict[str, torch.Tensor]] = None

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The full leaves: sharded ones gathered over ``model``."""
        out = {}
        for name, p in self.params.items():
            dim = _model_dim(self.spec[name])
            out[name] = p if dim is None else torch.cat(
                list(all_gather(p, self.mesh, "model")), dim=dim)
        return out

    def _own(self, name: str, g: torch.Tensor) -> torch.Tensor:
        dim = _model_dim(self.spec[name])
        if dim is None:
            return g
        n = self.mesh.axis_size("model")
        return g.chunk(n, dim=dim)[self.mesh.axis_index("model")]

    def __call__(self, local_batch: GraphBatch,
                 seed: Optional[int]) -> torch.Tensor:
        full = {n: t.detach().requires_grad_(True)
                for n, t in self.full_params().items()}
        loss = self.loss_fn(full, local_batch, seed)
        # the head's bias enters on data rank 0 only: zeros elsewhere
        grads = torch.autograd.grad(loss, list(full.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = [all_reduce(g.contiguous(), self.mesh, "data") for g in grads]
        self.last_grads = dict(zip(full, grads))
        self.opt.step([self._own(n, g) for n, g in self.last_grads.items()],
                      g_norm=global_norm(grads))
        return loss.detach()


def make_spmd_train_step(loss_fn: Callable, mesh: Mesh, ff_hidden: int,
                         params: Dict[str, torch.Tensor],
                         learning_rate: float,
                         grad_clip_norm: float = 0.5) -> SpmdTrainStep:
    """The sharded train step (:class:`SpmdTrainStep`); ``params``: the
    full leaves to start from, keyed as ``loss_fn`` reads them."""
    return SpmdTrainStep(loss_fn, mesh, ff_hidden, params, learning_rate,
                         grad_clip_norm)
