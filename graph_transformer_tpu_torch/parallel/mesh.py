"""A (data, model) grid of ranks and its collectives — port of
``graph_transformer_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX lays a ``Mesh`` over devices and lets GSPMD or ``shard_map`` place the
collectives.  Here every device is one process (a rank), and a
:class:`Mesh` holds the process groups of its two axes:

- ``data``: graph / node-axis parallelism (each data rank owns a slice of
  the padded node and edge axes, or a node range of one graph) and the
  gradient all-reduce;
- ``model``: the feed-forward weights' ``ff_hidden`` axis (the only
  dimension worth splitting: 1,024 in the README's configurations).

Ranks are laid out row-major, ``rank = data_index · M + model_index`` over
the mesh's ranks, as JAX reshapes its device list, so a model group is M
consecutive ranks: the launcher (``parallel/launch.py``) numbers a host's
processes consecutively, so the model axis stays within a host.

The collectives (:func:`all_reduce`, :func:`all_gather`) use only what
gloo takes on CUDA tensors as well as NCCL: ``all_reduce`` and the list
form of ``all_gather`` (gloo took both on an H100's tensors, synchronous
and with ``async_op=True``, so nothing goes through the host).
The backend is whatever the caller initialised; nothing here picks or
switches one.  :func:`local_mesh` is a mesh of one rank with no process
group (its collectives return their input), for single-device references
inside a rank.  The autograd-aware forms (:func:`gather_rows`,
:func:`sum_across`) carry the gradients that ``shard_map`` would transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) mesh shape for ``n_devices`` total."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"model_parallel={model_parallel}")
    return (n_devices // model_parallel, model_parallel)


@dataclasses.dataclass
class Mesh:
    """The ranks ``ranks`` [data·model] of a (data, model) grid and this
    process's place in it (``rank`` is None where this process is not a
    member).  ``groups[axis]`` is this rank's process group along ``axis``
    (None on a :func:`local_mesh`), ``device`` the device its tensors live
    on."""

    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    rank: Optional[int]
    groups: Dict[str, Optional[object]]
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank is not None

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        pos = self.ranks.index(self.rank)
        m = self.shape["model"]
        return pos // m if axis == "data" else pos % m


def local_mesh(device) -> Mesh:
    """A mesh of this process alone, with no process group: every
    collective returns its input.  Single-device references run on it."""
    return Mesh({"data": 1, "model": 1}, (0,), 0,
                {"data": None, "model": None}, torch.device(device))


def make_mesh(model_parallel: int = 1, ranks: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A (data, model) mesh over ``ranks`` (default: the whole world) of
    the initialised default group.  Every rank of the world must call it
    with the same arguments, in the same order as its other calls that
    create groups (``torch.distributed.new_group`` is collective over the
    world); a rank outside ``ranks`` gets a mesh with ``rank`` None.
    ``device``: where this rank's tensors live (default: the current CUDA
    device, whatever the backend; pass ``cpu`` for CPU ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/bootstrap.initialize_from_env or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    d, m = mesh_shape_for(len(ranks), model_parallel)
    me = dist.get_rank()
    groups: Dict[str, Optional[object]] = {"data": None, "model": None}
    # every rank creates every group, in one order
    for j in range(m):
        members = [ranks[i * m + j] for i in range(d)]
        g = dist.new_group(members)
        if me in members:
            groups["data"] = g
    for i in range(d):
        members = [ranks[i * m + j] for j in range(m)]
        g = dist.new_group(members)
        if me in members:
            groups["model"] = g
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                               "for CPU ranks")
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh({"data": d, "model": m}, ranks,
                me if me in ranks else None, groups, torch.device(device))


# ------------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over ``axis`` of ``mesh``; returns ``t``."""
    group = mesh.groups[axis]
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class Gathered:
    """An issued ``all_gather``: :meth:`wait` returns the ``[n, ...]``
    stack in axis order."""

    def __init__(self, parts, work):
        self.parts, self.work = parts, work

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return torch.stack(self.parts)


def all_gather_start(t: torch.Tensor, mesh: Mesh, axis: str) -> Gathered:
    """Issue the ``all_gather`` of ``t`` over ``axis`` without waiting
    (``async_op=True``); work that does not read the result may run before
    :meth:`Gathered.wait`."""
    group = mesh.groups[axis]
    if group is None:
        return Gathered([t], None)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axis))]
    return Gathered(parts, dist.all_gather(parts, src, group=group,
                                           async_op=True))


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` along ``axis``, in axis
    order."""
    return all_gather_start(t, mesh, axis).wait()


# ----------------------------------------------------- autograd collectives
class _GatherStack(torch.autograd.Function):
    """Forward: the ``[n, ...]`` stack of every rank's rows.  Backward:
    each rank's cotangent of the stack summed over the axis (every rank
    read the stack), then this rank's slice — ``shard_map``'s transpose of
    ``all_gather``, with an all-reduce where NCCL would reduce-scatter
    (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, gathered):
        ctx.mesh, ctx.axis = mesh, axis
        return gathered if gathered is not None else all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format),
                       ctx.mesh, ctx.axis)
        return g[ctx.mesh.axis_index(ctx.axis)], None, None, None


def gather_stack(t: torch.Tensor, mesh: Mesh, axis: str,
                 issued: Optional[Gathered] = None) -> torch.Tensor:
    """Differentiable :func:`all_gather`; ``issued``: the
    :func:`all_gather_start` of ``t.detach()`` already in flight."""
    gathered = None if issued is None else issued.wait()
    return _GatherStack.apply(t, mesh, axis, gathered)


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable concatenation of every rank's rows ``t`` [n_l, ...]
    along ``axis``: ``[n·n_l, ...]``."""
    s = gather_stack(t, mesh, axis)
    return s.reshape(-1, *t.shape[1:])


class _SumAcross(torch.autograd.Function):
    """Forward: the sum of every rank's partial over ``axis``.  Backward:
    the identity — every rank then computes the same function of the sum,
    so each partial's cotangent is the sum's, and each rank's backward
    covers only the work it did."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_across(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable sum over ``axis`` of partials whose total every rank
    then uses alike (see :class:`_SumAcross`)."""
    return _SumAcross.apply(t, mesh, axis)
