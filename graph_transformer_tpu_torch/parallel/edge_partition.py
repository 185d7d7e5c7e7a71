"""Edge-partitioned data parallelism with explicit boundary exchange — port
of ``graph_transformer_tpu/parallel/edge_partition.py`` on
``torch.distributed``.

Two regimes, as in JAX:

1. **Graph-granular batches** (graph classification): whole graphs go to
   shards balanced by edge count (LPT greedy).  Neighbor lists never cross
   graphs, so there is no halo: each shard trains on its sub-batch and only
   the gradient ``all_reduce`` crosses ranks
   (:func:`make_shard_map_train_step`).
2. **Node-partitioned single graph** (transductive node embeddings): the
   nodes of one graph are cut into ranges over the ranks, and sampled
   neighborhoods reference remote nodes.  The :class:`HaloPlan` gives each
   rank a fixed-size export buffer (its rows that others read) and gather
   indices into the gathered export stack; at run time the exchange is one
   ``all_gather`` of ``[H, D]`` a U2GNN layer (:func:`halo_gather`), whose
   backward sums every reader's cotangent (``mesh.gather_stack``).  The
   overlapped schedule (:func:`halo_encode_overlapped`) issues that
   ``all_gather`` with ``async_op=True``, encodes the interior rows (whose
   neighborhoods are all local), waits, then encodes the boundary rows.

The plans are host numpy, copied from JAX and equal to its array for array;
the steps run the port's per-layer encoder (``ops/attention.
neighborhood_encoder``: K9/K10, K9w/K10w, or K18-K20 past D = 128) and the
sampled softmax (``ops/sampled_softmax.loss_given``) on each rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from graph_transformer_tpu_torch.data.batching import BatchBuilder, GraphBatch
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.models.u2gnn_sup import ENCODER_DROPOUT
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    SampledSoftmaxParams,
)
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    neighborhood_encoder,
)
from graph_transformer_tpu_torch.ops.random import fold_seed, layer_seed
from graph_transformer_tpu_torch.ops.sampled_softmax import (
    draw_candidates,
    loss_given,
)
from graph_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_start,
    all_reduce,
    gather_stack,
)
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec
from graph_transformer_tpu_torch.train.optim import ClippedAdam


# ----------------------------------------------------------------- partition
def partition_graphs_by_edges(ds: GraphDataset, graph_ids: Sequence[int],
                              n_shards: int) -> List[np.ndarray]:
    """LPT greedy: heaviest graph (by directed edge count) to the lightest
    shard — balances edges, the work, not nodes or graphs."""
    g = np.asarray(graph_ids)
    deg = ds.degrees.astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(deg)])
    ecnt = cum[ds.graph_offsets[g + 1]] - cum[ds.graph_offsets[g]]
    order = np.argsort(-ecnt)
    loads = np.zeros(n_shards, dtype=np.int64)
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for idx in order:
        s = int(np.argmin(loads))
        shards[s].append(int(g[idx]))
        loads[s] += int(ecnt[idx])
    return [np.asarray(s, dtype=np.int64) for s in shards]


def edge_balance(ds: GraphDataset, shards: List[np.ndarray]) -> float:
    """max/mean edge load across shards (1.0 = perfect balance)."""
    deg = ds.degrees.astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(deg)])
    loads = np.array([
        int((cum[ds.graph_offsets[s + 1]] - cum[ds.graph_offsets[s]]).sum())
        for s in shards])
    return float(loads.max() / max(loads.mean(), 1.0))


def stack_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """``[n, ...]``-stacked batch of equal-shape batches."""
    return GraphBatch(**{f.name: torch.stack([getattr(b, f.name)
                                              for b in batches])
                         for f in dataclasses.fields(GraphBatch)})


def unstack_batch(stacked: GraphBatch, i: int) -> GraphBatch:
    """Shard ``i`` of a :func:`stack_batches` batch."""
    return GraphBatch(**{f.name: getattr(stacked, f.name)[i]
                         for f in dataclasses.fields(GraphBatch)})


class ShardedBatchBuilder:
    """``[n_shards, ...]``-stacked :class:`GraphBatch` es whose leading axis
    shards over ``data``; every shard padded to the same local sizes.
    ``backend`` as ``BatchBuilder``'s."""

    def __init__(self, ds: GraphDataset, n_shards: int, batch_size: int,
                 num_neighbors: int, pad_multiple: int = 128, seed: int = 123,
                 indices: Optional[np.ndarray] = None, backend: str = "auto"):
        self.ds = ds
        self.n_shards = n_shards
        self.builder = BatchBuilder(ds, batch_size, num_neighbors,
                                    pad_multiple, seed, indices, backend)
        self.rng = np.random.default_rng(seed + 17)
        self.indices = self.builder.indices

    @property
    def n_pad_local(self) -> int:
        return self.builder.n_pad

    def build(self, per_shard_graphs: List[np.ndarray]) -> GraphBatch:
        return stack_batches([self.builder.build(g)
                              for g in per_shard_graphs])

    def sample(self) -> GraphBatch:
        """Random balanced sample: draw n_shards·batch_size graphs, LPT-
        partition them by edges, pad each shard to batch_size graphs."""
        want = self.n_shards * self.builder.batch_size
        sel = self.rng.permutation(len(self.indices))[:want]
        shards = partition_graphs_by_edges(self.ds, self.indices[sel],
                                           self.n_shards)
        out = []
        for s in shards:
            if len(s) < self.builder.batch_size:
                fill = self.rng.choice(self.indices,
                                       self.builder.batch_size - len(s))
                s = np.concatenate([s, fill])
            out.append(s[: self.builder.batch_size])
        return self.build(out)


# ------------------------------------------------------------------- dp step
class ShardMapTrainStep:
    """Explicit DP: each data rank's forward and backward on its sub-batch
    (shard ``axis_index("data")`` of the stacked batch, with the seed folded
    with it), the gradients and the losses summed over ``data``, the same
    update on every rank.  ``loss_fn(params, local_batch, seed)`` returns
    the sum-convention local loss (the losses sum to the global one);
    ``params`` a dict of leaves that ``opt`` updates in place."""

    def __init__(self, loss_fn: Callable, opt: ClippedAdam, mesh: Mesh):
        self.loss_fn, self.opt, self.mesh = loss_fn, opt, mesh
        self.last_grads: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, params: Dict[str, torch.Tensor], stacked: GraphBatch,
                 seed: Optional[int]) -> torch.Tensor:
        i = self.mesh.axis_index("data")
        local = unstack_batch(stacked, i).to(self.mesh.device)
        s = None if seed is None else fold_seed(seed, i)
        loss = self.loss_fn(params, local, s)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = [all_reduce(g.contiguous(), self.mesh, "data") for g in grads]
        self.last_grads = dict(zip(params, grads))
        self.opt.step(grads)
        return all_reduce(loss.detach().clone(), self.mesh, "data")


def make_shard_map_train_step(loss_fn: Callable, opt: ClippedAdam,
                              mesh: Mesh) -> ShardMapTrainStep:
    return ShardMapTrainStep(loss_fn, opt, mesh)


# ------------------------------------------------- node-range partitioning
@dataclasses.dataclass
class NodeRangePartition:
    """Edge-balanced contiguous node ranges, renumbered and padded so every
    shard owns exactly ``n_local`` consecutive new ids (the static layout
    :class:`HaloPlan` requires)."""

    n_shards: int
    n_local: int  # padded, equal for every shard
    cuts: np.ndarray  # [S+1] original-order cut points
    new_of_old: np.ndarray  # [N_old] i32 — new id of each original node
    old_of_new: np.ndarray  # [S*n_local] i32 — original id, -1 for padding
    valid: np.ndarray  # [S*n_local] bool — False on padding rows

    @property
    def num_new_nodes(self) -> int:
        return self.n_shards * self.n_local


def partition_nodes_by_edges(degrees: np.ndarray, n_shards: int,
                             pad_multiple: int = 8,
                             neigh: Optional[np.ndarray] = None,
                             crossing_window: float = 0.1
                             ) -> NodeRangePartition:
    """Cut the node axis into ``n_shards`` contiguous ranges of about equal
    edge mass, renumbered so shard ``s`` owns new ids ``[s·n_local,
    (s+1)·n_local)``, padding at each range's tail.  With ``neigh`` (the
    [N, K+1] neighborhood table) each cut slides within
    ``±crossing_window·N/S`` of its target to the position crossed by the
    fewest neighbor references."""
    deg = np.asarray(degrees, dtype=np.int64)
    n = deg.shape[0]
    cum = np.concatenate([[0], np.cumsum(deg)])
    targets = cum[-1] * np.arange(1, n_shards) / n_shards
    inner = np.searchsorted(cum, targets)
    if neigh is not None and crossing_window > 0.0 and n_shards > 1:
        # span[c] = #references (i -> j) whose interval (min, max] contains
        # the boundary between node c-1 and node c
        if neigh.shape[0] != n:
            raise ValueError("neigh must cover exactly the nodes being "
                             "partitioned")
        src = np.repeat(np.arange(n, dtype=np.int64), neigh.shape[1] - 1)
        dst = np.asarray(neigh[:, 1:], dtype=np.int64).reshape(-1)
        if dst.max() >= n:
            raise ValueError("neighbor ids must be < len(degrees)")
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        diff = np.zeros(n + 2, dtype=np.int64)
        np.add.at(diff, lo + 1, 1)
        np.add.at(diff, hi + 1, -1)
        span = np.cumsum(diff)[: n + 1]  # index c = cut before node c
        w = max(1, int(crossing_window * n / n_shards))
        adjusted = []
        for c in inner:
            a, b = max(1, int(c) - w), min(n - 1, int(c) + w)
            if a > b:
                adjusted.append(int(c))
                continue
            adjusted.append(a + int(np.argmin(span[a: b + 1])))
        inner = np.asarray(adjusted, dtype=np.int64)
    cuts = np.concatenate([[0], np.clip(inner, 0, n), [n]]).astype(np.int64)
    cuts = np.maximum.accumulate(cuts)  # monotone even on degenerate degrees
    sizes = np.diff(cuts)
    n_local = int(-(-max(int(sizes.max()), 1) // pad_multiple) * pad_multiple)

    new_of_old = np.empty(n, dtype=np.int32)
    old_of_new = np.full(n_shards * n_local, -1, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = cuts[s], cuts[s + 1]
        new_of_old[lo:hi] = s * n_local + np.arange(hi - lo, dtype=np.int32)
        old_of_new[s * n_local: s * n_local + (hi - lo)] = np.arange(
            lo, hi, dtype=np.int32)
    return NodeRangePartition(n_shards=n_shards, n_local=n_local, cuts=cuts,
                              new_of_old=new_of_old, old_of_new=old_of_new,
                              valid=old_of_new >= 0)


def apply_node_partition(part: NodeRangePartition, neigh: np.ndarray,
                         x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The neighborhood table [N_old, K+1] and features [N_old, D] in the
    partition's new ids: padding rows get self-only neighborhoods and zero
    features (dead rows whose loss the caller masks with ``part.valid``)."""
    n_new = part.num_new_nodes
    k1 = neigh.shape[1]
    neigh_new = np.tile(np.arange(n_new, dtype=np.int32)[:, None], (1, k1))
    neigh_new[part.new_of_old] = part.new_of_old[neigh]
    x_new = np.zeros((n_new, x.shape[1]), dtype=x.dtype)
    x_new[part.new_of_old] = x
    return neigh_new, x_new


# -------------------------------------------------------------- halo exchange
@dataclasses.dataclass
class HaloPlan:
    """Static exchange plan for a node-range-partitioned graph: node ``v``
    is owned by shard ``v // n_local``.  For each shard ``s``:

    - ``export_idx [S, H]``: the local rows shard *s* exports — the union
      of rows *other* shards reference, padded with 0;
    - ``import_src / import_row [S, Nl, K+1]``: for every neighborhood slot
      the (source shard, export-buffer row) in the gathered stack, or,
      where ``import_local [S, Nl, K+1]`` is True, the local row.

    One ``all_gather`` of the ``[H, D]`` export buffer is the halo."""

    export_idx: np.ndarray  # [S, H] i32 local row ids to export
    import_src: np.ndarray  # [S, Nl, K+1] i32 source shard of each slot
    import_row: np.ndarray  # [S, Nl, K+1] i32 export-buf row | local row
    import_local: np.ndarray  # [S, Nl, K+1] bool: slot is own-shard

    @property
    def halo_size(self) -> int:
        return self.export_idx.shape[1]

    def shard(self, s: int, device) -> tuple:
        """(export_idx [S, H], import_src, import_row, import_local of
        shard ``s``) as device tensors (int64 indices)."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return (t(self.export_idx).long(), t(self.import_src[s]).long(),
                t(self.import_row[s]).long(), t(self.import_local[s]))


def build_halo_plan(neigh_global: np.ndarray, n_shards: int) -> HaloPlan:
    """The exchange plan of one neighborhood table [N, K+1] (self slot 0)."""
    n, k1 = neigh_global.shape
    if n % n_shards:
        raise ValueError("node count must split evenly across shards")
    n_local = n // n_shards
    owner = neigh_global // n_local  # [N, K+1]
    local_row = neigh_global % n_local
    dst_shard = (np.arange(n) // n_local)[:, None]  # owner of the reader
    is_local = owner == dst_shard

    # per source shard: union of rows exported to OTHER shards only
    export_sets: List[np.ndarray] = []
    for src in range(n_shards):
        need_mask = np.zeros(n_local, dtype=bool)
        for dst in range(n_shards):
            if dst == src:
                continue
            rows = local_row[dst * n_local: (dst + 1) * n_local]
            owners = owner[dst * n_local: (dst + 1) * n_local]
            need_mask[np.unique(rows[owners == src])] = True
        export_sets.append(np.nonzero(need_mask)[0])
    h = max(max((len(e) for e in export_sets), default=1), 1)
    export_idx = np.zeros((n_shards, h), dtype=np.int32)
    # map (shard, local_row) -> export buffer position
    pos_of = np.full((n_shards, n_local), -1, dtype=np.int32)
    for s, e in enumerate(export_sets):
        export_idx[s, : len(e)] = e
        pos_of[s, e] = np.arange(len(e), dtype=np.int32)

    import_src = owner.reshape(n_shards, n_local, k1).astype(np.int32)
    row_remote = pos_of[owner.reshape(-1), local_row.reshape(-1)].reshape(
        n_shards, n_local, k1)
    import_local = is_local.reshape(n_shards, n_local, k1)
    import_row = np.where(import_local,
                          local_row.reshape(n_shards, n_local, k1),
                          row_remote)
    if not (import_row >= 0).all():
        raise AssertionError("plan inconsistency: missing export row")
    return HaloPlan(export_idx=export_idx, import_src=import_src,
                    import_row=import_row.astype(np.int32),
                    import_local=import_local)


def _assemble(local_vecs, stack, imp_src, imp_row, imp_loc):
    """[R, K+1, D]: own-shard slots from ``local_vecs``, remote ones from
    the gathered ``stack`` [S, H, D] (the dual-use row index clipped into
    each table's range first)."""
    h, n_local = stack.shape[1], local_vecs.shape[0]
    remote = stack[imp_src, imp_row.clamp(max=h - 1)]
    local = local_vecs[imp_row.clamp(max=n_local - 1)]
    return torch.where(imp_loc[..., None], local, remote)


def halo_gather(local_vecs: torch.Tensor, export_idx: torch.Tensor,
                imp_src: torch.Tensor, imp_row: torch.Tensor,
                imp_loc: torch.Tensor, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """``[Nl, K+1, D]`` neighborhood vectors of this rank's rows
    (``local_vecs`` [Nl, D]; ``export_idx`` the full [S, H] table, the
    import tables this rank's slices): own-shard slots read the local rows,
    remote ones one ``all_gather`` of the export buffer (the only
    collective; differentiable)."""
    export = local_vecs[export_idx[mesh.axis_index(axis)]]  # [H, D]
    stack = gather_stack(export, mesh, axis)  # [S, H, D]
    return _assemble(local_vecs, stack, imp_src, imp_row, imp_loc)


# ------------------------------------------- overlapped exchange (regime 3)
@dataclasses.dataclass
class OverlapPlan:
    """Interior / boundary row split for exchange-compute overlap: a local
    row is interior when every slot of its neighborhood is own-shard.  Both
    index sets are padded to the cross-shard maxima with ``n_local``
    (dropped on the scatter back)."""

    interior_rows: np.ndarray  # [S, Ni] i32 local row ids, pad = n_local
    boundary_rows: np.ndarray  # [S, Nb] i32 local row ids, pad = n_local

    @property
    def sizes(self) -> Tuple[int, int]:
        return self.interior_rows.shape[1], self.boundary_rows.shape[1]

    def shard(self, s: int, device) -> tuple:
        return tuple(torch.from_numpy(np.ascontiguousarray(a[s])).long()
                     .to(device) for a in (self.interior_rows,
                                           self.boundary_rows))


def build_overlap_plan(plan: HaloPlan) -> OverlapPlan:
    """Each shard's rows split into interior / boundary from the halo plan's
    ``import_local`` table."""
    imp_loc = np.asarray(plan.import_local)  # [S, Nl, K+1]
    n_shards, n_local, _ = imp_loc.shape
    is_int = imp_loc.all(axis=-1)  # [S, Nl]
    ni = max(int(is_int.sum(axis=1).max()), 1)
    nb = max(int((~is_int).sum(axis=1).max()), 1)
    interior = np.full((n_shards, ni), n_local, dtype=np.int32)
    boundary = np.full((n_shards, nb), n_local, dtype=np.int32)
    for s in range(n_shards):
        r_int = np.nonzero(is_int[s])[0]
        r_bnd = np.nonzero(~is_int[s])[0]
        interior[s, : len(r_int)] = r_int
        boundary[s, : len(r_bnd)] = r_bnd
    return OverlapPlan(interior_rows=interior, boundary_rows=boundary)


def interior_fraction(plan: HaloPlan) -> float:
    """Mean fraction of rows whose whole neighborhood is own-shard — the
    compute available to hide the exchange under."""
    return float(np.asarray(plan.import_local).all(axis=-1).mean())


def halo_encode_overlapped(encode_fn: Callable, local_vecs: torch.Tensor,
                           export_idx: torch.Tensor, imp_src: torch.Tensor,
                           imp_row: torch.Tensor, imp_loc: torch.Tensor,
                           interior_rows: torch.Tensor,
                           boundary_rows: torch.Tensor, mesh: Mesh,
                           axis: str = "data") -> torch.Tensor:
    """One overlapped halo layer: issue the export ``all_gather``
    (``async_op=True``), encode the interior rows (``encode_fn(rows [R,
    K+1, D], tag)`` → [R, D]; tag 0) while it flies, wait, encode the
    boundary rows from the landed stack (tag 1), and scatter both back into
    ``[Nl, D]`` row order.  Row for row the same encoder inputs as
    :func:`halo_gather` with a whole-shard encode."""
    n_local = local_vecs.shape[0]
    export = local_vecs[export_idx[mesh.axis_index(axis)]]  # [H, D]
    issued = all_gather_start(export.detach(), mesh, axis)

    # interior: every slot is a local row id
    ir = interior_rows.clamp(max=n_local - 1)
    int_out = encode_fn(local_vecs[imp_row[ir].clamp(max=n_local - 1)], 0)

    # boundary: mixed local / remote slots, from the landed stack
    stack = gather_stack(export, mesh, axis, issued)
    br = boundary_rows.clamp(max=n_local - 1)
    bnd_out = encode_fn(_assemble(local_vecs, stack, imp_src[br], imp_row[br],
                                  imp_loc[br]), 1)

    # rows == n_local (padding) land in a spare row that is cut off
    out = int_out.new_zeros(n_local + 1, int_out.shape[-1])
    out = out.index_put((interior_rows,), int_out)
    out = out.index_put((boundary_rows,), bnd_out)
    return out[:n_local]


# ------------------------------------------------- regime-2 full train step
class HaloUnsupParams(nn.Module):
    """The node-partitioned unsupervised U2GNN: ``encoders`` (k
    :class:`EncoderParams`) and the sampled softmax's ``ss.weight``
    [total_nodes, D], ``ss.bias`` (replicated) — the state-dict keys of
    JAX's ``HaloUnsupParams`` flattened (``weights.params_from_jax``)."""

    def __init__(self, num_layers: int, feature_dim: int, ff_hidden: int,
                 total_nodes: int, num_timesteps: int = 1, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.encoders = nn.ModuleList(
            EncoderParams(num_timesteps, feature_dim, ff_hidden, gen)
            for _ in range(num_layers))
        self.ss = SampledSoftmaxParams(total_nodes, feature_dim, gen)


def init_halo_unsup_params(seed: int, num_layers: int, feature_dim: int,
                           ff_hidden: int, total_nodes: int,
                           num_timesteps: int = 1) -> HaloUnsupParams:
    return HaloUnsupParams(num_layers, feature_dim, ff_hidden, total_nodes,
                           num_timesteps, seed)


def halo_unsup_forward_local(params: HaloUnsupParams, x_local: torch.Tensor,
                             export_idx: torch.Tensor, imp_src: torch.Tensor,
                             imp_row: torch.Tensor, imp_loc: torch.Tensor,
                             num_timesteps: int, seed: Optional[int],
                             mesh: Mesh, axis: str = "data",
                             interior_rows: Optional[torch.Tensor] = None,
                             boundary_rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """This rank's node-partitioned encoder forward: per U2GNN layer one
    halo exchange re-gathers the current node vectors into [Nl, K+1, D]
    neighborhoods, then the per-layer encoder runs on the local rows
    (dropout rate 0.5 from ``seed``, or 0 without one).  With
    ``interior_rows``/``boundary_rows`` (an :class:`OverlapPlan` shard
    slice) each layer runs the overlapped schedule.  Returns the updated
    self vectors [Nl, D]."""
    rate = 0.0 if seed is None else ENCODER_DROPOUT
    h = x_local
    for i, enc in enumerate(params.encoders):
        p = enc.stacked()
        s_i = None if seed is None else layer_seed(seed, i)
        if interior_rows is not None:
            def encode_part(nv, tag, p=p, s_i=s_i):
                return neighborhood_encoder(
                    p, nv, 1, rate, None if s_i is None else fold_seed(s_i, tag),
                    num_timesteps=num_timesteps)

            h = halo_encode_overlapped(encode_part, h, export_idx, imp_src,
                                       imp_row, imp_loc, interior_rows,
                                       boundary_rows, mesh, axis)
            continue
        nv = halo_gather(h, export_idx, imp_src, imp_row, imp_loc, mesh, axis)
        h = neighborhood_encoder(p, nv, 1, rate, s_i,
                                 num_timesteps=num_timesteps)
    return h


class HaloTrainStep:
    """Regime 2's full training step (:func:`make_halo_train_step`)."""

    def __init__(self, opt: ClippedAdam, mesh: Mesh, total_nodes: int,
                 nsampled: int, num_timesteps: int, axis: str,
                 deterministic: bool, overlap: bool, masked: bool):
        self.opt, self.mesh, self.axis = opt, mesh, axis
        self.spec = LogUniformSpec.create(total_nodes, nsampled)
        self.n_shards = mesh.axis_size(axis)
        if total_nodes % self.n_shards:
            raise ValueError(f"{total_nodes} nodes do not split over "
                             f"{self.n_shards} ranks")
        self.n_local = total_nodes // self.n_shards
        self.num_timesteps = num_timesteps
        self.deterministic, self.overlap = deterministic, overlap
        self.masked = masked or overlap
        self.last_grads: Optional[Dict[str, torch.Tensor]] = None
        self.last_h: Optional[torch.Tensor] = None

    def __call__(self, params: HaloUnsupParams, x, plan: HaloPlan, seed: int,
                 oplan: Optional[OverlapPlan] = None, valid=None,
                 sample_ids: Optional[torch.Tensor] = None,
                 probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on the global host features ``x`` [N, D] (this rank
        takes its ``n_local`` rows) and ``plan``; ``valid`` [N] masks the
        losses of padding rows (with ``overlap`` or ``masked``; ``oplan``
        with ``overlap``).  ``seed``: the candidates' draw, shared by every
        rank, and, unless ``deterministic``, the dropout, folded with the
        rank.  ``sample_ids`` / ``probs``: given candidates and P(k) table
        (tests hand JAX's).  Returns the loss summed over the ranks."""
        s, nl, dev = self.mesh.axis_index(self.axis), self.n_local, \
            self.mesh.device
        rows = slice(s * nl, (s + 1) * nl)
        x_local = torch.as_tensor(np.asarray(x)[rows]).to(dev)
        tables = plan.shard(s, dev)
        parts = oplan.shard(s, dev) if self.overlap else (None, None)
        labels = torch.arange(s * nl, (s + 1) * nl, device=dev)
        valid_cand = None
        if sample_ids is None:
            sample_ids, valid_cand = draw_candidates(seed, self.spec, dev)
        drop = None if self.deterministic else fold_seed(seed, s)
        h = halo_unsup_forward_local(params, x_local, *tables,
                                     self.num_timesteps, drop, self.mesh,
                                     self.axis, *parts)
        losses = loss_given(params.ss.weight, params.ss.bias, h, labels,
                            sample_ids.to(dev), valid_cand, self.spec, "tf",
                            probs=None if probs is None else probs.to(dev))
        if self.masked:
            losses = losses * torch.as_tensor(
                np.asarray(valid, np.float32)[rows]).to(dev)
        loss = losses.sum()
        names = [n for n, _ in params.named_parameters()]
        grads = torch.autograd.grad(loss, list(params.parameters()))
        grads = [all_reduce(g.contiguous(), self.mesh, self.axis)
                 for g in grads]
        self.last_grads = dict(zip(names, grads))
        self.last_h = h.detach()
        self.opt.step(grads)
        return all_reduce(loss.detach().clone(), self.mesh, self.axis)


def make_halo_train_step(opt: ClippedAdam, mesh: Mesh, total_nodes: int,
                         nsampled: int, num_timesteps: int = 1,
                         axis: str = "data", deterministic: bool = False,
                         overlap: bool = False,
                         masked: bool = False) -> HaloTrainStep:
    """Regime 2's full step: the node-partitioned encoder with a halo
    exchange a layer, the sampled softmax of each rank's own nodes (labels
    their global ids, one shared candidate draw), the gradients and the
    loss summed over ``axis``, and ``opt``'s update (Adam over the
    :class:`HaloUnsupParams`).  ``overlap=True`` is regime 3: each layer on
    :func:`halo_encode_overlapped`, the losses masked by ``valid``;
    ``masked=True`` the blocking exchange with that mask, the overlapped
    step's parity twin.  The step keeps ``last_grads`` (summed) and
    ``last_h`` (this rank's encoder output)."""
    return HaloTrainStep(opt, mesh, total_nodes, nsampled, num_timesteps,
                         axis, deterministic, overlap, masked)


# ---------------------------------------------------- analytic scaling model
def halo_cost_model(plan: HaloPlan, n_local: int, feature_dim: int,
                    num_layers: int, ff_hidden: int, num_timesteps: int = 1,
                    bytes_per_elt: int = 2,
                    link_bytes_per_s: float = 4.5e11,
                    flops_per_s: float = 9.89e14,
                    valid_fraction: float = 1.0) -> dict:
    """Hardware-independent scaling prediction for the halo regime: per-step
    collective bytes against local compute, JAX's formula.

    Per U2GNN layer each rank all-gathers the [H, D] export buffers of all
    S ranks (a ring moves (S-1)·H·D elements over each link), while local
    compute is the neighborhood encoder over [n_local·(K+1), D] rows.
    Efficiency ≈ t_compute / (t_compute + t_collective) without overlap
    (regime 2); ``predicted_efficiency_overlap`` models regime 3, where a
    layer costs ``max(t_coll_layer, f_int·t_comp_layer) + (1 -
    f_int)·t_comp_layer`` with ``f_int`` the interior fraction of the plan.
    ``valid_fraction`` (real nodes / padded slots) scales both.

    Defaults: the NVIDIA H100 SXM5's published figures, not readings —
    NVLink 4 at 450 GB/s a direction and 989 TFLOP/s of dense bf16."""
    S, H = plan.export_idx.shape
    k1 = plan.import_src.shape[-1]
    d = feature_dim
    # ring all_gather: each link carries (S-1)·H·D elements per exchange
    coll_bytes = (S - 1) * H * d * bytes_per_elt * num_layers
    rows = n_local * k1
    # encoder FLOPs per layer (attention ~ rows·k1·d + ffn rows·d·ff, ×T)
    enc_flops = ((2 * rows * d * 3 * d + 2 * rows * k1 * d * 2
                  + 2 * rows * d * d)
                 + 2 * (2 * rows * d * ff_hidden)) * num_timesteps
    flops = enc_flops * num_layers * 3  # fwd + ~2x bwd
    t_comp = flops / flops_per_s
    t_coll = coll_bytes / link_bytes_per_s

    f_int = interior_fraction(plan)
    t_comp_layer = t_comp / num_layers
    t_coll_layer = t_coll / num_layers
    t_layer_ov = (max(t_coll_layer, f_int * t_comp_layer)
                  + (1.0 - f_int) * t_comp_layer)
    eff_overlap = t_comp / (num_layers * t_layer_ov)
    return {
        "shards": int(S),
        "halo_rows_per_shard": int(H),
        "collective_bytes_per_step": int(coll_bytes),
        "local_flops_per_step": int(flops),
        "t_compute_s": t_comp,
        "t_collective_s": t_coll,
        "interior_fraction": f_int,
        "valid_fraction": valid_fraction,
        "predicted_efficiency": valid_fraction * t_comp / (t_comp + t_coll),
        "predicted_efficiency_overlap": valid_fraction * eff_overlap,
    }
