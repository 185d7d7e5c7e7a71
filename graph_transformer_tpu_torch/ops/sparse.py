"""Sparse gather/scatter substrate — ports of ``graph_sum_pool``
(``graph_transformer_tpu/ops/sparse.py:20``), ``spmm``, ``gcn_norm_edges``,
``edge_softmax``, ``sddmm_dot`` (``:37-109``) and ``global_regather``
(``:110-148``).

None accumulates with float atomics on the card, so a training step repeats
bit for bit.  JAX reduces edges by ``segment_sum``/``segment_max``; here an
edge list is grouped by segment once (:class:`Segments`: a stable sort of
the segment ids and the count of each segment), and every reduction walks
the sorted edges segment by segment (``torch.segment_reduce``, one output
element's sum in one thread, in edge order).  The two differentiable
primitives keep that order in both directions: :func:`segment_sum`'s
backward gathers the segments' gradients back to the edges, and
:func:`gather`'s (``x[ids]``) sums the edges' gradients by segment, where
``x[ids]``'s own backward would accumulate into repeated rows.  Padding
edges (``edge_mask`` 0) are reduced like the others and contribute zero,
as in JAX.  These are the JAX package's XLA operations, not Pallas kernels;
the port runs them in PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

MAX_REGATHER_NODES = 2_000_000


def graph_sum_pool(node_vec: torch.Tensor, graph_id: torch.Tensor,
                   num_graphs: int) -> torch.Tensor:
    """Graph-level sum pooling [B, D]; padding rows carry graph id B and are
    dropped.

    The sum is the product of a dense one-hot ``[B, N]`` membership matrix
    with ``node_vec``: a matrix product adds in a fixed order, so two runs on
    the card give the same bits.  ``index_add_`` (JAX's ``segment_sum``)
    accumulates with float atomics on CUDA, whose order changes from run to
    run.  The backward is the transposed product, a gather."""
    graph_id = graph_id.to(torch.int64)
    rows = torch.arange(num_graphs, device=graph_id.device)
    onehot = (graph_id[None, :] == rows[:, None]).to(node_vec.dtype)
    return onehot @ node_vec


def global_regather(out: torch.Tensor, node_gidx: torch.Tensor,
                    node_mask: torch.Tensor, neigh_global: torch.Tensor,
                    num_total_nodes: int) -> torch.Tensor:
    """The next U2GNN layer's neighborhood features ``[N, K+1, D]`` from this
    layer's batch output ``out [N, D]``, given dataset-global neighbor ids
    ``neigh_global [N, K+1]``: the JAX model's route on the two-pass path.
    The port's trainer re-gathers by the batch slots its sampler writes
    (``out[batch.neigh]``) and does not call this; the model keeps it for a
    caller that passes global ids, and the tests hold the slot route to it.

    Each real row (``node_mask > 0``) is scattered to the slot of its global
    id ``node_gidx`` in a zero buffer of the dataset's nodes, then the
    neighborhoods are gathered by global id.  Graphs are disjoint, so every
    neighbor of a real node is in the batch.  The JAX version sends all
    padding rows to one dummy slot; here each padding row gets a slot of its
    own past the dataset's nodes, so that no index repeats in the scatter and
    no host sync is needed to pick the real rows.  Differentiable in ``out``.

    The buffer scales with the dataset, not the batch: ``num_total_nodes``
    above 2,000,000 raises, as in JAX."""
    assert num_total_nodes <= MAX_REGATHER_NODES, (
        f"global_regather scratch would be [{num_total_nodes + 1}, "
        f"{out.shape[-1]}] per regather per step; use the batch-local "
        "re-gather for large-node-count datasets")
    N = out.shape[0]
    pad_slot = num_total_nodes + torch.arange(N, device=out.device)
    idx = torch.where(node_mask > 0, node_gidx.to(torch.int64), pad_slot)
    buf = out.new_zeros(num_total_nodes + N, out.shape[1])
    return buf.index_copy(0, idx, out)[neigh_global.to(torch.int64)]


# ------------------------------------------------------ segment reductions
@dataclasses.dataclass
class Segments:
    """Elements grouped by a segment id: ``ids`` [E] (int64), ``order`` [E]
    the elements sorted by segment (stably: within a segment in element
    order) and ``lengths`` [num_segments] the elements of each segment."""

    ids: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def of(cls, ids: torch.Tensor, num_segments: int) -> "Segments":
        ids = ids.to(torch.int64)
        order = torch.sort(ids, stable=True).indices
        return cls(ids, order, torch.bincount(ids, minlength=num_segments))

    @property
    def num_segments(self) -> int:
        return self.lengths.shape[0]


def _reduce(values: torch.Tensor, seg: Segments, op: str) -> torch.Tensor:
    """[num_segments, ...] reduction of ``values`` [E, ...] by segment, each
    segment's elements in element order (``sum`` of none is 0, ``max`` of
    none -inf)."""
    return torch.segment_reduce(values[seg.order], op, lengths=seg.lengths,
                                axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg):
        ctx.seg = seg
        return _reduce(values, seg, "sum")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.seg.ids], None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x[seg.ids]

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.seg, "sum"), None


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """y[n] = Σ over elements e of segment n of values[e] (JAX's
    ``jax.ops.segment_sum``); differentiable, its backward a gather."""
    return _SegmentSum.apply(values, seg)


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``x[seg.ids]``, differentiable, its backward a segment sum."""
    return _Gather.apply(x, seg)


def segment_max(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Max of each segment's values (-inf where empty), no gradient."""
    return _reduce(values.detach(), seg, "max")


# ----------------------------------------------------- graph operations
def spmm(src: Segments, dst: Segments, edge_val: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """y[dst] += val · x[src]: sparse A @ X with A given as COO edges
    grouped by source (``src``) and by target (``dst``); the GCN
    aggregation ``spmm(adj, X @ W)`` with ``edge_val`` the normalized
    adjacency weights."""
    return segment_sum(gather(x, src) * edge_val[:, None], dst)


def gcn_norm_edges(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   edge_mask: torch.Tensor, num_nodes: int,
                   add_self_loops: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2 as edge values:
    (src, dst, val), with the self loops appended (length E + N); degrees
    count the masked edges only, by target."""
    edge_src = edge_src.to(torch.int64)
    edge_dst = edge_dst.to(torch.int64)
    deg = _reduce(edge_mask, Segments.of(edge_dst, num_nodes), "sum")
    if add_self_loops:
        deg = deg + 1.0
        loop = torch.arange(num_nodes, device=edge_src.device)
        edge_src = torch.cat([edge_src, loop])
        edge_dst = torch.cat([edge_dst, loop])
        edge_mask = torch.cat([edge_mask, edge_mask.new_ones(num_nodes)])
    dinv = torch.rsqrt(deg.clamp_min(1e-12))
    return edge_src, edge_dst, dinv[edge_src] * dinv[edge_dst] * edge_mask


def edge_softmax(scores: torch.Tensor, seg: Segments,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """Softmax of the edges' ``scores`` within each segment of ``seg``
    (JAX normalizes over the ids it is given: the targets, or the sources in
    the GAT), padding edges out: the segment max subtracted (no gradient
    through it), exponentials summed by segment."""
    masked = torch.where(edge_mask > 0, scores,
                         torch.full_like(scores, -1e30))
    smax = segment_max(masked, seg)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(masked - gather(smax, seg)) * edge_mask
    denom = segment_sum(ex, seg)
    return ex / gather(denom, seg).clamp_min(1e-16)


def sddmm_dot(src: Segments, dst: Segments, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products <a[src], b[dst]> (sampled dense-dense
    matmul)."""
    return (gather(a, src) * gather(b, dst)).sum(-1)
