"""Graph pooling and the inter-layer re-gather — ports of ``graph_sum_pool``
(``graph_transformer_tpu/ops/sparse.py:20``) and ``global_regather``
(``:110-148``).  Neither accumulates with float atomics on the card, so a
training step repeats bit for bit."""

from __future__ import annotations

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
