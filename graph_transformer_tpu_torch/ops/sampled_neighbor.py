"""Neighbor-negative sampled loss — port of
``graph_transformer_tpu/ops/sampled_neighbor.py``.

The reference's ``SampledNeighbor`` (``U2GNN_pytorch/sampled_neighbor.py``)
draws each example's negatives from the *graph neighbors* of its label node,
with replacement, and scores ``logsumexp_s(u·w_s) - u·w_true``; label nodes
without neighbors contribute nothing (``:17-18``).  As in JAX, example i is
scored against the neighbors of its own label (the reference's vectorised
inner product scores every row against each label's set, ``:66-69``).

Split into the draw (:func:`draw_neighbor_negatives`, positions in each
label's CSR list from ``sampling/neighbors.csr_draws`` under
:data:`NEGATIVE_STREAM`) and :func:`loss_given`, which tests feed with
JAX's ``randint`` draws.  Plain torch: CSR gathers and a batched product.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_transformer_tpu_torch.sampling.neighbors import DeviceCSR, csr_draws

NEGATIVE_STREAM = 0x4E454753


def draw_neighbor_negatives(seed: int, csr: DeviceCSR, labels: torch.Tensor,
                            nsampled: int) -> torch.Tensor:
    """[B, nsampled] int64 positions in each label's neighbor list."""
    deg = csr.degrees[labels.to(torch.int64)]
    return csr_draws(seed, deg, nsampled, NEGATIVE_STREAM)


def loss_given(weight: torch.Tensor, inputs: torch.Tensor,
               labels: torch.Tensor, csr: DeviceCSR, r: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example losses [B] for the draws ``r`` [B, S]; zero where the
    label node is isolated, and on padding rows (``mask`` [B])."""
    labels = labels.to(torch.int64)
    deg = csr.degrees[labels]
    neg_ids = csr.gather(csr.offsets[labels][:, None] + r.to(torch.int64))
    true_dot = (inputs * weight[labels]).sum(-1)
    neg_dot = torch.einsum("bd,bsd->bs", inputs, weight[neg_ids])
    out = torch.logsumexp(neg_dot, dim=-1) - true_dot
    out = torch.where(deg > 0, out, torch.zeros_like(out))
    if mask is not None:
        out = out * mask
    return out
