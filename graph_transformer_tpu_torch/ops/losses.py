"""Losses of the U2GNN family — port of ``label_smoothing``,
``soft_cross_entropy`` (``graph_transformer_tpu/ops/losses.py:19-42``),
``supcon_loss`` (``:44-84``) and ``gae_loss`` (``:99-116``).
``multilayer_supcon_loss`` waits for the multiplex models (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def label_smoothing(labels: torch.Tensor, num_classes: int,
                    smoothing: float = 0.1) -> torch.Tensor:
    """Soft targets: 1-ε on the true class, ε/(C-1) elsewhere."""
    confidence = 1.0 - smoothing
    off = smoothing / (num_classes - 1)
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                         num_classes).to(torch.float32)
    return onehot * (confidence - off) + off


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean_B Σ_c -target · log_softmax(logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_ex = -(soft_targets * logp).sum(-1)
    if mask is not None:
        return (per_ex * mask).sum() / mask.sum().clamp_min(1.0)
    return per_ex.mean()


def supcon_loss(features: torch.Tensor, mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                temperature: float = 1.0,
                dist: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised contrastive loss, adjacency-as-mask variant
    (``GraphContrastiveLoss.forward``, ``contrastive_loss.py:29-77``):
    pairwise dot logits / τ (or ``-dist``), max-subtracted (no gradient
    through the max), self pairs out of numerator and denominator, mean
    log-probability over the positives ``mask`` [N, N] with an ε=1e-10
    guard, negated and averaged over the rows (the ``valid`` [N] ones)."""
    n = features.shape[0]
    dots = -dist if dist is not None else (features @ features.T) / temperature
    if mask is None:
        if labels is None:
            raise ValueError("need `mask` or `labels`")
        mask = labels[:, None] == labels[None, :]
    mask = mask.to(torch.float32)
    logits_mask = 1.0 - torch.eye(n, dtype=torch.float32,
                                  device=features.device)
    if valid is not None:
        logits_mask = logits_mask * valid[None, :]
    mask = mask * logits_mask
    logits = dots - dots.max(dim=1, keepdim=True).values.detach()
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True)
                                  .clamp_min(1e-30))
    mean_log_prob_pos = (mask * log_prob).sum(1) / (mask.sum(1) + 1e-10)
    if valid is not None:
        return -(mean_log_prob_pos * valid).sum() / valid.sum().clamp_min(1.0)
    return -mean_log_prob_pos.mean()


def gae_loss(logits_list: Sequence[torch.Tensor], adj_label: torch.Tensor,
             norm, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """norm · mean weighted BCE(σ(ZZᵀ) stacked over layers, A)
    (``loss_functions.py:41-49``), predictions clipped to [1e-7, 1-1e-7]."""
    preds = torch.stack([torch.sigmoid(z @ z.T) for z in logits_list],
                        dim=2).reshape(-1)
    target = adj_label.reshape(-1)
    eps = 1e-7
    preds = preds.clamp(eps, 1.0 - eps)
    bce = -(target * torch.log(preds) + (1.0 - target) * torch.log(1.0 - preds))
    if weight is not None:
        bce = bce * weight.reshape(-1)
    return norm * bce.mean()
