"""Sampled softmax over node vocabularies — port of
``graph_transformer_tpu/ops/sampled_softmax.py``.

Two modes, as in JAX:

- ``mode='reference'``: the PyTorch fork's NCE-style loss
  (``sampled_softmax.py:36-56`` of the reference):
  ``loss_i = logsumexp_s(u_i·w_s) - u_i·w_label`` over ``nsampled``
  log-uniform candidates — no bias, no expected-count correction, no
  accidental-hit masking, the true logit not in the denominator.
- ``mode='tf'``: ``tf.nn.sampled_softmax_loss``'s semantics: biases, the log
  expected counts subtracted, accidental hits at ``-1e9``, softmax cross
  entropy against the true class prepended as class 0.

The draw is split from the loss: :func:`draw_candidates` takes the step's
seed (``sampling/log_uniform.py``; the exact Gumbel-top-k sampler up to
:data:`FAST_SAMPLER_VOCAB_THRESHOLD` nodes, the oversample-and-dedup one past
it, whose unfilled slots are ``-inf`` in both modes), and :func:`loss_given`
computes the per-example losses for given candidates, so that tests can hand
it JAX's own.  The gathers, the ``[B, nsampled]`` candidate product and the
logsumexp are plain torch (XLA outside any Pallas kernel in JAX).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from graph_transformer_tpu_torch.sampling.log_uniform import (
    LogUniformSpec,
    expected_count,
    probs_table,
    sample_log_uniform_fast,
    sample_log_uniform_unique,
)

# above this vocabulary the oversample-and-dedup sampler replaces the exact
# one (``sampled_softmax.py:42`` of the JAX package)
FAST_SAMPLER_VOCAB_THRESHOLD = 32_768
ACCIDENTAL_HIT = 1e9


def init_sampled_softmax_params(vocab_size: int, nhid: int,
                                gen: torch.Generator) -> tuple:
    """(weight [V, nhid] uniform in ±sqrt(6/(V+nhid)), bias [V] zeros)
    (``sampled_softmax.py:25-27``; ``model_U2GNN_Unsup_multi.py:54``)."""
    stdv = math.sqrt(6.0 / (vocab_size + nhid))
    weight = (torch.rand((vocab_size, nhid), generator=gen) * 2.0 - 1.0) * stdv
    return weight, torch.zeros(vocab_size)


def log_expected_count(spec: LogUniformSpec, ids: torch.Tensor,
                       probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log E[count] of the ids among ``spec.num_tries`` tries, from the
    float32 table ``probs`` [V] (default ``log_uniform_probs``)."""
    if probs is None:
        probs = probs_table(spec.vocab_size, str(ids.device))
    return torch.log(expected_count(spec.num_tries, probs[ids]))


def draw_candidates(seed: int, spec: LogUniformSpec, device="cpu") -> tuple:
    """(sample_ids [nsampled] int64, valid [nsampled] bool or None) of a
    step seeded ``seed``: the exact sampler up to the threshold (no
    ``valid``), the fast one past it."""
    if spec.vocab_size > FAST_SAMPLER_VOCAB_THRESHOLD:
        return sample_log_uniform_fast(seed, spec.vocab_size, spec.nsampled,
                                       device=device)
    return sample_log_uniform_unique(seed, spec.vocab_size, spec.nsampled,
                                     device=device), None


def loss_given(weight: torch.Tensor, bias: torch.Tensor,
               inputs: torch.Tensor, labels: torch.Tensor,
               sample_ids: torch.Tensor, valid: Optional[torch.Tensor],
               spec: LogUniformSpec, mode: str = "tf",
               mask: Optional[torch.Tensor] = None,
               probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example losses [B] of ``inputs`` [B, D] against ``labels`` [B]
    with the candidates ``sample_ids`` [S] (``valid`` [S] marks the filled
    slots, or None); padding rows zeroed by ``mask`` [B].  ``probs``: the
    [V] float32 P(k) table of the ``tf`` mode (default
    ``log_uniform_probs``; tests give JAX's)."""
    labels = labels.to(torch.int64)
    sample_ids = sample_ids.to(torch.int64)
    true_w = weight[labels]  # [B, D]
    sample_w = weight[sample_ids]  # [S, D]
    true_dot = (inputs * true_w).sum(-1)
    sample_dot = inputs @ sample_w.T  # [B, S]
    if mode == "reference":
        if valid is not None:
            sample_dot = sample_dot.masked_fill(~valid[None, :], -math.inf)
        out = torch.logsumexp(sample_dot, dim=-1) - true_dot
    elif mode == "tf":
        true_logit = (true_dot + bias[labels] - log_expected_count(
            spec, labels, probs))
        sample_logit = (sample_dot + bias[sample_ids][None, :]
                        - log_expected_count(spec, sample_ids, probs)[None, :])
        hit = sample_ids[None, :] == labels[:, None]
        sample_logit = torch.where(hit, sample_logit - ACCIDENTAL_HIT,
                                   sample_logit)
        if valid is not None:
            sample_logit = sample_logit.masked_fill(~valid[None, :],
                                                    -math.inf)
        logits = torch.cat([true_logit[:, None], sample_logit], dim=1)
        out = torch.logsumexp(logits, dim=-1) - true_logit
    else:
        raise ValueError(f"unknown sampled-softmax mode {mode!r}")
    if mask is not None:
        out = out * mask
    return out
