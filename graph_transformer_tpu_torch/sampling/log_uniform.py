"""Log-uniform (Zipfian) candidate sampling — port of
``graph_transformer_tpu/sampling/log_uniform.py``.

Distribution (the reference's ``Log_Uniform_Sampler.cpp:14``):

    P(k) = (log(k+2) - log(k+1)) / log(V+1),   k in [0, V)

:func:`log_uniform_probs` computes it as JAX does, ``log(k+2) - log(k+1)`` in
float32: its cancellation at large k is part of the function that the ``tf``
loss corrects by.  The two float32 logs are the correctly rounded ones,
built on the host, so that the card and the CPU share one table; XLA's
float32 log differs from them by an ulp at about 1% of k, which the
cancellation magnifies (up to 4.5% of P(k) at V = 40,000).
:func:`expected_num_tries` (numpy, float64 Newton) and
:class:`LogUniformSpec` are copies; :func:`expected_count` is
``-expm1(t · log1p(-p))``.

The two samplers are JAX's.  :func:`sample_log_uniform_unique` takes the
``nsampled`` largest ``log P(k) + Gumbel`` keys over the vocabulary (exact
sampling without replacement); :func:`sample_log_uniform_fast` draws
``4 · nsampled`` values by CDF inversion, ``floor(exp(u · log(V+1))) - 1``,
and keeps the first ``nsampled`` distinct ones in draw order, with a
``valid`` flag for slots left unfilled.  Their uniforms are 32-bit words of
``ops/random.random_bits`` under :data:`CANDIDATE_STREAM`, keyed by the
step's seed, and the keys are computed in float64 from a host table of
``log P(k)``: the card and the CPU draw the same candidates for the same
seed (no ``torch.Generator`` gives that across devices).  The draws are not
JAX's, whose bits come from its own generator; tests hand JAX's candidates
to the loss (``ops/sampled_softmax.loss_given``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from graph_transformer_tpu_torch.ops.random import random_bits

CANDIDATE_STREAM = 0x43414E44


def log_uniform_probs(vocab_size: int, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """[V] candidate probabilities P(k) = (log(k+2)-log(k+1))/log(V+1).

    float32 as JAX computes it: the two logs in float32, their difference in
    float32 (whose cancellation at large k is kept), divided in float32.
    The logs are the correctly rounded float32 values (float64 logs
    rounded), computed on the host, so every device gets the same table;
    XLA's float32 log is within an ulp of them.  float64: in float64."""
    k = np.arange(vocab_size, dtype=np.float64)
    if dtype == torch.float64:
        p = (np.log(k + 2.0) - np.log(k + 1.0)) / math.log(vocab_size + 1.0)
    else:
        diff = (np.log(k + 2.0).astype(np.float32)
                - np.log(k + 1.0).astype(np.float32))
        p = diff / np.float32(math.log(vocab_size + 1.0))
    return torch.from_numpy(p).to(device, dtype)


@functools.lru_cache(maxsize=8)
def probs_table(vocab_size: int, device: str) -> torch.Tensor:
    """:func:`log_uniform_probs` in float32 on ``device``, built once."""
    return log_uniform_probs(vocab_size, device=device)


def expected_num_tries(vocab_size: int, nsampled: int, iters: int = 50) -> float:
    """Solve E[#unique after t tries] = sum_k 1-(1-p_k)^t == nsampled for t.

    Deterministic host-side Newton iteration; result is cached by callers and
    baked into the compiled loss as a constant.
    """
    k = np.arange(vocab_size, dtype=np.float64)
    p = (np.log(k + 2.0) - np.log(k + 1.0)) / math.log(vocab_size + 1.0)
    log1mp = np.log1p(-p)
    t = float(nsampled)
    for _ in range(iters):
        e = np.exp(t * log1mp)  # (1-p)^t
        f = np.sum(1.0 - e) - nsampled
        df = np.sum(-log1mp * e)
        if df <= 0:
            break
        step = f / df
        t -= step
        t = max(t, float(nsampled))
        if abs(step) < 1e-9:
            break
    return float(t)


def expected_count(num_tries: float, probs: torch.Tensor) -> torch.Tensor:
    """-expm1(t * log1p(-p)) — expected candidate frequency among t tries."""
    return -torch.expm1(num_tries * torch.log1p(-probs))


@dataclasses.dataclass(frozen=True)
class LogUniformSpec:
    """Precomputed constants for a (vocab, nsampled) pair."""

    vocab_size: int
    nsampled: int
    num_tries: float

    @staticmethod
    def create(vocab_size: int, nsampled: int) -> "LogUniformSpec":
        return LogUniformSpec(
            vocab_size=vocab_size,
            nsampled=nsampled,
            num_tries=expected_num_tries(vocab_size, nsampled),
        )


@functools.lru_cache(maxsize=8)
def _log_probs64(vocab_size: int, device: str) -> torch.Tensor:
    """[V] float64 log P(k), computed once on the host and kept on
    ``device``, so that every device ranks by the same keys."""
    k = np.arange(vocab_size, dtype=np.float64)
    logp = np.log(np.log(k + 2.0) - np.log(k + 1.0)) - math.log(
        math.log(vocab_size + 1.0))
    return torch.from_numpy(logp).to(device)


def _uniform64(seed: int, n: int, device) -> torch.Tensor:
    """[n] float64 uniforms in (0, 1), ``(word + 0.5) / 2^32``."""
    bits = random_bits(seed, CANDIDATE_STREAM, n, device)
    return (bits.to(torch.float64) + 0.5) * (1.0 / 2**32)


def sample_log_uniform_unique(seed: int, vocab_size: int, nsampled: int,
                              device="cpu") -> torch.Tensor:
    """[nsampled] int64 unique candidate ids ~ log-uniform, by Gumbel
    top-k: the ``nsampled`` largest ``log P(k) - log(-log u_k)``, in
    decreasing key order."""
    dev = torch.device(device)
    u = _uniform64(seed, vocab_size, dev)
    keys = _log_probs64(vocab_size, str(dev)) - torch.log(-torch.log(u))
    return torch.topk(keys, nsampled).indices


def sample_log_uniform_fast(seed: int, vocab_size: int, nsampled: int,
                            oversample: int = 4, device="cpu") -> tuple:
    """(ids [nsampled] int64, valid [nsampled] bool): ``m = oversample ·
    nsampled`` i.i.d. values ``floor(exp(u · log(V+1))) - 1`` (clipped to
    the vocabulary), of which the first ``nsampled`` distinct ones in draw
    order; ``valid`` is False for slots that the m draws could not fill."""
    dev = torch.device(device)
    m = oversample * nsampled
    u = _uniform64(seed, m, dev)
    vals = (torch.floor(torch.exp(u * math.log(vocab_size + 1.0)))
            .to(torch.int64) - 1).clamp(0, vocab_size - 1)
    # first-occurrence ranks: sort by (value, draw index); the first of each
    # run keeps its draw index, duplicates go past every first
    order = torch.argsort(vals, stable=True)
    sv = vals[order]
    first = torch.ones_like(sv, dtype=torch.bool)
    first[1:] = sv[1:] != sv[:-1]
    rank = torch.where(first, order, m + order)
    take = torch.topk(rank, nsampled, largest=False).indices
    return sv[take], rank[take] < m
