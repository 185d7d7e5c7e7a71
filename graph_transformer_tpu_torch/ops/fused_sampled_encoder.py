"""Fused sampler with the recompute backward — port of
``fused_u2gnn_encoder_sampled`` (``graph_transformer_tpu/ops/
pallas_sampled_encoder.py:246``): kernel K13 (``_sampled_fwd_kernel``,
``:139``) forward, kernel 5's hybrid chain (K8s, then K8 per earlier layer;
K8ws/K8w past D = 32, ``ops/u2gnn_train.py``) backward, or with ``mega_bwd``
(``:251, 281``) the whole-stack backward K14 (K14w past D = 32).

Per node n: draw K = S-1 neighbor slots uniformly from the first
min(deg, 128) entries of its tag row, build x0 = bf16(codebook[tags]) (the
TPU kernel's ``onehot(tag) @ codebook`` rounded to the saved dtype,
``:160-180``) and run T post-norm encoder layers, the last for slot 0 only.
The forward returns the slot-0 output [N, D] float32 and saves the inputs of
layers 0..T-1 (x0 and the TPU kernel's saved_refs) in bf16; nothing else.
The backward recomputes each layer from its saved input.  Everything is
bf16, whatever the model's compute dtype says, as in JAX (``:263, :272``).

Random bits: neighbors from K1's counters (``ops/random.uniform_draws``),
dropout from sites 4t..4t+3 of the seed, so for one seed K13 draws K1's and
K5's neighborhoods and gives their forward output bit for bit.  The TPU
kernel draws both from its on-core PRNG, which the CPU cannot run.

Dispatch: on CUDA tensors K13 (``ops/csrc/fused_sampled_fwd.cu``: the
narrow kernel for D <= 32, the wide one for 32 < D <= 128; one launch
counter), on CPU tensors the plain version.  Only the 12 parameters get
gradients; the codebook and the integer inputs get none (``:286-291``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.random import device_seed, drop_launch
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    _i32,
    sampled_forward_plain,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    MAX_D,
    WIDE_ROWS,
    check_wide_shapes,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import (
    chain_backward,
    mega_recompute_backward,
)


def fused_sampled_forward_plain(tag_rows, deg, self_tag, codebook, params,
                                seq_len: int, num_timesteps: int, rate: float,
                                seed: Optional[int], draws=None):
    """Plain version of K13: ``(out [N, D] float32, xs [T, N·S, D] bf16,
    draws [N, S-1])`` with ``xs[0]`` the built x0."""
    out, res = sampled_forward_plain(tag_rows, deg, self_tag, codebook,
                                     params, seq_len, num_timesteps, rate,
                                     seed, draws, torch.bfloat16, ())
    D = codebook.shape[1]
    xs = torch.stack(res["xs"]).reshape(num_timesteps, -1, D)
    return out, xs, res["draws"]


def fused_sampled_forward(tag_rows, deg, self_tag, codebook, params,
                          seq_len: int, num_timesteps: int, rate: float,
                          seed: Optional[int], draws=None):
    """K13 on CUDA tensors, :func:`fused_sampled_forward_plain` on CPU
    tensors; same return value."""
    if not tag_rows.is_cuda:
        return fused_sampled_forward_plain(tag_rows, deg, self_tag, codebook,
                                           params, seq_len, num_timesteps,
                                           rate, seed, draws)
    S, T = seq_len, num_timesteps
    N, W = tag_rows.shape
    D = codebook.shape[1]
    F = params[6].shape[2]
    K = S - 1
    check_wide_shapes(S, D)
    if draws is None and seed is None:
        raise ValueError("sampling needs a seed (or draws made outside)")
    dev = tag_rows.device
    tag_rows = _i32(tag_rows, (N, W))
    deg = _i32(deg, (N,))
    self_tag = _i32(self_tag, (N,))
    codebook = codebook.to(torch.float32).contiguous()
    draws_in = None if draws is None else _i32(draws, (N, K))
    ps = _build.f32_params(params)
    out = torch.empty(N, D, dtype=torch.float32, device=dev)
    draws_out = torch.empty(N, K, dtype=torch.int32, device=dev)
    xs = torch.empty(T, N * S, D, dtype=torch.bfloat16, device=dev)
    if N:
        wide = D > MAX_D
        G = (_build.pick_groups("fused_sampled_fwd", "gt_k13w_smem_bytes", S,
                                D, WIDE_ROWS) if wide else
             _build.pick_fwd_groups("fused_sampled_fwd", "gt_k13_smem_bytes",
                                    S, D, N))
        seed = device_seed(seed, dev)
        err = _build.load("fused_sampled_fwd").gt_k13_sampled_fwd(
            tag_rows.data_ptr(), W, deg.data_ptr(), self_tag.data_ptr(),
            codebook.data_ptr(),
            None if draws_in is None else draws_in.data_ptr(),
            draws_out.data_ptr(), _build.params_array(ps), ps[0].shape[0],
            out.data_ptr(), xs.data_ptr(), N, S, D, F, T, G,
            1.0 / math.sqrt(D), *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, "K13 fused_sampled_fwd")
        fused_sampled_forward.launches += 1
    return out, xs, draws_out.to(torch.int64)


fused_sampled_forward.launches = 0


def fused_sampled_backward(xs, dout, params, seq_len: int,
                           num_timesteps: int, rate: float,
                           seed: Optional[int], mega_bwd: bool = False):
    """From K13's saved bf16 inputs ``xs`` [T, N·S, D]: kernel 5's hybrid
    chain (``pallas_u2gnn.py:455-496``; K8s (K8ws) for the last layer, K8
    (K8w) for the others) or, with ``mega_bwd``, the whole-stack backward
    K14 (K14w; ``pallas_sampled_encoder.py:281``).  Returns the 12 stacked
    parameter gradients."""
    bwd = mega_recompute_backward if mega_bwd else chain_backward
    dparams = bwd(xs[0], xs[1:], dout, params, seq_len, num_timesteps, rate,
                  seed)[1]
    return [d.to(p.dtype) for d, p in zip(dparams, params)]


class FusedSampledEncoderFn(torch.autograd.Function):
    """Differentiable in the 12 parameters; the integer inputs, the codebook
    and the seed get no gradient."""

    @staticmethod
    def forward(ctx, tag_rows, deg, self_tag, codebook, draws, seed, S, T,
                rate, mega_bwd, *params):
        out, xs, _ = fused_sampled_forward(tag_rows, deg, self_tag, codebook,
                                           params, S, T, rate, seed, draws)
        ctx.xs = xs
        ctx.cfg = (S, T, rate, seed, mega_bwd)
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, dout):
        params = ctx.saved_tensors
        S, T, rate, seed, mega_bwd = ctx.cfg
        xs, ctx.xs = ctx.xs, None
        dparams = fused_sampled_backward(xs, dout, params, S, T, rate, seed,
                                         mega_bwd)
        return (None,) * 10 + tuple(dparams)


def fused_sampled_encoder(tag_rows, deg, self_tag, codebook,
                          params: Sequence[torch.Tensor], seq_len: int,
                          num_timesteps: int, rate: float = 0.5,
                          seed: Optional[int] = None, draws=None,
                          mega_bwd: bool = False) -> torch.Tensor:
    """[N] rows -> [N, D] float32, differentiable in ``params``: the
    contract of ``sampled_encoder.sampled_encoder`` (tag rows [N, 128], 12
    stacked tensors in KERNEL_ORDER, ``draws`` made outside or None), always
    in bf16.  ``mega_bwd`` takes the whole-stack backward (K14/K14w) in
    place of the per-layer chain."""
    seed = device_seed(seed, tag_rows.device)
    return FusedSampledEncoderFn.apply(tag_rows, deg, self_tag, codebook,
                                       draws, seed, seq_len, num_timesteps,
                                       rate, mega_bwd, *params)
