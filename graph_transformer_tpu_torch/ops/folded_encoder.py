"""Folded row-input encoders — port of the row-input API of
``graph_transformer_tpu/ops/pallas_folded.py``: ``folded_u2gnn_encoder``
(``:405``, kernel 7, forward only) and ``folded_u2gnn_encoder_grad``
(``:1009``: kernel 8's forward with residuals, then kernels 3 and 2).

Both take the contract of ``fused_u2gnn_encoder``: rows [N·S, D] -> the
slot-0 output of the last layer [N, D] float32.  The rows are cast to bf16
and the products and dropout are bf16, as in the TPU kernels.  The forward
is K1's (``ops/sampled_encoder.py``) reading given rows instead of sampling
them: kernel K16 (``ops/csrc/folded_fwd.cu``) writes only the output, K15
also K1's residuals in K1's layout (layer inputs in bf16, q/k/v, the
probabilities, the LayerNorm strip); the TPU kernels' folded [G, S·D]
lanes and selector constants are TPU devices and are not carried over.
``folded_u2gnn_encoder_grad``'s backward is K3 then (T-1)×K2 on those
residuals (``sampled_encoder.encoder_backward``) and returns the rows'
cotangent, as ``_folded_grad_bwd`` does (``:1073``).

The shapes are JAX's gate, ``folded_shape_ok`` (S·D <= 128 and
S·S·D <= 1024).  Where it holds at D <= 32 K15/K16 run.  It holds past
D = 32 only at S <= 3, past the one-thread-per-row kernels' rows: there the
same function runs on the wide kernels — K17 with K6
(``stored_encoder.fused_u2gnn_encoder_stored``) for the gradient, the wide
forward K4tw for the forward — on the bf16 rows.  Elsewhere both raise, as
JAX's callers take another encoder there.

Dispatch: the kernels on CUDA tensors, the plain versions on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.random import device_seed, drop_launch
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    encoder_backward,
    rows_forward_plain,
)
from graph_transformer_tpu_torch.ops.stored_encoder import (
    folded_shape_ok,
    fused_u2gnn_encoder_stored,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    MAX_D,
    u2gnn_encoder_train,
)


def _narrow(S: int, D: int) -> bool:
    """Whether K15/K16 take S slots of D features (else the wide route)."""
    if not folded_shape_ok(S, D):
        raise ValueError(
            f"S={S}, D={D}: outside the folded gate (S·D <= 128 and "
            "S·S·D <= 1024, pallas_folded.py:85-90); take "
            "fused_u2gnn_encoder_stored or u2gnn_train_encoder")
    return D <= MAX_D


# ================================================================= forward
def folded_stored_forward_plain(x2d, params, seq_len: int,
                                num_timesteps: int, rate: float,
                                seed: Optional[int]):
    """Plain version of K15: ``(out [N, D] float32, res)`` with ``res`` =
    dict(xs, qkv, attn, strip), lists of T per-layer tensors as
    ``sampled_encoder.sampled_forward`` gives them (``xs`` in bf16,
    ``xs[0]`` the bf16 rows)."""
    D = x2d.shape[1]
    h = x2d.to(torch.bfloat16).to(torch.float32).view(-1, seq_len, D)
    return rows_forward_plain(h, params, num_timesteps, rate, seed,
                              torch.bfloat16, torch.bfloat16)


def folded_forward_plain(x2d, params, seq_len: int, num_timesteps: int,
                         rate: float, seed: Optional[int]) -> torch.Tensor:
    """Plain version of K16: the output of :func:`folded_stored_forward_plain`."""
    return folded_stored_forward_plain(x2d, params, seq_len, num_timesteps,
                                       rate, seed)[0]


def _launch(x2d, params, S, T, rate, seed, residuals: bool):
    N, D = x2d.shape[0] // S, x2d.shape[1]
    F = params[6].shape[2]
    dev = x2d.device
    x = x2d.to(torch.bfloat16).contiguous()
    ps = _build.f32_params(params)
    f32 = dict(dtype=torch.float32, device=dev)
    Tf = max(T - 1, 0)
    out = torch.empty(N, D, **f32)
    res = dict(xs=torch.empty(T, N, S, D, dtype=torch.bfloat16, device=dev),
               qkv=torch.empty(T, N, S, 3 * D, **f32),
               attn_full=torch.empty(Tf, N, S, S, **f32),
               attn_last=torch.empty(N, S, **f32),
               strip_full=torch.empty(Tf, N, S, 4 * D + 2, **f32),
               strip_last=torch.empty(N, 4 * D + 2, **f32)) \
        if residuals else None
    if N:
        lib = _build.load("folded_fwd")
        G = _build.pick_fwd_groups("folded_fwd", "gt_k15_smem_bytes", S,
                                   D, N)
        seed = device_seed(seed, dev)
        tail = (N, S, D, F, T, G, 1.0 / math.sqrt(D),
                *drop_launch(rate, seed),
                _build.stream_ptr(dev))
        head = (x.data_ptr(), _build.params_array(ps), ps[0].shape[0],
                out.data_ptr())
        if residuals:
            def opt(t):
                return t.data_ptr() if T > 1 else None

            err = lib.gt_k15_folded_stored_fwd(
                *head, res["xs"].data_ptr(), res["qkv"].data_ptr(),
                opt(res["attn_full"]), res["attn_last"].data_ptr(),
                opt(res["strip_full"]), res["strip_last"].data_ptr(), *tail)
        else:
            err = lib.gt_k16_folded_fwd(*head, *tail)
        _build.check(err, "K15 folded_stored_fwd" if residuals
                     else "K16 folded_fwd")
    if not residuals:
        return out
    return out, dict(xs=list(res["xs"].unbind(0)),
                     qkv=list(res["qkv"].unbind(0)),
                     attn=list(res["attn_full"].unbind(0))
                     + [res["attn_last"]],
                     strip=list(res["strip_full"].unbind(0))
                     + [res["strip_last"]])


def folded_stored_forward(x2d, params, seq_len: int, num_timesteps: int,
                          rate: float, seed: Optional[int]):
    """K15 on CUDA tensors (D <= 32), :func:`folded_stored_forward_plain`
    on CPU tensors; same return value."""
    if not x2d.is_cuda:
        return folded_stored_forward_plain(x2d, params, seq_len,
                                           num_timesteps, rate, seed)
    if x2d.shape[1] > MAX_D:
        raise NotImplementedError(f"D={x2d.shape[1]}: K15 takes D <= {MAX_D}")
    out = _launch(x2d, params, seq_len, num_timesteps, rate, seed, True)
    folded_stored_forward.launches += 1
    return out


def folded_forward(x2d, params, seq_len: int, num_timesteps: int,
                   rate: float, seed: Optional[int]) -> torch.Tensor:
    """K16 on CUDA tensors (D <= 32), :func:`folded_forward_plain` on CPU
    tensors."""
    if not x2d.is_cuda:
        return folded_forward_plain(x2d, params, seq_len, num_timesteps, rate,
                                    seed)
    if x2d.shape[1] > MAX_D:
        raise NotImplementedError(f"D={x2d.shape[1]}: K16 takes D <= {MAX_D}")
    out = _launch(x2d, params, seq_len, num_timesteps, rate, seed, False)
    folded_forward.launches += 1
    return out


folded_stored_forward.launches = 0
folded_forward.launches = 0


# ============================================================ entry points
@torch.no_grad()
def folded_u2gnn_encoder(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                         seq_len: int, num_timesteps: int, rate: float = 0.0,
                         seed: Optional[int] = None) -> torch.Tensor:
    """[N·S, D] rows -> [N, D] float32 in bf16, forward only (as kernel 7):
    K16, or past D = 32 (S <= 3) the wide forward on the bf16 rows."""
    if _narrow(seq_len, x2d.shape[1]):
        return folded_forward(x2d, params, seq_len, num_timesteps, rate, seed)
    return u2gnn_encoder_train(x2d.to(torch.bfloat16), params, seq_len,
                               num_timesteps, rate, seed)[0]


class FoldedEncoderFn(torch.autograd.Function):
    """K15 forward, K3 then (T-1)×K2 backward; differentiable in the rows
    and the 12 parameters, the seed gets no gradient."""

    @staticmethod
    def forward(ctx, x2d, seed, S, T, rate, *params):
        out, res = folded_stored_forward(x2d, params, S, T, rate, seed)
        ctx.res = res
        ctx.cfg = (T, rate, seed, x2d.shape, x2d.dtype)
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, dout):
        params = ctx.saved_tensors
        T, rate, seed, shape, dtype = ctx.cfg
        dx, dparams = encoder_backward(ctx.res, dout, params, T, rate, seed)
        ctx.res = None
        dx = dx.reshape(shape).to(dtype) if ctx.needs_input_grad[0] else None
        return (dx, None, None, None, None, *dparams)


def folded_u2gnn_encoder_grad(x2d: torch.Tensor,
                              params: Sequence[torch.Tensor], seq_len: int,
                              num_timesteps: int, rate: float = 0.0,
                              seed: Optional[int] = None) -> torch.Tensor:
    """[N·S, D] rows -> [N, D] float32 in bf16, differentiable in ``x2d``
    and the 12 stacked ``params``: K15, then K3 and (T-1)×K2.  Past D = 32
    (S <= 3), K17 with K6 on the bf16 rows, the same function."""
    if _narrow(seq_len, x2d.shape[1]):
        seed = device_seed(seed, x2d.device)
        return FoldedEncoderFn.apply(x2d, seed, seq_len, num_timesteps, rate,
                                     *params)
    # the folded gate admits D > 32 only at S <= 3, past K15's rows; K17/K6
    # compute the same stored-residual function there
    return fused_u2gnn_encoder_stored(x2d.to(torch.bfloat16), params,
                                      seq_len, num_timesteps, rate, seed)
