"""FFN + residual + LayerNorm over rows — port of ``ffn_residual_ln``
(``graph_transformer_tpu/ops/pallas_ffn.py``): kernels K11 (forward,
``pallas_ffn.py:70``) and K12 (backward, ``:97``), ``ops/csrc/ffn.cu``.

    out = LN(x + drop(drop(relu(x @ W1 + b1)) @ W2 + b2))   over x [M, D]

The per-layer encoder (``ops/attention.encoder_layer``) runs it after its
plain attention for masked (node-axis) or multi-head layers.  Products take
operands in ``x``'s dtype (bfloat16 rows: bfloat16 products; float32 rows:
float32) and accumulate in float32; ``out`` and ``dx`` come back in ``x``'s
dtype, the weight gradients in float32, as in the TPU kernel.  Dropout draws
sites 2 (hidden) and 3 (FFN output) of timestep ``layer``
(``ops/random.py``), the encoder layer's FFN sites, so the plain versions
reproduce the kernels' masks.

Dispatch: on CUDA tensors K11/K12 (a launch counter each) up to D = 128 and
past it kernels K18 and K20 (``ops/rows_encoder.ffn_rows_forward`` and
``ffn_rows_backward``), on CPU tensors the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import (
    dropout,
    layer_norm,
    rnd,
)
from graph_transformer_tpu_torch.ops.random import drop_args
from graph_transformer_tpu_torch.ops.rows_encoder import (
    ffn_rows_backward,
    ffn_rows_forward,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import WIDE_MAX_D

HIDDEN_SITE, OUT_SITE = 2, 3


def _mm(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _forward(x, w1, b1, w2, b2, gamma, beta, rate, seed, layer):
    """(h: the dropped hidden rounded to the compute dtype, LN(x + y) as
    ``layer_norm`` gives it)."""
    mm = _mm(x.dtype)
    xf = x.to(torch.float32)
    hpre = rnd(xf, mm) @ rnd(w1, mm) + b1
    h = rnd(dropout(torch.relu(hpre), rate, seed, layer, HIDDEN_SITE), mm)
    y = dropout(h @ rnd(w2, mm) + b2, rate, seed, layer, OUT_SITE)
    return h, layer_norm(xf + y, gamma, beta)


def ffn_forward_plain(x, w1, b1, w2, b2, gamma, beta, rate: float = 0.0,
                      seed: Optional[int] = None, layer: int = 0):
    """Plain version of K11: ``out`` [M, D] in ``x``'s dtype."""
    _, (out, _, _) = _forward(x, w1, b1, w2, b2, gamma, beta, rate, seed,
                              layer)
    return out.to(x.dtype)


def ffn_backward_plain(x, dout, w1, b1, w2, b2, gamma, beta,
                       rate: float = 0.0, seed: Optional[int] = None,
                       layer: int = 0):
    """Plain version of K12: the forward recomputed from ``x``, then
    ``(dx in x's dtype, (dw1, db1, dw2, db2, dgamma, dbeta) float32)``;
    ``dout`` is taken in ``x``'s dtype, as the TPU kernel takes it.  The
    hidden's relu' times its dropout factor is ``(h > 0) / keep``."""
    mm = _mm(x.dtype)
    h, (_, uhat, rstd) = _forward(x, w1, b1, w2, b2, gamma, beta, rate, seed,
                                  layer)
    g = dout.to(x.dtype).to(torch.float32)
    gg = g * gamma
    du = (gg - gg.mean(-1, keepdim=True)
          - uhat * (gg * uhat).mean(-1, keepdim=True)) * rstd
    dy = dropout(du, rate, seed, layer, OUT_SITE)
    keep = 1.0 - rate if rate > 0.0 else 1.0
    dh = (rnd(dy, mm) @ rnd(w2, mm).T) * ((h > 0).to(torch.float32) / keep)
    dx = du + rnd(dh, mm) @ rnd(w1, mm).T
    xb = rnd(x.to(torch.float32), mm)
    grads = (xb.T @ rnd(dh, mm), dh.sum(0), h.T @ rnd(dy, mm), dy.sum(0),
             (g * uhat).sum(0), g.sum(0))
    return dx.to(x.dtype), grads


def ffn_forward(x, w1, b1, w2, b2, gamma, beta, rate: float = 0.0,
                seed: Optional[int] = None, layer: int = 0):
    """K11 on CUDA tensors (K18 and K20 past D = 128),
    :func:`ffn_forward_plain` on CPU tensors."""
    M, D = x.shape
    if not x.is_cuda:
        return ffn_forward_plain(x, w1, b1, w2, b2, gamma, beta, rate, seed,
                                 layer)
    if D > WIDE_MAX_D:
        return ffn_rows_forward(x, w1, b1, w2, b2, gamma, beta, rate, seed,
                                layer)
    _build.check_rows_dtype(x)
    x = x.contiguous()
    ps = _build.f32_params((w1, b1, w2, b2, gamma, beta))
    out = torch.empty_like(x)
    if M:
        err = _build.load("ffn").gt_k11_ffn_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            _build.params_array(ps), layer, M, D, w1.shape[1],
            *drop_args(rate, seed), _build.stream_ptr(x.device))
        _build.check(err, "K11 ffn_fwd")
        ffn_forward.launches += 1
    return out


ffn_forward.launches = 0


def ffn_backward(x, dout, w1, b1, w2, b2, gamma, beta, rate: float = 0.0,
                 seed: Optional[int] = None, layer: int = 0):
    """K12 on CUDA tensors (K18 and K20 past D = 128),
    :func:`ffn_backward_plain` on CPU tensors; same return value."""
    M, D = x.shape
    F = w1.shape[1]
    if not x.is_cuda:
        return ffn_backward_plain(x, dout, w1, b1, w2, b2, gamma, beta, rate,
                                  seed, layer)
    if D > WIDE_MAX_D:
        return ffn_rows_backward(x, dout, w1, b1, w2, b2, gamma, beta, rate,
                                 seed, layer)
    _build.check_rows_dtype(x)
    x = x.contiguous()
    bf = int(x.dtype == torch.bfloat16)
    ps = _build.f32_params((w1, b1, w2, b2, gamma, beta))
    dx = torch.empty_like(x)
    grads = torch.zeros(2 * D * F + F + 3 * D, dtype=torch.float32,
                        device=x.device)
    if M:
        lib = _build.load("ffn")
        work = torch.empty(lib.gt_k12_work_bytes(M, D, F, bf),
                           dtype=torch.uint8, device=x.device)
        g = dout.to(x.dtype).to(torch.float32).contiguous()
        err = lib.gt_k12_ffn_bwd(
            x.data_ptr(), bf, g.data_ptr(), _build.params_array(ps), layer,
            dx.data_ptr(), work.data_ptr(), grads.data_ptr(), M, D, F,
            *drop_args(rate, seed), _build.stream_ptr(x.device))
        _build.check(err, "K12 ffn_bwd")
        ffn_backward.launches += 1
    db1, db2, dg, dbeta, dw1, dw2 = grads.split([F, D, D, D, D * F, F * D])
    return dx, (dw1.view(D, F), db1, dw2.view(F, D), db2, dg, dbeta)


ffn_backward.launches = 0


def weight_product_plain(a, b):
    """Plain version of the split-K weight products: ``a^T b`` in float32
    over the rows of a [rows, M1] and b [rows, N1]."""
    return a.to(torch.float32).T @ b.to(torch.float32)


def weight_product(a, b):
    """The split-K weight products of K6, K8w, K10w, K12 and K14w
    (``wd_wgrad``, ``ops/csrc/wide_mma.cuh``) alone on CUDA tensors, the
    plain version on CPU tensors: ``a^T b`` [M1, N1] float32, with a, b
    both bfloat16 (bf16 products) or both float32 (3xTF32)."""
    if not a.is_cuda:
        return weight_product_plain(a, b)
    _build.check_rows_dtype(a)
    if b.dtype != a.dtype or a.shape[0] != b.shape[0]:
        raise ValueError("a [rows, M1] and b [rows, N1] of one dtype")
    rows, M1 = a.shape
    N1 = b.shape[1]
    out = torch.empty(M1, N1, dtype=torch.float32, device=a.device)
    if rows:
        lib = _build.load("ffn")
        split = torch.empty(lib.gt_wgrad_split_floats(rows, M1, N1),
                            dtype=torch.float32, device=a.device)
        a, b = a.contiguous(), b.contiguous()
        err = lib.gt_wgrad(a.data_ptr(), b.data_ptr(),
                           int(a.dtype == torch.bfloat16), rows, M1, N1,
                           split.data_ptr(), out.data_ptr(),
                           _build.stream_ptr(a.device))
        _build.check(err, "wd_wgrad")
        weight_product.launches += 1
    else:
        out.zero_()
    return out


weight_product.launches = 0


class FFNResidualLNFn(torch.autograd.Function):
    """Differentiable in ``x`` and the six tensors; the seed gets none."""

    @staticmethod
    def forward(ctx, x, seed, rate, layer, *params):
        ctx.cfg = (seed, rate, layer)
        ctx.save_for_backward(x, *params)
        return ffn_forward(x, *params, rate=rate, seed=seed, layer=layer)

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        seed, rate, layer = ctx.cfg
        dx, grads = ffn_backward(x, dout, *params, rate=rate, seed=seed,
                                 layer=layer)
        return (dx, None, None, None,
                *(g.to(p.dtype) for g, p in zip(grads, params)))


def ffn_residual_ln(x: torch.Tensor, w1, b1, w2, b2, gamma, beta,
                    seed: Optional[int] = None, rate: float = 0.0,
                    layer: int = 0) -> torch.Tensor:
    """``LN(x + drop(drop(relu(x@w1+b1))@w2+b2))`` over ``x [M, D]``,
    differentiable in ``x`` and the six tensors (w1 [D, F], b1 [F], w2
    [F, D], b2, gamma, beta [D]); dropout from ``seed``, sites 2-3 of
    timestep ``layer``."""
    return FFNResidualLNFn.apply(x, seed, rate, layer, w1, b1, w2, b2, gamma,
                                 beta)
