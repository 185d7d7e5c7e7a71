"""Neighborhood transformer encoder parameters and the plain encoder layer —
port of ``graph_transformer_tpu/ops/attention.py``.

Weights are stored ``[in, out]`` as in the JAX package (``y = x @ W + b``),
never as ``nn.Linear``'s ``[out, in]``.  :class:`EncoderParams` holds the 12
stacked ``[T, ...]`` tensors in the field order of the JAX
``TransformerEncoderParams``; the kernels take them in :data:`KERNEL_ORDER`,
the order of the JAX kernels' stacked tuple.

:func:`layer_forward` is the plain torch-1.5 post-norm layer over
neighborhoods ``[N, S, D]``:

    attn -> drop -> +res -> LN1 -> FFN(relu, drop) -> drop -> +res -> LN2

single head, attention over the S slots of each neighborhood, softmax scale
1/sqrt(D), LayerNorm eps 1e-5.  Matrix-product operands are rounded to the
compute dtype ``mm`` (bfloat16 or float32) and accumulate in float32, as in
the Pallas kernels.  Dropout masks come from ``ops/random.py`` so that the
kernels' plain versions reproduce the kernels' masks.  It is the building
block of the plain versions of every encoder kernel in the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from graph_transformer_tpu_torch.ops.random import dropout_stream, keep_mask

LN_EPS = 1e-5

FIELDS = ("w_in", "b_in", "w_out", "b_out", "w_ff1", "b_ff1", "w_ff2",
          "b_ff2", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
KERNEL_ORDER = ("w_in", "b_in", "w_out", "b_out", "ln1_scale", "ln1_bias",
                "w_ff1", "b_ff1", "w_ff2", "b_ff2", "ln2_scale", "ln2_bias")


def xavier_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


class EncoderParams(nn.Module):
    """Stacked parameters of T post-norm encoder layers (leading ``[T]``
    axis; timestep t uses slice ``t % T``)."""

    def __init__(self, num_layers: int, d_model: int, ff_hidden: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        T, D, F = num_layers, d_model, ff_hidden
        gen = gen if gen is not None else torch.Generator().manual_seed(0)

        def xav(*s):
            return nn.Parameter(torch.stack(
                [xavier_uniform(s, gen) for _ in range(T)]))

        def const(v, *s):
            return nn.Parameter(torch.full((T, *s), float(v)))

        self.w_in = xav(D, 3 * D)
        self.b_in = const(0, 3 * D)
        self.w_out = xav(D, D)
        self.b_out = const(0, D)
        self.w_ff1 = xav(D, F)
        self.b_ff1 = const(0, F)
        self.w_ff2 = xav(F, D)
        self.b_ff2 = const(0, D)
        self.ln1_scale = const(1, D)
        self.ln1_bias = const(0, D)
        self.ln2_scale = const(1, D)
        self.ln2_bias = const(0, D)

    def stacked(self):
        """The 12 tensors in :data:`KERNEL_ORDER`."""
        return tuple(getattr(self, n) for n in KERNEL_ORDER)


def rnd(a: torch.Tensor, mm: torch.dtype) -> torch.Tensor:
    """Round a product operand to the compute dtype, back in float32."""
    return a if mm == torch.float32 else a.to(mm).to(torch.float32)


def layer_norm(u: torch.Tensor, g, b):
    """(out, uhat, rstd) with rstd [..., 1]."""
    mu = u.mean(-1, keepdim=True)
    d = u - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + LN_EPS)
    uhat = d * rstd
    return uhat * g + b, uhat, rstd


def layer_forward(x: torch.Tensor, p, *, layer: int, rate: float,
                  seed: Optional[int], mm: torch.dtype, slot0: bool):
    """One encoder layer over ``x`` [N, S, D] float32 (timestep ``layer``).

    ``p``: that layer's 12 tensors in :data:`KERNEL_ORDER`.  ``slot0``: the
    last layer, whose queries, FFN and output exist for slot 0 only (keys and
    values span all S slots).  Returns ``(out, res)``: out [N, S, D] (or
    [N, D] when ``slot0``) and the residuals the backward needs: ``qkv``
    [N, S, 3D], ``attn`` (undropped probabilities, [N, S, S] or [N, S]) and
    ``strip`` = [ctx, y1, uhat1, uhat2, rstd1, rstd2] ([N, S, 4D+2] or
    [N, 4D+2]), and ``h``, the dropped-out FFN hidden ([N, S, F] or [N, F])
    that the stored-residual backward reads."""
    N, S, D = x.shape
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    keep = 1.0 - rate
    scale = 1.0 / math.sqrt(D)

    def drop(v, site):
        if rate <= 0.0:
            return v
        m = keep_mask(seed, dropout_stream(layer, site), v.shape, rate,
                      v.device)
        return v * m / keep

    qkv = rnd(x, mm) @ rnd(w_in, mm) + b_in
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    if slot0:
        s = (rnd(q[:, :1], mm) @ rnd(k, mm).transpose(1, 2))[:, 0] * scale
        attn = torch.softmax(s, dim=-1)  # [N, S]
        ctx = (rnd(drop(attn, 0), mm)[:, None, :] @ rnd(v, mm))[:, 0]
        x_res = x[:, 0]
    else:
        s = (rnd(q, mm) @ rnd(k, mm).transpose(1, 2)) * scale
        attn = torch.softmax(s, dim=-1)  # [N, S, S]
        ctx = rnd(drop(attn, 0), mm) @ rnd(v, mm)
        x_res = x
    a = drop(rnd(ctx, mm) @ rnd(w_out, mm) + b_out, 1)
    y1, uhat1, rstd1 = layer_norm(x_res + a, g1, c1)
    h = drop(torch.relu(rnd(y1, mm) @ rnd(w1, mm) + b1), 2)
    z = drop(rnd(h, mm) @ rnd(w2, mm) + b2, 3)
    out, uhat2, rstd2 = layer_norm(y1 + z, g2, c2)
    strip = torch.cat([ctx, y1, uhat1, uhat2, rstd1, rstd2], dim=-1)
    return out, dict(qkv=qkv, attn=attn, strip=strip, h=h)
