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

The per-layer encoder (``ops/attention.py:111-447`` of the JAX package) runs
T layers one call each, with the Universal-Transformer recurrences between
them (``ops/ut_recurrence.py``): :func:`encoder_layer` sends a single-head
layer without a key mask to kernels K9/K10 (``ops/encoder_layer.py``), and
otherwise runs :func:`multihead_attention` in plain torch (in float32, as XLA
runs it for the JAX package) and then K11/K12 (``ops/ffn.py``).
:func:`transformer_encoder` loops over the timesteps, reusing the parameter
stack cyclically; :func:`neighborhood_encoder` runs it over the K+1 slots of
each node or, on the ``node`` axis (the PyTorch reference's quirk), over the
nodes of each slot column with padding nodes masked out of every softmax.
Timestep t of an encoder draws its dropout from streams ``4t + site`` of the
encoder's seed, in K9/K10, in the plain attention (sites 0-1) and in K11/K12
(sites 2-3).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def dropout(v: torch.Tensor, rate: float, seed: Optional[int], layer: int,
            site: int) -> torch.Tensor:
    """``v * mask / keep`` with the mask of site ``site`` of timestep
    ``layer`` (row-major element indices of ``v``); ``v`` at rate 0."""
    if rate <= 0.0:
        return v
    m = keep_mask(seed, dropout_stream(layer, site), v.shape, rate, v.device)
    return v * m / (1.0 - rate)


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
    scale = 1.0 / math.sqrt(D)

    def drop(v, site):
        return dropout(v, rate, seed, layer, site)

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


# ======================================================== per-layer encoder
def multihead_attention(p: dict, x: torch.Tensor, num_heads: int = 1,
                        rate: float = 0.0, seed: Optional[int] = None,
                        layer: int = 0,
                        key_mask: Optional[torch.Tensor] = None):
    """Self multi-head attention over ``x`` [B, S, D]
    (``nn.MultiheadAttention`` semantics): packed q/k/v, scale
    1/sqrt(D / num_heads), probabilities rounded to ``x``'s dtype and
    dropped at site 0 of timestep ``layer``; ``key_mask`` [S] (1 = attend)
    sends excluded keys' scores to -1e30.
    Products in float32 with ``x``'s values, the context rounded to ``x``'s
    dtype, as XLA computes the JAX package's version.  ``p`` maps w_in
    [D, 3D], b_in, w_out [D, D] and b_out to tensors.  Returns the output
    projection [B, S, D] float32."""
    B, S, D = x.shape
    H = num_heads
    hd = D // H
    qkv = x.to(torch.float32) @ p["w_in"] + p["b_in"]
    q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))  # [B, H, S, hd]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if key_mask is not None:
        scores = scores.masked_fill(key_mask.reshape(1, 1, 1, S) <= 0, -1e30)
    attn = rnd(torch.softmax(scores, dim=-1), x.dtype)
    attn = rnd(dropout(attn, rate, seed, layer, 0), x.dtype)
    ctx = rnd((attn @ v).transpose(1, 2).reshape(B, S, D), x.dtype)
    return ctx @ p["w_out"] + p["b_out"]


def encoder_layer(x: torch.Tensor, p: Sequence[torch.Tensor],
                  num_heads: int = 1, rate: float = 0.0,
                  seed: Optional[int] = None, layer: int = 0,
                  key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One post-norm layer (torch 1.5 ``TransformerEncoderLayer``) over ``x``
    [B, S, D], timestep ``layer``; ``p``: the layer's 12 tensors in
    KERNEL_ORDER.  Single head without a key mask: K9/K10 over the rows,
    out in ``x``'s dtype.  Otherwise the plain attention, its output dropout
    (site 1) and LN1, then K11/K12 over the float32 rows, out float32."""
    from graph_transformer_tpu_torch.ops.encoder_layer import (
        fused_encoder_layer,
    )
    from graph_transformer_tpu_torch.ops.ffn import ffn_residual_ln

    B, S, D = x.shape
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    if num_heads == 1 and key_mask is None:
        return fused_encoder_layer(x.reshape(B * S, D), *p, seed, S, rate,
                                   layer).view(B, S, D)
    a = multihead_attention(dict(w_in=w_in, b_in=b_in, w_out=w_out,
                                 b_out=b_out), x, num_heads, rate, seed,
                            layer, key_mask)
    y1 = layer_norm(x.to(torch.float32) + dropout(a, rate, seed, layer, 1),
                    g1, c1)[0]
    return ffn_residual_ln(y1.reshape(B * S, D), w1, b1, w2, b2, g2, c2,
                           seed, rate, layer).view(B, S, D)


def transformer_encoder(params: Sequence[torch.Tensor], x: torch.Tensor,
                        num_heads: int = 1,
                        rate: float = 0.5, seed: Optional[int] = None,
                        num_timesteps: Optional[int] = None,
                        key_mask: Optional[torch.Tensor] = None,
                        recurrence: str = "basic", rec_params=None,
                        return_ponder: bool = False):
    """T timesteps of :func:`encoder_layer` over ``x`` [B, S, D], timestep t
    on slice ``t % stored`` of ``params`` (the 12 stacked tensors in
    KERNEL_ORDER, ``EncoderParams.stacked()``), with the Universal-Transformer
    transition ``recurrence`` between them (``rec_params`` from
    ``ut_recurrence.init_recurrence_params``).  With ``return_ponder``,
    ``(out, ponder)``: ACT's ponder cost, 0 for the other recurrences."""
    from graph_transformer_tpu_torch.ops import ut_recurrence as ut

    stored = params[0].shape[0]
    T = stored if num_timesteps is None else num_timesteps

    def layer_at(h, t):
        return encoder_layer(h, [a[t % stored] for a in params], num_heads,
                             rate, seed, t, key_mask)

    if recurrence == "act":
        out, ponder = ut.act_encoder(layer_at, x, rec_params, T)
        return (out, ponder) if return_ponder else out
    if recurrence not in ut.KINDS:
        raise ValueError(f"unknown recurrence {recurrence!r}")
    h = x
    cell = torch.zeros_like(x) if recurrence == "lstm" else None
    history = [x.to(torch.float32)]
    for t in range(T):
        out = layer_at(h, t)
        if recurrence == "basic":
            h = out
        elif recurrence == "skip":
            h = out + x
        elif recurrence == "highway":
            h = ut.highway_step(rec_params, h, out)
        elif recurrence == "gru":
            h = ut.gru_step(rec_params, h, out)
        elif recurrence == "lstm":
            h, cell = ut.lstm_step(rec_params, h, cell, out)
        else:  # dwa
            h = ut.dwa_step(rec_params, torch.stack(history), out)
            history.append(h)
    if return_ponder:
        return h, torch.zeros((), dtype=torch.float32, device=x.device)
    return h


def neighborhood_encoder(params: Sequence[torch.Tensor],
                         neigh_feat: torch.Tensor, num_heads: int = 1,
                         rate: float = 0.5, seed: Optional[int] = None,
                         axis: str = "neighborhood",
                         num_timesteps: Optional[int] = None,
                         node_mask: Optional[torch.Tensor] = None,
                         recurrence: str = "basic", rec_params=None,
                         return_ponder: bool = False):
    """The self vectors [N, D] of ``neigh_feat`` [N, K+1, D] through the
    per-layer encoder (``(out, ponder)`` with ``return_ponder``).  ``axis``
    ``neighborhood``: attention over the K+1 slots of each node.  ``node``:
    over the N nodes of each slot column, the PyTorch reference's axis
    (``[N, K+1, D]`` read as ``(S, B, E)``), with the padding nodes of
    ``node_mask`` [N] masked out of every softmax.  Slot 0 is returned
    either way.  (The whole-encoder kernels of basic single-head
    neighborhood-axis encoders are picked by the model.)"""
    if axis == "neighborhood":
        x, key_mask = neigh_feat, None
    elif axis == "node":
        x, key_mask = neigh_feat.transpose(0, 1), node_mask
    else:
        raise ValueError(f"unknown attention axis {axis!r}")
    out, ponder = transformer_encoder(
        params, x, num_heads, rate, seed, num_timesteps, key_mask,
        recurrence, rec_params, return_ponder=True)
    out = out[:, 0] if axis == "neighborhood" else out[0]
    return (out, ponder) if return_ponder else out
