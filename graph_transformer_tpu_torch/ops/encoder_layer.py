"""One encoder layer over neighborhood rows — port of ``fused_encoder_layer``
(``graph_transformer_tpu/ops/pallas_encoder.py``): kernels K9 (forward,
``pallas_encoder.py:196``) and K10 (recompute backward, ``:214``) for
D <= 32, K9w and K10w (a warp per row) for 32 < D <= 128,
``ops/csrc/encoder_layer.cu``.

``fused_encoder_layer(x2d [N·S, D], 12 tensors, seed, S, rate, layer)`` runs
one post-norm layer (``ops/attention.layer_forward`` as a full layer:
attention within each node's S rows) and returns every row, in ``x2d``'s
dtype.  The per-layer encoder (``ops/attention.encoder_layer``) runs it once
per timestep for single-head, unmasked layers: the Universal-Transformer
recurrences, and the tied timesteps between them.  Products take operands in
``x2d``'s dtype and accumulate in float32; dropout draws the four sites of
timestep ``layer`` from ``seed`` (``ops/random.py``).  The backward
recomputes the layer from ``x2d`` and returns dx in ``x2d``'s dtype and the
12 gradients, as the TPU kernel does; ``dout`` is taken in ``x2d``'s dtype.

Dispatch: on CUDA tensors K9/K10 or K9w/K10w (a launch counter each), past
D = 128 the layer as kernels K18-K20 (``ops/rows_encoder.layer_rows_forward``
and ``layer_rows_backward``); on CPU tensors the plain versions
(``layer_forward`` and ``layer_recompute_backward_plain``).  S <= 32 either
way: more slots raise naming ROADMAP Queue A's item "Rows past D=128 or
S=32" (item 6).  The TPU kernel's dense [R, R] block-masked attention is a
TPU layout and is not carried over.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import layer_forward
from graph_transformer_tpu_torch.ops.random import drop_args
from graph_transformer_tpu_torch.ops.rows_encoder import (
    layer_rows_backward,
    layer_rows_forward,
)
from graph_transformer_tpu_torch.ops.sampled_encoder import _split_grads
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    MAX_D,
    MAX_S,
    WIDE_MAX_D,
    WIDE_ROWS,
    check_wide_shapes,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import (
    _mm,
    layer_recompute_backward_plain,
)


def check_layer_shapes(S: int, D: int) -> None:
    """S <= 32 at any D: K9/K10 (K9w/K10w past D = 32, K18-K20 past
    D = 128)."""
    if S > MAX_S:
        raise NotImplementedError(
            f"S={S}, D={D}: the encoder-layer kernels K9/K10 (K9w/K10w past "
            f"D={MAX_D}, K18-K20 past D={WIDE_MAX_D}) take S <= {MAX_S} "
            "(ROADMAP.md Queue A, 'Rows past D=128 or S=32', item 6)")


def _split(x2d, S):
    if x2d.shape[0] % S:
        raise ValueError("x2d rows must be a multiple of seq_len")
    N, D = x2d.shape[0] // S, x2d.shape[1]
    check_layer_shapes(S, D)
    return N, D


def encoder_layer_forward_plain(x2d, params: Sequence[torch.Tensor], S: int,
                                rate: float = 0.0, seed: Optional[int] = None,
                                layer: int = 0) -> torch.Tensor:
    """Plain version of K9: every row out, in ``x2d``'s dtype."""
    N, D = x2d.shape[0] // S, x2d.shape[1]
    p = [a.to(torch.float32) for a in params]
    out, _ = layer_forward(x2d.to(torch.float32).view(N, S, D), p,
                           layer=layer, rate=rate, seed=seed,
                           mm=_mm(x2d.dtype), slot0=False)
    return out.reshape(N * S, D).to(x2d.dtype)


def encoder_layer_backward_plain(x2d, dout, params: Sequence[torch.Tensor],
                                 S: int, rate: float = 0.0,
                                 seed: Optional[int] = None, layer: int = 0):
    """Plain version of K10: ``(dx [N·S, D] in x2d's dtype, 12 grads in
    KERNEL_ORDER)``."""
    N, D = x2d.shape[0] // S, x2d.shape[1]
    g = dout.to(x2d.dtype).to(torch.float32).view(N, S, D)
    dx, grads = layer_recompute_backward_plain(
        x2d.view(N, S, D), g, [a.to(torch.float32) for a in params],
        layer=layer, rate=rate, seed=seed, mm=_mm(x2d.dtype), slot0=False)
    return dx.reshape(N * S, D).to(x2d.dtype), grads


def encoder_layer_forward(x2d, params: Sequence[torch.Tensor], S: int,
                          rate: float = 0.0, seed: Optional[int] = None,
                          layer: int = 0) -> torch.Tensor:
    """K9 on CUDA tensors (D <= 32; K9w past, K18-K20 past D = 128),
    :func:`encoder_layer_forward_plain` on CPU tensors.  ``params``: one
    layer's 12 tensors in KERNEL_ORDER."""
    N, D = _split(x2d, S)
    if not x2d.is_cuda:
        return encoder_layer_forward_plain(x2d, params, S, rate, seed, layer)
    if D > WIDE_MAX_D:
        return layer_rows_forward(x2d, params, S, rate, seed, layer)
    if D > MAX_D:
        return wide_encoder_layer_forward(x2d, params, S, rate, seed, layer)
    return _forward(x2d, params, S, rate, seed, layer, False)


def wide_encoder_layer_forward(x2d, params: Sequence[torch.Tensor], S: int,
                               rate: float = 0.0, seed: Optional[int] = None,
                               layer: int = 0) -> torch.Tensor:
    """K9w (D <= 128) on CUDA tensors, the plain version on CPU tensors;
    the contract of :func:`encoder_layer_forward`."""
    _split(x2d, S)
    if not x2d.is_cuda:
        return encoder_layer_forward_plain(x2d, params, S, rate, seed, layer)
    return _forward(x2d, params, S, rate, seed, layer, True)


def _forward(x2d, params, S, rate, seed, layer, wide):
    N, D = _split(x2d, S)
    check_wide_shapes(S, D)
    _build.check_rows_dtype(x2d)
    x2d = x2d.contiguous()
    ps = _build.f32_params(params)
    out = torch.empty_like(x2d)
    if N:
        fn = "gt_k9w_layer_fwd" if wide else "gt_k9_layer_fwd"
        G = (_build.pick_groups("encoder_layer", "gt_k9w_smem_bytes", S, D,
                                WIDE_ROWS) if wide else
             _build.pick_fwd_groups("encoder_layer", "gt_k9_smem_bytes", S, D,
                                    N))
        err = getattr(_build.load("encoder_layer"), fn)(
            x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), out.data_ptr(),
            _build.params_array(ps), layer, N, S, D, ps[6].shape[1], G,
            1.0 / math.sqrt(D), *drop_args(rate, seed),
            _build.stream_ptr(x2d.device))
        _build.check(err, fn)
        (wide_encoder_layer_forward if wide
         else encoder_layer_forward).launches += 1
    return out


encoder_layer_forward.launches = 0
wide_encoder_layer_forward.launches = 0


def encoder_layer_backward(x2d, dout, params: Sequence[torch.Tensor], S: int,
                           rate: float = 0.0, seed: Optional[int] = None,
                           layer: int = 0):
    """K10 on CUDA tensors (D <= 32; K10w past, K18-K20 past D = 128),
    :func:`encoder_layer_backward_plain` on CPU tensors; same return
    value."""
    N, D = _split(x2d, S)
    if not x2d.is_cuda:
        return encoder_layer_backward_plain(x2d, dout, params, S, rate, seed,
                                            layer)
    if D > WIDE_MAX_D:
        return layer_rows_backward(x2d, dout, params, S, rate, seed, layer)
    if D > MAX_D:
        return wide_encoder_layer_backward(x2d, dout, params, S, rate, seed,
                                           layer)
    return _backward(x2d, dout, params, S, rate, seed, layer, False)


def wide_encoder_layer_backward(x2d, dout, params: Sequence[torch.Tensor],
                                S: int, rate: float = 0.0,
                                seed: Optional[int] = None, layer: int = 0):
    """K10w (D <= 128) on CUDA tensors, the plain version on CPU tensors;
    the contract of :func:`encoder_layer_backward`."""
    _split(x2d, S)
    if not x2d.is_cuda:
        return encoder_layer_backward_plain(x2d, dout, params, S, rate, seed,
                                            layer)
    return _backward(x2d, dout, params, S, rate, seed, layer, True)


def _backward(x2d, dout, params, S, rate, seed, layer, wide):
    N, D = _split(x2d, S)
    check_wide_shapes(S, D)
    _build.check_rows_dtype(x2d)
    x2d = x2d.contiguous()
    ps = _build.f32_params(params)
    F = ps[6].shape[1]
    f32 = dict(dtype=torch.float32, device=x2d.device)
    dx = torch.empty(N * S, D, **f32)
    P = sum(p.numel() for p in ps)
    grads = torch.zeros(P, **f32)
    if N:
        lib = _build.load("encoder_layer")
        bf = int(x2d.dtype == torch.bfloat16)
        if wide:
            fn = "gt_k10w_layer_bwd"
            G = _build.pick_groups("encoder_layer", "gt_k10w_smem_bytes", S,
                                   D, WIDE_ROWS)
            scratch = [torch.empty(
                lib.gt_k10w_work_bytes(N, S, D, F, G, 0, bf),
                dtype=torch.uint8, device=x2d.device)]
        else:
            fn = "gt_k10_layer_bwd"
            G = _build.pick_groups("encoder_layer", "gt_k10_smem_bytes", S,
                                   D, n=N)
            scratch = [torch.empty(*shape, **f32) for shape in (
                (N * S, 3 * D), (N * S, S), (N * S, 4 * D + 2),
                ((N + G - 1) // G, P))]
        g = dout.to(x2d.dtype).to(torch.float32).contiguous()
        err = getattr(lib, fn)(
            x2d.data_ptr(), bf, g.data_ptr(), _build.params_array(ps), layer,
            dx.data_ptr(), *(t.data_ptr() for t in scratch), grads.data_ptr(),
            N, S, D, F, G, 1.0 / math.sqrt(D), *drop_args(rate, seed),
            _build.stream_ptr(x2d.device))
        _build.check(err, fn)
        (wide_encoder_layer_backward if wide
         else encoder_layer_backward).launches += 1
    return dx.to(x2d.dtype), _split_grads(grads, D, F)


encoder_layer_backward.launches = 0
wide_encoder_layer_backward.launches = 0


class EncoderLayerFn(torch.autograd.Function):
    """Differentiable in the rows and the 12 tensors; the seed gets none."""

    @staticmethod
    def forward(ctx, x2d, seed, S, rate, layer, *params):
        ctx.cfg = (seed, S, rate, layer)
        ctx.save_for_backward(x2d, *params)
        return encoder_layer_forward(x2d, params, S, rate, seed, layer)

    @staticmethod
    def backward(ctx, dout):
        x2d, *params = ctx.saved_tensors
        seed, S, rate, layer = ctx.cfg
        dx, grads = encoder_layer_backward(x2d, dout, params, S, rate, seed,
                                           layer)
        return (dx, None, None, None, None,
                *(g.to(p.dtype) for g, p in zip(grads, params)))


def fused_encoder_layer(x2d: torch.Tensor, w_in, b_in, w_out, b_out, ln1g,
                        ln1b, w1, b1, w2, b2, ln2g, ln2b,
                        seed: Optional[int], seq_len: int, rate: float = 0.0,
                        layer: int = 0) -> torch.Tensor:
    """One encoder layer over node-major rows ``x2d [N·S, D]`` (S =
    ``seq_len``), the 12 tensors in the JAX call's order (KERNEL_ORDER),
    dropout from ``seed`` at timestep ``layer``'s streams; every row out, in
    ``x2d``'s dtype, differentiable in ``x2d`` and the tensors."""
    return EncoderLayerFn.apply(x2d, seed, seq_len, rate, layer, w_in, b_in,
                                w_out, b_out, ln1g, ln1b, w1, b1, w2, b2,
                                ln2g, ln2b)
