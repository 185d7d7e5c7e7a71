"""Wide-row sampled U2GNN encoder with the stored-residual backward — port
of ``fused_u2gnn_encoder_sampled_stored`` (``graph_transformer_tpu/ops/
pallas_stored_bwd.py:490``): kernels K5 (forward) and K6 (per-layer
backward, with a slot-0 flag for the last layer).

It computes the function of ``ops/sampled_encoder.py`` (K1-K3) with the same
sampler and dropout counters (``ops/random.py``), for the shapes that the
folded TPU kernels do not take: D up to 128 (the one-hot degree tags of IMDB*,
the tags of NCI*) and S up to 32.  The residuals are K1's (layer inputs in the
saved dtype, q/k/v, the attention probabilities, the LayerNorm strip) plus the
FFN hidden after its dropout, ``h``, stored in the saved dtype as kernel 9
does (``pallas_stored_bwd.py:11-17``): the backward neither recomputes the
hidden nor replays its mask, since relu' times the dropout factor is
``(h > 0) / keep`` (``:239``).

:func:`fused_u2gnn_encoder_stored` is the port of the row-input entry
point ``fused_u2gnn_encoder_stored`` (``pallas_stored_bwd.py:284``): kernel
K17 (``_stored_fwd_kernel``, ``:106``) runs K5's layers on given rows
[N·S, D] in bfloat16 or float32, products and the stored hidden in the
rows' dtype (``:167-171``), and K6 (which takes either dtype) walks the
layers back, returning the rows' cotangent as ``_stored_bwd_rule`` does
(``:336-347``).

Dispatch: every public function takes the kernel on CUDA tensors (bfloat16
products for the sampled K5; the rows' dtype for K17 and K6) and the plain
PyTorch version on CPU tensors; the plain versions take ``mm`` (bfloat16 or
float32 products).  :func:`training_encoder` picks
the fused path's encoder from the model's flags and the shape, as
``models/u2gnn_sup.py:138-175`` of the JAX package picks the folded, the
row-space stored or the recompute kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.fused_sampled_encoder import (
    fused_sampled_encoder,
)
from graph_transformer_tpu_torch.ops.random import device_seed, drop_launch
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    _i32,
    _split_grads,
    layer_backward_plain,
    rows_forward_plain,
    sampled_encoder,
    sampled_forward_plain,
    slot0_backward_plain,
    walk_backward,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    MAX_D,
    WIDE_ROWS,
    check_wide_shapes,
)


def folded_shape_ok(S: int, D: int) -> bool:
    """The JAX package's gate of the folded kernels
    (``graph_transformer_tpu/ops/pallas_folded.py:85-90``); the port runs
    K1-K3 where it holds."""
    return S * D <= 128 and S * S * D <= 1024


def training_encoder(S: int, D: int, cfg):
    """The fused path's encoder for neighborhoods of S slots and D features
    under the flags of ``cfg`` (a ``ModelConfig``), as the JAX model picks
    it: ``use_folded`` where the folded gate holds takes K1-K3
    (``sampled_encoder``); ``use_stored_bwd`` or ``use_folded`` otherwise
    takes K5/K6 (:func:`stored_encoder`); neither takes K13 with the
    recompute backward (``fused_sampled_encoder``).  Raises past D = 128 or
    S = 32."""
    check_wide_shapes(S, D)
    if cfg.use_folded and folded_shape_ok(S, D):
        # the folded gate admits D > 32 only at S <= 3, past K1-K3's rows;
        # K5/K6 compute the same stored-residual function there
        return sampled_encoder if D <= MAX_D else stored_encoder
    if cfg.use_stored_bwd or cfg.use_folded:
        return stored_encoder
    return fused_sampled_encoder


# ================================================================= forward
def stored_forward_plain(tag_rows, deg, self_tag, codebook, params,
                         seq_len: int, num_timesteps: int, rate: float,
                         seed: Optional[int], draws=None,
                         mm: torch.dtype = torch.bfloat16):
    """Plain version of K5: ``(out [N, D], res)`` with ``res`` = dict(draws,
    xs, qkv, attn, strip, h), the last five lists of T per-layer tensors
    (``h`` [N, S, F], or [N, F] in the last layer, in the saved dtype)."""
    out, res = sampled_forward_plain(
        tag_rows, deg, self_tag, codebook, params, seq_len, num_timesteps,
        rate, seed, draws, mm, residuals=("qkv", "attn", "strip", "h"))
    save = res["xs"][0].dtype
    res["h"] = [h.to(save) for h in res["h"]]
    return out, res


def stored_forward(tag_rows, deg, self_tag, codebook, params, seq_len: int,
                   num_timesteps: int, rate: float, seed: Optional[int],
                   draws=None, mm: torch.dtype = torch.bfloat16):
    """K5 on CUDA tensors, :func:`stored_forward_plain` on CPU tensors; same
    return value."""
    if not tag_rows.is_cuda:
        return stored_forward_plain(tag_rows, deg, self_tag, codebook, params,
                                    seq_len, num_timesteps, rate, seed, draws,
                                    mm)
    if mm != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bfloat16")
    S, T = seq_len, num_timesteps
    N, W = tag_rows.shape
    C, D = codebook.shape
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
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    Tf = max(T - 1, 0)
    out = torch.empty(N, D, **f32)
    draws_out = torch.empty(N, K, dtype=torch.int32, device=dev)
    xs = torch.empty(T, N, S, D, **bf16)
    qkv = torch.empty(T, N, S, 3 * D, **f32)
    attn_full = torch.empty(Tf, N, S, S, **f32)
    attn_last = torch.empty(N, S, **f32)
    strip_full = torch.empty(Tf, N, S, 4 * D + 2, **f32)
    strip_last = torch.empty(N, 4 * D + 2, **f32)
    h_full = torch.empty(Tf, N, S, F, **bf16)
    h_last = torch.empty(N, F, **bf16)
    if N:
        lib = _build.load("stored_fwd")
        G = _build.pick_groups("stored_fwd", "gt_k5_smem_bytes", S, D,
                               WIDE_ROWS)

        def opt(t):
            return t.data_ptr() if T > 1 else None

        seed = device_seed(seed, dev)
        err = lib.gt_k5_stored_fwd(
            tag_rows.data_ptr(), W, deg.data_ptr(), self_tag.data_ptr(),
            codebook.data_ptr(),
            None if draws_in is None else draws_in.data_ptr(),
            draws_out.data_ptr(), _build.params_array(ps), ps[0].shape[0],
            out.data_ptr(), xs.data_ptr(), qkv.data_ptr(), opt(attn_full),
            attn_last.data_ptr(), opt(strip_full), strip_last.data_ptr(),
            opt(h_full), h_last.data_ptr(), N, S, D, F, T, G,
            1.0 / math.sqrt(D), *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, "K5 stored_fwd")
        stored_forward.launches += 1
    res = dict(draws=draws_out.to(torch.int64), xs=list(xs.unbind(0)),
               qkv=list(qkv.unbind(0)),
               attn=list(attn_full.unbind(0)) + [attn_last],
               strip=list(strip_full.unbind(0)) + [strip_last],
               h=list(h_full.unbind(0)) + [h_last])
    return out, res


stored_forward.launches = 0


def stored_rows_forward_plain(x2d, params, seq_len: int, num_timesteps: int,
                              rate: float, seed: Optional[int]):
    """Plain version of K17: ``(out [N, D] float32, res)`` with ``res`` =
    dict(xs, qkv, attn, strip, h) as :func:`stored_forward_plain` gives it,
    the layer inputs (``xs[0]`` = the rows) and ``h`` in the rows' dtype,
    products in that dtype."""
    D = x2d.shape[1]
    mm = torch.bfloat16 if x2d.dtype == torch.bfloat16 else torch.float32
    out, res = rows_forward_plain(
        x2d.to(torch.float32).view(-1, seq_len, D), params, num_timesteps,
        rate, seed, mm, x2d.dtype, residuals=("qkv", "attn", "strip", "h"))
    res["h"] = [h.to(x2d.dtype) for h in res["h"]]
    return out, res


def stored_rows_forward(x2d, params, seq_len: int, num_timesteps: int,
                        rate: float, seed: Optional[int]):
    """K17 on CUDA tensors, :func:`stored_rows_forward_plain` on CPU
    tensors; same return value.  Rows [N·S, D] in bfloat16 or float32."""
    if not x2d.is_cuda:
        return stored_rows_forward_plain(x2d, params, seq_len, num_timesteps,
                                         rate, seed)
    S, T = seq_len, num_timesteps
    N, D = x2d.shape[0] // S, x2d.shape[1]
    F = params[6].shape[2]
    check_wide_shapes(S, D)
    _build.check_rows_dtype(x2d)
    dev, dt = x2d.device, x2d.dtype
    x = x2d.contiguous()
    ps = _build.f32_params(params)
    f32 = dict(dtype=torch.float32, device=dev)
    rows = dict(dtype=dt, device=dev)
    Tf = max(T - 1, 0)
    out = torch.empty(N, D, **f32)
    xs = torch.empty(Tf, N, S, D, **rows)
    qkv = torch.empty(T, N, S, 3 * D, **f32)
    attn_full = torch.empty(Tf, N, S, S, **f32)
    attn_last = torch.empty(N, S, **f32)
    strip_full = torch.empty(Tf, N, S, 4 * D + 2, **f32)
    strip_last = torch.empty(N, 4 * D + 2, **f32)
    h_full = torch.empty(Tf, N, S, F, **rows)
    h_last = torch.empty(N, F, **rows)
    if N:
        lib = _build.load("stored_fwd")
        # a thread per row up to D = 32 (K1's layer), a warp per row past it
        G = (_build.pick_fwd_groups("stored_fwd", "gt_k17_smem_bytes", S, D,
                                    N) if D <= 32 else
             _build.pick_groups("stored_fwd", "gt_k17_smem_bytes", S, D,
                                WIDE_ROWS))

        def opt(t):
            return t.data_ptr() if T > 1 else None

        seed = device_seed(seed, dev)
        err = lib.gt_k17_stored_rows_fwd(
            x.data_ptr(), int(dt == torch.bfloat16), _build.params_array(ps),
            ps[0].shape[0], out.data_ptr(), opt(xs), qkv.data_ptr(),
            opt(attn_full), attn_last.data_ptr(), opt(strip_full),
            strip_last.data_ptr(), opt(h_full), h_last.data_ptr(), N, S, D, F,
            T, G, 1.0 / math.sqrt(D), *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, "K17 stored_rows_fwd")
        stored_rows_forward.launches += 1
    res = dict(xs=[x.view(N, S, D)] + list(xs.unbind(0)),
               qkv=list(qkv.unbind(0)),
               attn=list(attn_full.unbind(0)) + [attn_last],
               strip=list(strip_full.unbind(0)) + [strip_last],
               h=list(h_full.unbind(0)) + [h_last])
    return out, res


stored_rows_forward.launches = 0


# ================================================================ backward
def stored_layer_backward_plain(x, qkv, attn, strip, h, g, p, *, layer: int,
                                rate: float, seed: Optional[int],
                                mm: torch.dtype = torch.bfloat16,
                                slot0: bool = False):
    """Plain version of K6: the backward of layer ``layer`` from K5's
    residuals, its FFN from the stored hidden ``h``.  Full layer (``slot0``
    False): attn [N,S,S], strip [N,S,4D+2], h [N,S,F], g [N,S,D]; slot-0
    last layer: attn [N,S], strip [N,4D+2], h [N,F], g [N,D].  ``p``: the
    layer's 12 tensors.  Returns (dx [N,S,D], 12 grads in KERNEL_ORDER)."""
    bwd = slot0_backward_plain if slot0 else layer_backward_plain
    return bwd(x, qkv, attn, strip, g, p, layer=layer, rate=rate, seed=seed,
               mm=mm, h=h)


def _bwd_kernel(fn_name, x, qkv, attn, strip, h, g, params, layer, rate,
                seed, slot0):
    N, S, D = x.shape
    F = params[6].shape[2]
    check_wide_shapes(S, D)
    dev = x.device
    _build.check_rows_dtype(x)
    if h.dtype != x.dtype:
        raise TypeError(f"K6 takes the hidden in the rows' dtype {x.dtype}, "
                        f"not {h.dtype}")
    bf = int(x.dtype == torch.bfloat16)
    ps = _build.f32_params(params)
    dx = torch.empty(N, S, D, dtype=torch.float32, device=dev)
    P = sum(math.prod(p.shape[1:]) for p in ps)
    grads = torch.zeros(P, dtype=torch.float32, device=dev)
    if N:
        lib = _build.load("stored_bwd")
        smem_fn = "gt_k6s_smem_bytes" if slot0 else "gt_k6_smem_bytes"
        G = _build.pick_groups("stored_bwd", smem_fn, S, D, WIDE_ROWS)
        work = torch.empty(lib.gt_k6_work_bytes(N, S, D, F, G, int(slot0),
                                                bf),
                           dtype=torch.uint8, device=dev)
        seed = device_seed(seed, dev)
        err = getattr(lib, fn_name)(
            x.contiguous().data_ptr(), bf, qkv.contiguous().data_ptr(),
            attn.contiguous().data_ptr(), strip.contiguous().data_ptr(),
            h.contiguous().data_ptr(),
            g.to(torch.float32).contiguous().data_ptr(),
            _build.params_array(ps), ps[0].shape[0], layer, dx.data_ptr(),
            work.data_ptr(), grads.data_ptr(), N, S, D, F, G,
            1.0 / math.sqrt(D), *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, fn_name)
    return dx, _split_grads(grads, D, F)


def stored_layer_backward(x, qkv, attn, strip, h, g, params, layer: int,
                          rate: float, seed: Optional[int],
                          mm: torch.dtype = torch.bfloat16):
    """K6 (full layer) on CUDA tensors, :func:`stored_layer_backward_plain`
    on CPU tensors.  ``params``: the 12 stacked tensors (the layer uses
    slice ``layer % stored``)."""
    if not x.is_cuda:
        p = [a[layer % a.shape[0]] for a in params]
        return stored_layer_backward_plain(x, qkv, attn, strip, h,
                                           g.view_as(x), p, layer=layer,
                                           rate=rate, seed=seed, mm=mm)
    out = _bwd_kernel("gt_k6_layer_bwd", x, qkv, attn, strip, h, g, params,
                      layer, rate, seed, False)
    stored_layer_backward.launches += 1
    return out


stored_layer_backward.launches = 0


def stored_slot0_backward(x, qkv, attn0, strip0, h0, g, params, layer: int,
                          rate: float, seed: Optional[int],
                          mm: torch.dtype = torch.bfloat16):
    """K6 (slot-0 last layer) on CUDA tensors, the plain version on CPU
    tensors."""
    if not x.is_cuda:
        p = [a[layer % a.shape[0]] for a in params]
        return stored_layer_backward_plain(x, qkv, attn0, strip0, h0, g, p,
                                           layer=layer, rate=rate, seed=seed,
                                           mm=mm, slot0=True)
    out = _bwd_kernel("gt_k6_slot0_bwd", x, qkv, attn0, strip0, h0, g,
                      params, layer, rate, seed, True)
    stored_slot0_backward.launches += 1
    return out


stored_slot0_backward.launches = 0


def stored_encoder_backward(res, dout, params, num_timesteps: int,
                            rate: float, seed: Optional[int],
                            mm: torch.dtype = torch.bfloat16):
    """The backward from K5's (or K17's) residuals (``_stored_bwd_core``,
    ``pallas_stored_bwd.py:303-333``): K6 with the slot-0 flag for the last
    layer, K6 for the others.  Returns (the encoder input's cotangent
    [N, S, D] float32, the 12 stacked parameter gradients)."""
    T = num_timesteps

    def layer_bwd(t, g):
        bwd = stored_slot0_backward if t == T - 1 else stored_layer_backward
        return bwd(res["xs"][t], res["qkv"][t], res["attn"][t],
                   res["strip"][t], res["h"][t], g, params, t, rate, seed, mm)

    return walk_backward(dout, params, T, layer_bwd)


class StoredEncoderFn(torch.autograd.Function):
    """Differentiable in the 12 parameters; the integer inputs, the codebook
    and the seed get no gradient (the JAX rule gives the codebook zeros)."""

    @staticmethod
    def forward(ctx, tag_rows, deg, self_tag, codebook, draws, seed, S, T,
                rate, mm, *params):
        out, res = stored_forward(tag_rows, deg, self_tag, codebook, params,
                                  S, T, rate, seed, draws, mm)
        ctx.res = res
        ctx.cfg = (T, rate, seed, mm)
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, dout):
        params = ctx.saved_tensors
        T, rate, seed, mm = ctx.cfg
        dparams = stored_encoder_backward(ctx.res, dout, params, T, rate,
                                          seed, mm)[1]
        ctx.res = None
        return (None,) * 10 + tuple(dparams)


def stored_encoder(tag_rows, deg, self_tag, codebook,
                   params: Sequence[torch.Tensor], seq_len: int,
                   num_timesteps: int, rate: float = 0.5,
                   seed: Optional[int] = None, draws=None,
                   mm: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N] rows -> [N, D] float32, differentiable in ``params``: the same
    contract as ``sampled_encoder.sampled_encoder`` (12 stacked tensors in
    KERNEL_ORDER, tag rows [N, 128], ``draws`` made outside or None)."""
    seed = device_seed(seed, tag_rows.device)
    return StoredEncoderFn.apply(tag_rows, deg, self_tag, codebook, draws,
                                 seed, seq_len, num_timesteps, rate, mm,
                                 *params)


class StoredRowsEncoderFn(torch.autograd.Function):
    """Differentiable in the rows and the 12 parameters; the seed gets no
    gradient."""

    @staticmethod
    def forward(ctx, x2d, seed, S, T, rate, *params):
        out, res = stored_rows_forward(x2d, params, S, T, rate, seed)
        ctx.res = res
        ctx.cfg = (T, rate, seed)
        ctx.save_for_backward(*params)
        ctx.x_shape = x2d.shape
        return out

    @staticmethod
    def backward(ctx, dout):
        params = ctx.saved_tensors
        T, rate, seed = ctx.cfg
        dt = ctx.res["xs"][0].dtype
        mm = torch.bfloat16 if dt == torch.bfloat16 else torch.float32
        dx, dparams = stored_encoder_backward(ctx.res, dout, params, T, rate,
                                              seed, mm)
        ctx.res = None
        dx = dx.reshape(ctx.x_shape).to(dt) if ctx.needs_input_grad[0] \
            else None
        return (dx, None, None, None, None, *dparams)


def fused_u2gnn_encoder_stored(x2d: torch.Tensor,
                               params: Sequence[torch.Tensor], seq_len: int,
                               num_timesteps: int, rate: float = 0.0,
                               seed: Optional[int] = None) -> torch.Tensor:
    """[N·S, D] rows (bfloat16 or float32) -> [N, D] float32 (slot 0 of the
    last layer), differentiable in ``x2d`` and the 12 stacked ``params``:
    K17 forward, K6 (slot 0), then K6 per earlier layer backward, products
    in the rows' dtype.  The contract of ``u2gnn_train.u2gnn_train_encoder``
    with the stored-residual backward."""
    seed = device_seed(seed, x2d.device)
    return StoredRowsEncoderFn.apply(x2d, seed, seq_len, num_timesteps, rate,
                                     *params)
