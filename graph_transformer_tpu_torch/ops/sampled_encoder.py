"""Sampled U2GNN encoder with its stored-residual backward — port of
``folded_u2gnn_encoder_sampled`` (``graph_transformer_tpu/ops/
pallas_folded.py:1257``): kernels K1 (forward), K2 (full-layer backward) and
K3 (slot-0 last-layer backward).

Per node n: draw K = S-1 neighbor slots uniformly from the first
min(deg, 128) entries of its tag row, gather the slots' tags
``[self_tag, draws...]``, build x0 = bf16(codebook[tags]) and run T post-norm
encoder layers, the last for slot 0 only.  Output [N, D] float32.

The forward keeps, per layer, the layer input (in the compute dtype), q/k/v,
the attention probabilities and the LayerNorm strip [ctx, y1, uhat1, uhat2,
rstd1, rstd2]; the backward recomputes the FFN hidden from y1 and replays
the dropout masks from the same counters (``ops/random.py``), so nothing of
size [rows, F] is stored.  Timestep t uses parameter slice ``t % stored``.

The TPU kernels' folded [G, S·D] lanes, 0/1 selector matrices and 128-lane
gather limit are TPU devices and are not carried over: the Hopper kernels
work on rows (one thread per slot, a block per group of neighborhoods).

Dispatch: every public function takes the kernel on CUDA tensors (bfloat16
products) and the plain PyTorch version on CPU tensors.  The plain versions
take ``mm`` (bfloat16 or float32 products) so that the CPU tests can hold the
explicit backward against ``torch.autograd`` in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import (
    dropout,
    layer_forward,
    rnd,
)
from graph_transformer_tpu_torch.ops.random import (
    device_seed,
    drop_launch,
    uniform_draws,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import _check_shapes

TABLE_WIDTH = 128


# ================================================================= forward
def sampled_forward_plain(tag_rows, deg, self_tag, codebook, params,
                          seq_len: int, num_timesteps: int, rate: float,
                          seed: Optional[int], draws=None,
                          mm: torch.dtype = torch.bfloat16,
                          residuals=("qkv", "attn", "strip")):
    """Plain version of K1: returns ``(out [N, D], res)`` with ``res`` =
    dict(draws [N, K], xs, and each of ``residuals``), lists of T per-layer
    tensors (``xs`` in the saved dtype, the rest as ``layer_forward`` gives
    them)."""
    S, T = seq_len, num_timesteps
    N = tag_rows.shape[0]
    K = S - 1
    if draws is None:
        draws = uniform_draws(seed, N, K, deg.reshape(-1), TABLE_WIDTH)
    draws = draws.to(torch.int64)
    tags = torch.cat([self_tag.reshape(N, 1).to(torch.int64),
                      tag_rows.to(torch.int64).gather(1, draws)], dim=1)
    h = codebook.to(torch.float32)[tags].to(torch.bfloat16).to(torch.float32)
    save = torch.bfloat16 if mm == torch.bfloat16 else torch.float32
    out, res = rows_forward_plain(h, params, T, rate, seed, mm, save,
                                  residuals)
    return out, dict(draws=draws, **res)


def rows_forward_plain(h, params, num_timesteps: int, rate: float,
                       seed: Optional[int], mm: torch.dtype,
                       save: torch.dtype, residuals=("qkv", "attn", "strip")):
    """T encoder layers over rows h [N, S, D] (float32 values), products in
    ``mm``, the last for slot 0 only: ``(out [N, D], res)`` with ``res`` =
    dict(xs, and each of ``residuals``), lists of T per-layer tensors, the
    layer inputs ``xs`` in ``save``."""
    T = num_timesteps
    stored = params[0].shape[0]
    res = dict(xs=[], **{k: [] for k in residuals})
    for t in range(T):
        res["xs"].append(h.to(save))
        p = [a[t % stored] for a in params]
        h, r = layer_forward(h, p, layer=t, rate=rate, seed=seed, mm=mm,
                             slot0=(t == T - 1))
        for k in residuals:
            res[k].append(r[k])
    return h, res


def _i32(a: torch.Tensor, shape) -> torch.Tensor:
    return a.to(torch.int32).reshape(shape).contiguous()


def sampled_forward(tag_rows, deg, self_tag, codebook, params, seq_len: int,
                    num_timesteps: int, rate: float, seed: Optional[int],
                    draws=None, mm: torch.dtype = torch.bfloat16):
    """K1 on CUDA tensors, :func:`sampled_forward_plain` on CPU tensors;
    same return value."""
    if not tag_rows.is_cuda:
        return sampled_forward_plain(tag_rows, deg, self_tag, codebook,
                                     params, seq_len, num_timesteps, rate,
                                     seed, draws, mm)
    if mm != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bfloat16")
    S, T = seq_len, num_timesteps
    N, W = tag_rows.shape
    C, D = codebook.shape
    F = params[6].shape[2]
    K = S - 1
    _check_shapes(S, D)
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
    out = torch.empty(N, D, **f32)
    draws_out = torch.empty(N, K, dtype=torch.int32, device=dev)
    xs = torch.empty(T, N, S, D, dtype=torch.bfloat16, device=dev)
    qkv = torch.empty(T, N, S, 3 * D, **f32)
    attn_full = torch.empty(max(T - 1, 0), N, S, S, **f32)
    attn_last = torch.empty(N, S, **f32)
    strip_full = torch.empty(max(T - 1, 0), N, S, 4 * D + 2, **f32)
    strip_last = torch.empty(N, 4 * D + 2, **f32)
    if N:
        lib = _build.load("sampled_fwd")
        G = _build.pick_fwd_groups("sampled_fwd", "gt_k1_smem_bytes", S,
                                   D, N)
        seed = device_seed(seed, dev)
        err = lib.gt_k1_sampled_fwd(
            tag_rows.data_ptr(), W, deg.data_ptr(), self_tag.data_ptr(),
            codebook.data_ptr(),
            None if draws_in is None else draws_in.data_ptr(),
            draws_out.data_ptr(), _build.params_array(ps), ps[0].shape[0],
            out.data_ptr(), xs.data_ptr(), qkv.data_ptr(),
            attn_full.data_ptr() if T > 1 else None, attn_last.data_ptr(),
            strip_full.data_ptr() if T > 1 else None, strip_last.data_ptr(),
            N, S, D, F, T, G, 1.0 / math.sqrt(D),
            *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, "K1 sampled_fwd")
        sampled_forward.launches += 1
    res = dict(draws=draws_out.to(torch.int64), xs=list(xs.unbind(0)),
               qkv=list(qkv.unbind(0)),
               attn=list(attn_full.unbind(0)) + [attn_last],
               strip=list(strip_full.unbind(0)) + [strip_last])
    return out, res


sampled_forward.launches = 0


# ================================================================ backward
def _ln_bwd(dout, uhat, rstd, g):
    gg = dout * g
    return (gg - gg.mean(-1, keepdim=True)
            - uhat * (gg * uhat).mean(-1, keepdim=True)) * rstd


def _split_strip(strip, D):
    return (strip[..., :D], strip[..., D:2 * D], strip[..., 2 * D:3 * D],
            strip[..., 3 * D:4 * D], strip[..., 4 * D:4 * D + 1],
            strip[..., 4 * D + 1:4 * D + 2])


def _rows(a, w):
    return a.reshape(-1, w)


def _ffn_bwd(y1, dz, du2, p, drop_h, mm, h=None, keep=1.0):
    """FFN backward: dy1 and (dw1, db1, dw2).  The hidden recomputes from
    y1, or comes stored (``h``, as the forward rounded it); a stored hidden
    gives the relu'·dropout factor exactly as ``(h > 0) / keep``."""
    (_, _, _, _, _, _, w1, b1, w2, _, _, _) = p
    D, F = w1.shape
    if h is None:
        hpre = rnd(y1, mm) @ rnd(w1, mm) + b1
        fac = drop_h((hpre > 0).to(torch.float32))
        h = rnd(hpre * fac, mm)
    else:
        h = h.to(torch.float32)
        fac = (h > 0).to(torch.float32) / keep
    dhpre = (rnd(dz, mm) @ rnd(w2, mm).T) * fac
    dy1 = du2 + rnd(dhpre, mm) @ rnd(w1, mm).T
    dw1 = _rows(rnd(y1, mm), D).T @ _rows(rnd(dhpre, mm), F)
    db1 = _rows(dhpre, F).sum(0)
    dw2 = _rows(h, F).T @ _rows(rnd(dz, mm), D)
    return dy1, dw1, db1, dw2


def _dropper(rate, seed, layer):
    """site -> the dropout of that site of layer ``layer``."""
    return lambda site: (lambda v: dropout(v, rate, seed, layer, site))


def layer_backward_plain(x, qkv, attn, strip, g, p, *, layer: int,
                         rate: float, seed: Optional[int],
                         mm: torch.dtype = torch.bfloat16, h=None):
    """Plain version of K2: backward of full layer ``layer`` from its
    residuals.  x [N,S,D] (saved input), qkv [N,S,3D], attn [N,S,S], strip
    [N,S,4D+2], g [N,S,D]; ``h`` [N,S,F], the stored FFN hidden, or None to
    recompute it.  Returns (dx [N,S,D], 12 grads in KERNEL_ORDER)."""
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    N, S, D = g.shape
    drop = _dropper(rate, seed, layer)
    x = x.to(torch.float32)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    ctx, y1, uh1, uh2, rs1, rs2 = _split_strip(strip, D)
    du2 = _ln_bwd(g, uh2, rs2, g2)
    dz = drop(3)(du2)
    dy1, dw1, db1, dw2 = _ffn_bwd(y1, dz, du2, p, drop(2), mm, h, 1.0 - rate)
    du1 = _ln_bwd(dy1, uh1, rs1, g1)
    da = drop(1)(du1)
    dctx = rnd(da, mm) @ rnd(w_out, mm).T
    attn_d = drop(0)(attn)
    dattn = drop(0)(rnd(dctx, mm) @ rnd(v, mm).transpose(1, 2))
    ds = attn * (dattn - (dattn * attn).sum(-1, keepdim=True)) \
        * (1.0 / math.sqrt(D))
    dq = rnd(ds, mm) @ rnd(k, mm)
    dk = rnd(ds, mm).transpose(1, 2) @ rnd(q, mm)
    dv = rnd(attn_d, mm).transpose(1, 2) @ rnd(dctx, mm)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    dx = du1 + rnd(dqkv, mm) @ rnd(w_in, mm).T
    grads = (
        _rows(rnd(x, mm), D).T @ _rows(rnd(dqkv, mm), 3 * D),
        _rows(dqkv, 3 * D).sum(0),
        _rows(rnd(ctx, mm), D).T @ _rows(rnd(da, mm), D),
        _rows(da, D).sum(0),
        _rows(dy1 * uh1, D).sum(0), _rows(dy1, D).sum(0),
        dw1, db1, dw2,
        _rows(dz, D).sum(0), _rows(g * uh2, D).sum(0), _rows(g, D).sum(0),
    )
    return dx, grads


def slot0_backward_plain(x, qkv, attn0, strip0, g, p, *, layer: int,
                         rate: float, seed: Optional[int],
                         mm: torch.dtype = torch.bfloat16, h=None):
    """Plain version of K3: backward of the slot-0 last layer.  x [N,S,D],
    qkv [N,S,3D], attn0 [N,S], strip0 [N,4D+2], g [N,D]; ``h`` [N,F] or
    None, as for :func:`layer_backward_plain`.  Returns (dx [N,S,D], 12
    grads in KERNEL_ORDER)."""
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    N, S, _ = x.shape
    D = g.shape[1]
    drop = _dropper(rate, seed, layer)
    x = x.to(torch.float32)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    ctx, y1, uh1, uh2, rs1, rs2 = _split_strip(strip0, D)
    du2 = _ln_bwd(g, uh2, rs2, g2)
    dz = drop(3)(du2)
    dy1, dw1, db1, dw2 = _ffn_bwd(y1, dz, du2, p, drop(2), mm, h, 1.0 - rate)
    du1 = _ln_bwd(dy1, uh1, rs1, g1)
    da = drop(1)(du1)
    dctx = rnd(da, mm) @ rnd(w_out, mm).T  # [N, D]
    attn_d = drop(0)(attn0)
    dattn = drop(0)((rnd(v, mm) @ rnd(dctx, mm)[:, :, None])[..., 0])
    ds = attn0 * (dattn - (dattn * attn0).sum(-1, keepdim=True)) \
        * (1.0 / math.sqrt(D))
    dq = torch.zeros_like(q)
    dq[:, 0] = (rnd(ds, mm)[:, None, :] @ rnd(k, mm))[:, 0]
    dk = rnd(ds, mm)[:, :, None] * rnd(q[:, 0], mm)[:, None, :]
    dv = rnd(attn_d, mm)[:, :, None] * rnd(dctx, mm)[:, None, :]
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    dx = rnd(dqkv, mm) @ rnd(w_in, mm).T
    dx[:, 0] = dx[:, 0] + du1
    grads = (
        _rows(rnd(x, mm), D).T @ _rows(rnd(dqkv, mm), 3 * D),
        _rows(dqkv, 3 * D).sum(0),
        rnd(ctx, mm).T @ rnd(da, mm),
        da.sum(0),
        (dy1 * uh1).sum(0), dy1.sum(0),
        dw1, db1, dw2,
        dz.sum(0), (g * uh2).sum(0), g.sum(0),
    )
    return dx, grads


def _split_grads(flat, D, F):
    sizes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,),
             (F, D), (D,), (D,), (D,)]
    out, o = [], 0
    for s in sizes:
        n = math.prod(s)
        out.append(flat[o:o + n].view(*s))
        o += n
    return tuple(out)


def _bwd_kernel(fn_name, smem_fn, x, qkv, attn, strip, g, params, layer,
                rate, seed):
    N, S, D = x.shape
    F = params[6].shape[2]
    _check_shapes(S, D)
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise TypeError("the backward kernels take bfloat16 layer inputs")
    ps = _build.f32_params(params)
    dx = torch.empty(N, S, D, dtype=torch.float32, device=dev)
    P = sum(math.prod(p.shape[1:]) for p in ps)
    lib = _build.load("layer_bwd")
    G = _build.pick_groups("layer_bwd", smem_fn, S, D, n=N)
    blocks = (N + G - 1) // G
    partial = torch.empty(max(blocks, 1), P, dtype=torch.float32, device=dev)
    grads = torch.zeros(P, dtype=torch.float32, device=dev)
    if N:
        seed = device_seed(seed, dev)
        err = getattr(lib, fn_name)(
            x.contiguous().data_ptr(), qkv.contiguous().data_ptr(),
            attn.contiguous().data_ptr(), strip.contiguous().data_ptr(),
            g.to(torch.float32).contiguous().data_ptr(),
            _build.params_array(ps), ps[0].shape[0], layer, dx.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), N, S, D, F, G,
            1.0 / math.sqrt(D), *drop_launch(rate, seed),
            _build.stream_ptr(dev))
        _build.check(err, fn_name)
    return dx, _split_grads(grads, D, F)


def layer_backward(x, qkv, attn, strip, g, params, layer: int, rate: float,
                   seed: Optional[int], mm: torch.dtype = torch.bfloat16):
    """K2 on CUDA tensors, :func:`layer_backward_plain` on CPU tensors.
    ``params``: the 12 stacked tensors (the layer uses slice
    ``layer % stored``)."""
    if not x.is_cuda:
        p = [a[layer % a.shape[0]] for a in params]
        return layer_backward_plain(x, qkv, attn, strip, g.view_as(x), p,
                                    layer=layer, rate=rate, seed=seed, mm=mm)
    out = _bwd_kernel("gt_k2_layer_bwd", "gt_k2_smem_bytes", x, qkv, attn,
                      strip, g, params, layer, rate, seed)
    layer_backward.launches += 1
    return out


layer_backward.launches = 0


def slot0_backward(x, qkv, attn0, strip0, g, params, layer: int, rate: float,
                   seed: Optional[int], mm: torch.dtype = torch.bfloat16):
    """K3 on CUDA tensors, :func:`slot0_backward_plain` on CPU tensors."""
    if not x.is_cuda:
        p = [a[layer % a.shape[0]] for a in params]
        return slot0_backward_plain(x, qkv, attn0, strip0, g, p, layer=layer,
                                    rate=rate, seed=seed, mm=mm)
    out = _bwd_kernel("gt_k3_slot0_bwd", "gt_k3_smem_bytes", x, qkv, attn0,
                      strip0, g, params, layer, rate, seed)
    slot0_backward.launches += 1
    return out


slot0_backward.launches = 0


def walk_backward(dout, params, num_timesteps: int, layer_bwd):
    """Walk the layers backward, last first: ``layer_bwd(t, g)`` returns the
    layer input's cotangent and the layer's 12 gradients, which add into
    slice ``t % stored``.  Returns the encoder input's cotangent (float32)
    and the 12 stacked parameter gradients."""
    stored = params[0].shape[0]
    dparams = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
    g = dout.to(torch.float32)
    for t in range(num_timesteps - 1, -1, -1):
        g, grads = layer_bwd(t, g)
        for acc, dg in zip(dparams, grads):
            acc[t % stored] += dg
    return g, [dp.to(p.dtype) for dp, p in zip(dparams, params)]


def encoder_backward(res, dout, params, num_timesteps: int, rate: float,
                     seed: Optional[int], mm: torch.dtype = torch.bfloat16):
    """The backward from K1's residuals: K3 for the last layer, K2 for the
    others.  Returns (the encoder input's cotangent [N, S, D] float32, the
    12 stacked parameter gradients)."""
    T = num_timesteps

    def layer_bwd(t, g):
        bwd = slot0_backward if t == T - 1 else layer_backward
        return bwd(res["xs"][t], res["qkv"][t], res["attn"][t],
                   res["strip"][t], g, params, t, rate, seed, mm)

    return walk_backward(dout, params, T, layer_bwd)


class SampledEncoderFn(torch.autograd.Function):
    """Differentiable in the 12 parameters; the integer inputs, the codebook
    and the seed get no gradient (the JAX rule gives the codebook zeros)."""

    @staticmethod
    def forward(ctx, tag_rows, deg, self_tag, codebook, draws, seed, S, T,
                rate, mm, *params):
        out, res = sampled_forward(tag_rows, deg, self_tag, codebook, params,
                                   S, T, rate, seed, draws, mm)
        ctx.res = res
        ctx.cfg = (T, rate, seed, mm)
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, dout):
        params = ctx.saved_tensors
        T, rate, seed, mm = ctx.cfg
        dparams = encoder_backward(ctx.res, dout, params, T, rate, seed,
                                   mm)[1]
        ctx.res = None
        return (None,) * 10 + tuple(dparams)


def sampled_encoder(tag_rows, deg, self_tag, codebook,
                    params: Sequence[torch.Tensor], seq_len: int,
                    num_timesteps: int, rate: float = 0.5,
                    seed: Optional[int] = None, draws=None,
                    mm: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N] rows -> [N, D] float32, differentiable in ``params``.

    ``tag_rows`` [N, 128] int, ``deg`` [N] or [N, 1] int, ``self_tag`` [N]
    or [N, 1] int, ``codebook`` [C, D] float, ``params`` the 12 stacked
    tensors in KERNEL_ORDER.  ``draws`` [N, S-1]: neighbor draws made
    outside (indices into the tag rows) in place of the in-kernel sampler;
    the CPU parity tests hand both packages the same draws this way."""
    seed = device_seed(seed, tag_rows.device)
    return SampledEncoderFn.apply(tag_rows, deg, self_tag, codebook, draws,
                                  seed, seq_len, num_timesteps, rate, mm,
                                  *params)
