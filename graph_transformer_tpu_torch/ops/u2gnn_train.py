"""Two-pass training encoder — port of ``fused_u2gnn_encoder`` with its hybrid
backward (``graph_transformer_tpu/ops/pallas_u2gnn.py:393-496``), the encoder
of the JAX two-pass path (sampler, feature gather, encoder).

Forward: kernel K4t (K4tw past D = 32;
``ops/u2gnn_encoder.u2gnn_encoder_train``) runs T encoder layers over
pre-gathered rows ``x2d [N·S, D]`` and saves the inputs of layers 1..T-1 in
the rows' dtype.  Backward, last layer first: kernel K8 (K8s for the slot-0
last layer, ``ops/csrc/recompute_bwd.cu``; K8w and K8ws, a warp per row, for
32 < D <= 128) recomputes one layer from its saved input and back-propagates
through it — the port of ``_bwd1_kernel`` (``pallas_u2gnn.py:316``).
Products take the rows' dtype, as in JAX (``:271, :331``): float32 rows (the
default compute dtype) run float32 products, bfloat16 rows bfloat16
products.

With ``mega_bwd`` (the counterpart of ``fused_u2gnn_encoder(...,
mega_bwd=True)``, ``pallas_u2gnn.py:449-450, 499-535``) the backward is one
launch of kernel K14 (K14w past D = 32, ``ops/csrc/mega_bwd.cu``): each block
walks the layers last first over its own neighborhoods, K8's recompute and
backward per layer, and sums the weight gradients into their stored slices
in the chain's order — the port of ``_bwd_kernel`` (``pallas_u2gnn.py:284``).
It gives the chain's dx and gradients (:func:`mega_recompute_backward`); the
default stays the chain, as in JAX.

Unlike the fused sampled encoders, :func:`u2gnn_train_encoder` returns the
rows' cotangent as well as the parameters' gradients: in a k-layer model,
layer 0's dx flows back through the re-gather (``ops/sparse.global_regather``)
into the U2GNN layer below.

Past D = 128 the chain's layers run as kernels K18-K20
(``ops/rows_encoder.recompute_backward_rows``: the layer recomputed from its
saved input, then its backward); K14 raises there (ROADMAP item 6).

Dispatch: every public function takes the kernel on CUDA tensors and the
plain PyTorch version on CPU tensors.  The plain backward runs the plain
layer forward and then the plain K2/K3 backward on the recomputed residuals.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import layer_forward
from graph_transformer_tpu_torch.ops.random import device_seed, drop_launch
from graph_transformer_tpu_torch.ops.rows_encoder import (
    recompute_backward_rows,
)
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    _split_grads,
    layer_backward_plain,
    slot0_backward_plain,
    walk_backward,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    MAX_D,
    WIDE_MAX_D,
    WIDE_ROWS,
    check_wide_shapes,
    u2gnn_encoder_train,
)


def _mm(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


# ================================================================ backward
def layer_recompute_backward_plain(x, g, p, *, layer: int, rate: float,
                                   seed: Optional[int], mm: torch.dtype,
                                   slot0: bool):
    """Plain version of K8 (``slot0`` False) and K8s: the backward of layer
    ``layer`` recomputed from its input.  x [N,S,D] (the saved input, in its
    dtype), g [N,S,D] (or [N,D] when ``slot0``), ``p`` the layer's 12
    tensors.  Returns (dx [N,S,D] float32, 12 grads in KERNEL_ORDER)."""
    _, res = layer_forward(x.to(torch.float32), p, layer=layer, rate=rate,
                           seed=seed, mm=mm, slot0=slot0)
    bwd = slot0_backward_plain if slot0 else layer_backward_plain
    return bwd(x, res["qkv"], res["attn"], res["strip"], g, p, layer=layer,
               rate=rate, seed=seed, mm=mm)


def _recompute_kernel(fn_name, smem_fn, x, g, params, layer, rate, seed,
                      slot0):
    """K8/K8s (a thread per row, D <= 32) or, for ``fn_name`` of K8w/K8ws, a
    warp per row (D <= 128)."""
    N, S, D = x.shape
    F = params[6].shape[2]
    wide = fn_name.startswith("gt_k8w")
    check_wide_shapes(S, D)
    if not wide and D > MAX_D:
        raise NotImplementedError(f"D={D}: K8 takes D <= {MAX_D}; use K8w")
    _build.check_rows_dtype(x)
    dev = x.device
    ps = _build.f32_params(params)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(N, S, D, **f32)
    P = sum(math.prod(p.shape[1:]) for p in ps)
    grads = torch.zeros(P, **f32)
    if N == 0:
        return dx, _split_grads(grads, D, F)
    lib = _build.load("recompute_bwd")
    bf = int(x.dtype == torch.bfloat16)
    if wide:
        G = _build.pick_groups("recompute_bwd", smem_fn, S, D, WIDE_ROWS)
        scratch = [torch.empty(lib.gt_k8w_work_bytes(N, S, D, F, G,
                                                     int(slot0), bf),
                               dtype=torch.uint8, device=dev)]
    else:
        qrows = N if slot0 else N * S  # query rows of the recomputed layer
        G = _build.pick_groups("recompute_bwd", smem_fn, S, D, n=N)
        scratch = [torch.empty(*shape, **f32) for shape in (
            (N * S, 3 * D), (qrows, S), (qrows, 4 * D + 2),
            ((N + G - 1) // G, P))]
    x = x.contiguous()
    g = g.to(torch.float32).contiguous()
    seed = device_seed(seed, dev)
    err = getattr(lib, fn_name)(
        x.data_ptr(), bf, g.data_ptr(), _build.params_array(ps),
        ps[0].shape[0], layer, dx.data_ptr(),
        *(t.data_ptr() for t in scratch), grads.data_ptr(), N,
        S, D, F, G, 1.0 / math.sqrt(D), *drop_launch(rate, seed),
        _build.stream_ptr(dev))
    _build.check(err, fn_name)
    return dx, _split_grads(grads, D, F)


def _plain(x, g, params, layer, rate, seed, slot0):
    p = [a[layer % a.shape[0]] for a in params]
    return layer_recompute_backward_plain(
        x, g if slot0 else g.view_as(x), p, layer=layer, rate=rate, seed=seed,
        mm=_mm(x.dtype), slot0=slot0)


def layer_recompute_backward(x, g, params, layer: int, rate: float,
                             seed: Optional[int], need_dx: bool = True):
    """K8 on CUDA tensors (D <= 32; K8w past, K18-K20 past D = 128), the
    plain version (:func:`layer_recompute_backward_plain`) on CPU tensors:
    a full layer (t < T-1).  ``params``: the 12 stacked tensors (the layer
    uses slice ``layer % stored``); products in ``x``'s dtype.  Without
    ``need_dx`` the rows route past D = 128 skips dx (returns None)."""
    if not x.is_cuda:
        return _plain(x, g, params, layer, rate, seed, False)
    if x.shape[2] > WIDE_MAX_D:
        return recompute_backward_rows(x, g, params, layer, rate, seed, False,
                                       need_dx)
    if x.shape[2] > MAX_D:
        return wide_layer_recompute_backward(x, g, params, layer, rate, seed)
    out = _recompute_kernel("gt_k8_layer_bwd", "gt_k8_smem_bytes", x, g,
                            params, layer, rate, seed, False)
    layer_recompute_backward.launches += 1
    return out


def slot0_recompute_backward(x, g, params, layer: int, rate: float,
                             seed: Optional[int], need_dx: bool = True):
    """K8s on CUDA tensors (D <= 32; K8ws past, K18-K20 past D = 128), the
    plain version on CPU tensors: the slot-0 last layer, g [N, D];
    ``need_dx`` as for :func:`layer_recompute_backward`."""
    if not x.is_cuda:
        return _plain(x, g, params, layer, rate, seed, True)
    if x.shape[2] > WIDE_MAX_D:
        return recompute_backward_rows(x, g, params, layer, rate, seed, True,
                                       need_dx)
    if x.shape[2] > MAX_D:
        return wide_slot0_recompute_backward(x, g, params, layer, rate, seed)
    out = _recompute_kernel("gt_k8s_slot0_bwd", "gt_k8s_smem_bytes", x, g,
                            params, layer, rate, seed, True)
    slot0_recompute_backward.launches += 1
    return out


def wide_layer_recompute_backward(x, g, params, layer: int, rate: float,
                                  seed: Optional[int]):
    """K8w (D <= 128) on CUDA tensors, the plain version on CPU tensors;
    the contract of :func:`layer_recompute_backward`."""
    if not x.is_cuda:
        return _plain(x, g, params, layer, rate, seed, False)
    out = _recompute_kernel("gt_k8w_layer_bwd", "gt_k8w_smem_bytes", x, g,
                            params, layer, rate, seed, False)
    wide_layer_recompute_backward.launches += 1
    return out


def wide_slot0_recompute_backward(x, g, params, layer: int, rate: float,
                                  seed: Optional[int]):
    """K8ws (D <= 128) on CUDA tensors, the plain version on CPU tensors;
    the contract of :func:`slot0_recompute_backward`."""
    if not x.is_cuda:
        return _plain(x, g, params, layer, rate, seed, True)
    out = _recompute_kernel("gt_k8ws_slot0_bwd", "gt_k8ws_smem_bytes", x, g,
                            params, layer, rate, seed, True)
    wide_slot0_recompute_backward.launches += 1
    return out


layer_recompute_backward.launches = 0
slot0_recompute_backward.launches = 0
wide_layer_recompute_backward.launches = 0
wide_slot0_recompute_backward.launches = 0


# ====================================================== whole-stack backward
def mega_recompute_backward_plain(x2d, xs, dout, params, seq_len: int,
                                  num_timesteps: int, rate: float,
                                  seed: Optional[int]):
    """Plain version of K14 and K14w: the plain K8 chain (K8s for the last
    layer, then K8 per earlier layer) walked in one function.  x2d [N·S, D]
    the encoder input, xs [T-1, N·S, D] the saved inputs of layers 1..T-1
    (both in the rows' dtype), dout [N, D].  Returns (dx [N·S, D] float32,
    the 12 stacked gradients float32)."""
    S, T = seq_len, num_timesteps
    N, D = x2d.shape[0] // S, x2d.shape[1]

    def layer_bwd(t, g):
        x = (x2d if t == 0 else xs[t - 1]).view(N, S, D)
        return _plain(x, g, params, t, rate, seed, t == T - 1)

    dx, dparams = walk_backward(dout, params, T, layer_bwd)
    return dx.reshape(N * S, D), [d.to(torch.float32) for d in dparams]


def _mega_kernel(x2d, xs, dout, params, S, T, rate, seed, wide):
    """K14 (a thread per row, D <= 32) or K14w (a warp per row, D <= 128)."""
    N, D = x2d.shape[0] // S, x2d.shape[1]
    F = params[6].shape[2]
    check_wide_shapes(S, D)
    if not wide and D > MAX_D:
        raise NotImplementedError(f"D={D}: K14 takes D <= {MAX_D}; use K14w")
    _build.check_rows_dtype(x2d)
    dev = x2d.device
    ps = _build.f32_params(params)
    stored = ps[0].shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    P = sum(math.prod(p.shape[1:]) for p in ps)
    dx = torch.zeros(N * S, D, **f32)
    grads = torch.zeros(stored, P, **f32)
    if N:
        lib = _build.load("mega_bwd")
        x = x2d.contiguous()
        saved = xs.to(x.dtype).contiguous() if T > 1 else None
        g = dout.to(torch.float32).contiguous()
        bf = int(x.dtype == torch.bfloat16)
        args = (x.data_ptr(), None if saved is None else saved.data_ptr(), bf,
                g.data_ptr(), _build.params_array(ps), stored, dx.data_ptr())
        tail = (N, S, D, F, T)
        if wide:
            G = _build.pick_groups("mega_bwd", "gt_k14w_smem_bytes", S, D,
                                   WIDE_ROWS)
            work = torch.empty(lib.gt_k14w_work_bytes(N, S, D, F, G, T, bf),
                               dtype=torch.uint8, device=dev)
            seed = device_seed(seed, dev)
            err = lib.gt_k14w_mega_bwd(
                *args, work.data_ptr(), grads.data_ptr(), *tail, G,
                1.0 / math.sqrt(D), *drop_launch(rate, seed),
                _build.stream_ptr(dev))
        else:
            G = _build.pick_groups("mega_bwd", "gt_k14_smem_bytes", S, D,
                                   n=N)
            scratch = [torch.empty(*shape, **f32) for shape in (
                (N * S, 3 * D), (N * S, S), (N * S, 4 * D + 2), (N, S),
                (N, 4 * D + 2), ((N + G - 1) // G, T, P))]
            seed = device_seed(seed, dev)
            err = lib.gt_k14_mega_bwd(
                *args, *(t.data_ptr() for t in scratch), grads.data_ptr(),
                *tail, G, 1.0 / math.sqrt(D), *drop_launch(rate, seed),
                _build.stream_ptr(dev))
        _build.check(err, "K14w mega_bwd" if wide else "K14 mega_bwd")
    per_slice = [_split_grads(grads[s], D, F) for s in range(stored)]
    return dx, [torch.stack(leaf) for leaf in zip(*per_slice)]


def mega_recompute_backward(x2d, xs, dout, params, seq_len: int,
                            num_timesteps: int, rate: float,
                            seed: Optional[int]):
    """K14 on CUDA tensors (D <= 32; K14w past), the plain version
    (:func:`mega_recompute_backward_plain`) on CPU tensors: the whole
    stack's backward in one launch.  Same arguments and return value."""
    if not x2d.is_cuda:
        return mega_recompute_backward_plain(x2d, xs, dout, params, seq_len,
                                             num_timesteps, rate, seed)
    if x2d.shape[1] > MAX_D:
        return wide_mega_recompute_backward(x2d, xs, dout, params, seq_len,
                                            num_timesteps, rate, seed)
    out = _mega_kernel(x2d, xs, dout, params, seq_len, num_timesteps, rate,
                       seed, False)
    mega_recompute_backward.launches += 1
    return out


def wide_mega_recompute_backward(x2d, xs, dout, params, seq_len: int,
                                 num_timesteps: int, rate: float,
                                 seed: Optional[int]):
    """K14w (D <= 128) on CUDA tensors, the plain version on CPU tensors;
    the contract of :func:`mega_recompute_backward`."""
    if not x2d.is_cuda:
        return mega_recompute_backward_plain(x2d, xs, dout, params, seq_len,
                                             num_timesteps, rate, seed)
    out = _mega_kernel(x2d, xs, dout, params, seq_len, num_timesteps, rate,
                       seed, True)
    wide_mega_recompute_backward.launches += 1
    return out


mega_recompute_backward.launches = 0
wide_mega_recompute_backward.launches = 0


# ============================================================== autograd
def chain_backward(x2d, xs, dout, params, seq_len: int, num_timesteps: int,
                   rate: float, seed: Optional[int], need_dx: bool = True):
    """Kernel 5's hybrid chain (``pallas_u2gnn.py:455-496``): K8s (K8ws) for
    the last layer, then K8 (K8w) per earlier layer, from the encoder input
    x2d [N·S, D] and the saved inputs xs [T-1, N·S, D].  Returns (dx
    [N·S, D] float32, the 12 stacked gradients); without ``need_dx`` the
    rows route skips the input's cotangent, and dx may be None."""
    S, T = seq_len, num_timesteps
    N, D = x2d.shape[0] // S, x2d.shape[1]

    def layer_bwd(t, g):
        x = (x2d if t == 0 else xs[t - 1]).view(N, S, D)
        bwd = (slot0_recompute_backward if t == T - 1
               else layer_recompute_backward)
        return bwd(x, g, params, t, rate, seed, need_dx=need_dx or t > 0)

    dx, dparams = walk_backward(dout, params, T, layer_bwd)
    return (None if dx is None else dx.reshape(N * S, D)), dparams


class U2GNNTrainFn(torch.autograd.Function):
    """Differentiable in the rows and the 12 parameters; the seed gets no
    gradient."""

    @staticmethod
    def forward(ctx, x2d, seed, S, T, rate, mega_bwd, *params):
        out, xs = u2gnn_encoder_train(x2d, params, S, T, rate, seed)
        ctx.xs = xs
        ctx.cfg = (S, T, rate, seed, mega_bwd)
        ctx.save_for_backward(x2d, *params)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2d, *params = ctx.saved_tensors
        S, T, rate, seed, mega_bwd = ctx.cfg
        xs, ctx.xs = ctx.xs, None
        need_dx = ctx.needs_input_grad[0]
        if mega_bwd:
            dx, dparams = mega_recompute_backward(x2d, xs, dout, params, S, T,
                                                  rate, seed)
        else:
            dx, dparams = chain_backward(x2d, xs, dout, params, S, T, rate,
                                         seed, need_dx)
        dx = dx.to(x2d.dtype) if need_dx else None
        dparams = [d.to(p.dtype) for d, p in zip(dparams, params)]
        return (dx, None, None, None, None, None, *dparams)


def u2gnn_train_encoder(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                        seq_len: int, num_timesteps: int, rate: float = 0.5,
                        seed: Optional[int] = None,
                        mega_bwd: bool = False) -> torch.Tensor:
    """[N·S, D] rows (bfloat16 or float32) -> [N, D] float32 (slot 0 of the
    last layer), differentiable in ``x2d`` and the 12 stacked ``params``
    (KERNEL_ORDER; timestep t uses slice ``t % stored``).  ``mega_bwd``
    takes the whole-stack backward (K14/K14w) in place of the per-layer
    chain."""
    seed = device_seed(seed, x2d.device)
    return U2GNNTrainFn.apply(x2d, seed, seq_len, num_timesteps, rate,
                              mega_bwd, *params)
