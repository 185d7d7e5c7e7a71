"""Eval encoder: T encoder layers over pre-gathered neighborhood rows — port
of ``fused_u2gnn_encoder`` (``graph_transformer_tpu/ops/pallas_u2gnn.py:394``).

``u2gnn_encoder(x2d [N·S, D], params, S, T)`` returns the slot-0 output of
the last layer, ``[N, D]`` float32.  Product operands take ``x2d``'s dtype
(bfloat16 or float32), as in the JAX kernel.  On a CUDA tensor it launches
kernel K4 (``csrc/encoder_fwd.cu``) for D <= 32, the wide K4
(``csrc/wide_fwd.cu``, :func:`wide_encoder`) for 32 < D <= 128, and raises
beyond; on a CPU tensor it runs :func:`u2gnn_encoder_plain`.  The main paths
run it at eval (rate 0).  Past D = 128 both functions run the layer as
kernels K18-K20 (``ops/rows_encoder.encoder_train_rows``); S > 32 raises.

:func:`u2gnn_encoder_train` is the same forward in training mode: dropout
from a seed, and the inputs of layers 1..T-1 saved in the rows' dtype, as the
JAX kernel saves them (``pallas_u2gnn.py:271-281``) for its per-layer
recompute backward (``ops/u2gnn_train.py``).  Kernel K4t
(``csrc/encoder_fwd.cu``) for D <= 32, K4tw (``csrc/wide_fwd.cu``,
:func:`wide_encoder_train`) for 32 < D <= 128.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import layer_forward
from graph_transformer_tpu_torch.ops.random import drop_args
from graph_transformer_tpu_torch.ops.rows_encoder import encoder_train_rows

MAX_D = 32        # K1-K4, K4t, K8-K10: one thread per row, D floats in
MAX_S = 32        # registers
WIDE_MAX_D = 128  # K5, K6, the wide K4 and the wide two-pass kernels: a warp
#                   per row, <= 4 columns a lane
WIDE_ROWS = 32    # ... and <= 32 rows (whole neighborhoods) a block


def u2gnn_encoder_train_plain(x2d: torch.Tensor,
                              params: Sequence[torch.Tensor], seq_len: int,
                              num_timesteps: int, rate: float = 0.0,
                              seed: Optional[int] = None):
    """The plain version of K4t: ``(out [N, D] float32, xs [T-1, N·S, D])``
    with ``xs`` the inputs of layers 1..T-1 in ``x2d``'s dtype."""
    S, T = seq_len, num_timesteps
    D = x2d.shape[1]
    mm = torch.bfloat16 if x2d.dtype == torch.bfloat16 else torch.float32
    h = x2d.to(torch.float32).view(-1, S, D)
    stored = params[0].shape[0]
    xs = []
    for t in range(T):
        if t > 0:
            xs.append(h.reshape(-1, D).to(x2d.dtype))
        p = [a[t % stored].to(torch.float32) for a in params]
        h, _ = layer_forward(h, p, layer=t, rate=rate, seed=seed, mm=mm,
                             slot0=(t == T - 1))
    return h, (torch.stack(xs) if xs else x2d.new_empty(0, *x2d.shape))


def u2gnn_encoder_plain(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                        seq_len: int, num_timesteps: int, rate: float = 0.0,
                        seed: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of K4 (same function, same dropout bits)."""
    return u2gnn_encoder_train_plain(x2d, params, seq_len, num_timesteps,
                                     rate, seed)[0]


def _check_shapes(S: int, D: int) -> None:
    if S > MAX_S or D > MAX_D:
        raise NotImplementedError(
            f"S={S}, D={D}: kernels K1-K4 take S <= {MAX_S} and D <= {MAX_D}"
            "; wider rows take K5/K6 and the wide K4")


def check_wide_shapes(S: int, D: int) -> None:
    """The wide kernels' limits (K4w, K4tw, K5, K6, K8w, K9w, K10w, K13w,
    K14w, K17): the whole-encoder, layer and FFN routes take K18-K20 past
    D = 128, the fused flags and K14 raise."""
    if S > MAX_S or D > WIDE_MAX_D:
        raise NotImplementedError(
            f"S={S}, D={D}: the port's wide encoder kernels take S <= {MAX_S}"
            f" and D <= {WIDE_MAX_D} (ROADMAP.md Queue A, 'Rows past D=128 or "
            "S=32', item 6)")


def u2gnn_encoder(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                  seq_len: int, num_timesteps: int, rate: float = 0.0,
                  seed: Optional[int] = None) -> torch.Tensor:
    """[N·S, D] rows -> [N, D] float32 (slot 0 of the last layer): K4 on
    CUDA tensors (the wide K4 past D = 32, K18-K20 past D = 128)."""
    if not x2d.is_cuda:
        return u2gnn_encoder_plain(x2d, params, seq_len, num_timesteps, rate,
                                   seed)
    if x2d.shape[1] > WIDE_MAX_D:
        return encoder_train_rows(x2d, params, seq_len, num_timesteps, rate,
                                  seed)[0]
    if x2d.shape[1] > MAX_D:
        return wide_encoder(x2d, params, seq_len, num_timesteps, rate, seed)
    return _launch(x2d, params, seq_len, num_timesteps, rate, seed, False)


def wide_encoder(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                 seq_len: int, num_timesteps: int, rate: float = 0.0,
                 seed: Optional[int] = None) -> torch.Tensor:
    """The wide K4 on CUDA tensors (D <= 128), :func:`u2gnn_encoder_plain`
    on CPU tensors; same contract as :func:`u2gnn_encoder`."""
    if not x2d.is_cuda:
        return u2gnn_encoder_plain(x2d, params, seq_len, num_timesteps, rate,
                                   seed)
    return _launch(x2d, params, seq_len, num_timesteps, rate, seed, True)


def u2gnn_encoder_train(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                        seq_len: int, num_timesteps: int, rate: float = 0.0,
                        seed: Optional[int] = None):
    """K4t on CUDA tensors (D <= 32; K4tw past, K18-K20 past D = 128),
    :func:`u2gnn_encoder_train_plain` on CPU tensors: ``(out [N, D]
    float32, xs [T-1, N·S, D])``."""
    if not x2d.is_cuda:
        return u2gnn_encoder_train_plain(x2d, params, seq_len, num_timesteps,
                                         rate, seed)
    if x2d.shape[1] > WIDE_MAX_D:
        return encoder_train_rows(x2d, params, seq_len, num_timesteps, rate,
                                  seed)
    if x2d.shape[1] > MAX_D:
        return wide_encoder_train(x2d, params, seq_len, num_timesteps, rate,
                                  seed)
    return _launch_train(x2d, params, seq_len, num_timesteps, rate, seed,
                         False)


def wide_encoder_train(x2d: torch.Tensor, params: Sequence[torch.Tensor],
                       seq_len: int, num_timesteps: int, rate: float = 0.0,
                       seed: Optional[int] = None):
    """K4tw on CUDA tensors (D <= 128), :func:`u2gnn_encoder_train_plain` on
    CPU tensors; same contract as :func:`u2gnn_encoder_train`."""
    if not x2d.is_cuda:
        return u2gnn_encoder_train_plain(x2d, params, seq_len, num_timesteps,
                                         rate, seed)
    return _launch_train(x2d, params, seq_len, num_timesteps, rate, seed, True)


def _launch_train(x2d, params, seq_len, num_timesteps, rate, seed, wide):
    T, D = num_timesteps, x2d.shape[1]
    xs = torch.empty(max(T - 1, 0), x2d.shape[0], D, dtype=x2d.dtype,
                     device=x2d.device)
    out = _launch(x2d, params, seq_len, num_timesteps, rate, seed, wide, xs)
    return out, xs


def _launch(x2d, params, seq_len, num_timesteps, rate, seed, wide: bool,
            xs=None):
    """K4 (``wide`` False), the wide K4 (``wide`` True) or, given ``xs``,
    K4t / K4tw writing the saved layer inputs there."""
    S, T = seq_len, num_timesteps
    D = x2d.shape[1]
    (check_wide_shapes if wide else _check_shapes)(S, D)
    _build.check_rows_dtype(x2d)
    if x2d.shape[0] % S:
        raise ValueError("x2d rows must be a multiple of seq_len")
    N = x2d.shape[0] // S
    F = params[6].shape[2]
    x2d = x2d.contiguous()
    ps = _build.f32_params(params)
    for p in ps:
        if p.device != x2d.device:
            raise ValueError("params and x2d must be on one device")
    out = torch.empty(N, D, dtype=torch.float32, device=x2d.device)
    if N == 0:
        return out
    if wide:
        src = "wide_fwd"
        fn = "gt_k4w_encoder_fwd" if xs is None else "gt_k4tw_encoder_fwd"
        G = _build.pick_groups(src, "gt_k4w_smem_bytes", S, D, WIDE_ROWS)
    else:
        src = "encoder_fwd"
        fn = "gt_k4_encoder_fwd" if xs is None else "gt_k4t_encoder_fwd"
        G = _build.pick_fwd_groups(src, "gt_k4_smem_bytes", S, D, N)
    saved = () if xs is None else (xs.data_ptr() if T > 1 else None,)
    err = getattr(_build.load(src), fn)(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16),
        _build.params_array(ps), ps[0].shape[0], out.data_ptr(), *saved, N, S,
        D, F, T, G, 1.0 / math.sqrt(D), *drop_args(rate, seed),
        _build.stream_ptr(x2d.device))
    _build.check(err, fn)
    counters = ((u2gnn_encoder, u2gnn_encoder_train),
                (wide_encoder, wide_encoder_train))[wide]
    counters[xs is not None].launches += 1
    return out


u2gnn_encoder.launches = 0
wide_encoder.launches = 0
u2gnn_encoder_train.launches = 0
wide_encoder_train.launches = 0
