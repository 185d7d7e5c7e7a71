"""The encoder layer past D = 128 — three kernels that compose it.

The JAX package's encoder kernels have no width limit
(``graph_transformer_tpu/ops/pallas_u2gnn.py:394``,
``ops/pallas_encoder.py:335``, ``ops/pallas_ffn.py``); the port's kernels
for them hold a row's D <= 128 features in one warp.  Past that width every
encoder route (the whole encoder K4/K4t with its recompute backward K8/K8s,
the layer K9/K10, the FFN K11/K12) runs as a composition of three kernels,
each with its plain PyTorch version here:

- **K18**, :func:`gemm` (``csrc/rows_gemm.cu``): ``C = op(A) op(B)`` in the
  layouts ``nn`` (A·B), ``nt`` (A·Bᵀ) and ``tn`` (Aᵀ·B, the weight
  gradients, with the column sums of B that give the bias gradients), with
  the epilogues a layer needs: bias, ReLU, dropout at (layer, site), a gate
  ``(aux > 0) / keep`` (the ReLU-dropout backward), and an added matrix.
  Operands and the output may be views with a row stride (``out=``);
  float32 products run on the tensor cores as 3xTF32, bf16 products (of
  float32 or bf16 operands, rounded as they are staged) on ``wgmma``.
- **K19**, :func:`attention_forward` / :func:`attention_backward`
  (``csrc/rows_attention.cu``): single-head attention over each
  neighborhood's S <= 32 slots, scores ``q·kᵀ/√D``, softmax, dropout at
  site 0 and the context; the backward recomputes the probabilities.
- **K20**, :func:`res_ln_forward` / :func:`res_ln_backward`
  (``csrc/rows_ln.cu``): ``LN(res + drop(v))`` over rows of any D, the
  backward recomputing the statistics, ``dγ`` and ``dβ`` reduced
  deterministically.

Operands of a product are rounded to the compute dtype (bfloat16 rows:
bfloat16 products; float32 rows: float32) and accumulate in float32, as in
the Pallas kernels and ``ops/attention.layer_forward``; every output is
float32.  Dropout draws ``ops/random``'s words keyed by (seed, 4·layer +
site, element), element indices row-major over the site's logical shape, so
the kernels and their plain versions drop alike.

One encoder layer, forward (:func:`layer_forward_rows`), per timestep:
QKV = K18(x, W_in, +b_in); ctx = K19(QKV); a = K18(ctx, W_out, +b_out);
y1 = K20(x, a, site 1); h = K18(y1, W1, +b1, ReLU, site 2);
z = K18(h, W2, +b2); out = K20(y1, z, site 3).  In the slot-0 last layer
the queries, the output product, the FFN and the LayerNorms run on slot 0's
row of each neighborhood only (``res_every`` = S): q = K18(x[::S],
W_in[:, :D]) and k, v = K18(x, W_in[:, D:]) write their columns of one QKV
buffer, whose q columns off slot 0 stay unwritten (the slot-0 attention
reads slot 0's query alone).  The backward (:func:`layer_backward_rows`)
recomputes that forward from the layer input, as K8 does, then K20's
backward twice, K19's once, four K18 row products (dh, dy1, dctx, and dx
where the input's cotangent is needed) and four K18 weight products (five
in the slot-0 layer: W_in's q columns over slot 0's rows, its k, v columns
over every row).  A layer's launches: forward K18 4 (slot 0: 5), K19 1,
K20 2; backward K18 12, 11 without dx (slot 0: 14, 13), K19 2, K20 3.  A
node step at T = 1 (one slot-0 layer, no dx): K18 18, K19 3, K20 5.

The routes past D = 128 (``ops/u2gnn_encoder.py``, ``ops/u2gnn_train.py``,
``ops/encoder_layer.py``, ``ops/ffn.py``) call the compositions below.
Each kernel wrapper launches its kernel on CUDA tensors, runs its plain
version on CPU tensors and raises on any other device.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import (
    dropout,
    layer_norm,
    rnd,
)
from graph_transformer_tpu_torch.ops.random import (
    device_seed,
    drop_launch,
    dropout_stream,
)

MAX_S = 32  # K19: a neighborhood's slots in one warp's lanes
LN_BWD_MAX_D = 19370  # K20's backward: gamma and the column sums in 227 KB
ATTN_SITE, OUT_SITE, HIDDEN_SITE, FFN_SITE = 0, 1, 2, 3


class Counter:
    """A kernel's launch count: one a call that launches it; ``shapes``
    counts K18's launches by (layout, bf16, M, N, K, the row strides of A,
    B and C)."""

    def __init__(self):
        self.launches = 0
        self.shapes = collections.Counter()


K18, K19, K20 = Counter(), Counter(), Counter()


def check_rows_shapes(S: int) -> None:
    if S > MAX_S:
        raise NotImplementedError(
            f"S={S}: the port's encoder kernels take S <= {MAX_S} (ROADMAP.md"
            " Queue A, 'Rows past D=128 or S=32', item 6)")


def _mm(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def _device_ok(*ts) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain);
    anything else raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(devs)}: cuda or cpu, one device")


def _drop_key(rate: float, seed, layer: int, site: int):
    """(the device seed's address, stream, keep24, keep, on) of one dropout
    site, as the kernels take them."""
    ptr, keep24, keep, on = drop_launch(rate, seed)
    return ptr, dropout_stream(layer, site), keep24, keep, on


# ===================================================================== K18
def gemm_plain(a, b, layout: str = "nn", *, bf16: bool = False, bias=None,
               relu: bool = False, drop=None, gate=None, gate_keep=1.0,
               add=None, add_every: int = 1, out=None):
    """Plain version of K18: ``C = op(A) op(B)`` float32, operands rounded
    to bfloat16 when ``bf16``.  ``layout`` ``nn``: A [M, K], B [K, N];
    ``nt``: B [N, K]; ``tn``: A [K, M].  Epilogue, in this order: ``+
    bias`` [N]; ReLU; dropout ``drop`` = (rate, seed, layer, site) over the
    [M, N] output; ``· (gate > 0) / gate_keep`` (``gate`` [M, N]); ``+
    add`` on rows r with r % add_every == 0 (``add`` row r / add_every).
    With ``out`` (a float32 [M, N] view) C is written there and returned."""
    mm = _mm(bf16)
    A = rnd(a.to(torch.float32), mm)
    B = rnd(b.to(torch.float32), mm)
    if layout == "nt":
        B = B.T
    elif layout == "tn":
        A = A.T
    elif layout != "nn":
        raise ValueError(f"unknown layout {layout!r}")
    c = A @ B
    if bias is not None:
        c = c + bias
    if relu:
        c = torch.relu(c)
    if drop is not None:
        rate, seed, layer, site = drop
        c = dropout(c, rate, seed, layer, site)
    if gate is not None:
        c = c * ((gate > 0).to(torch.float32) / gate_keep)
    if add is not None:
        if add_every == 1:
            c = add + c
        else:
            c = c.clone()
            c[::add_every] = add + c[::add_every]
    return c if out is None else out.copy_(c)


def gemm(a, b, layout: str = "nn", *, bf16: bool = False, bias=None,
         relu: bool = False, drop=None, gate=None, gate_keep=1.0, add=None,
         add_every: int = 1, out=None):
    """K18 on CUDA tensors, :func:`gemm_plain` on CPU tensors."""
    if not _device_ok(a, b):
        return gemm_plain(a, b, layout, bf16=bf16, bias=bias, relu=relu,
                          drop=drop, gate=gate, gate_keep=gate_keep, add=add,
                          add_every=add_every, out=out)
    M, N, K = _dims(a, b, layout)
    c = (torch.empty(M, N, dtype=torch.float32, device=a.device)
         if out is None else _out(out, M, N))
    if c.numel() == 0:
        return c
    if K == 0:
        raise ValueError("K18: empty inner dimension")
    a, b = _operands(a, b, bf16)
    eps = [_f32(t) for t in (bias, gate, add)]
    if drop is not None:
        drop = (drop[0], device_seed(drop[1], a.device), *drop[2:])
    dk = (_drop_key(*drop) if drop is not None
          else (None, 0, 1 << 24, 1.0, 0))
    lib = _build.load("rows_gemm")
    scratch = _packed(lib, M, N, K, bf16, a.device)
    err = lib.gt_k18_gemm(
        a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
        int(b.dtype == torch.bfloat16), c.data_ptr(), M, N, K,
        *_strides(a, b, layout), _row_stride(c),
        int(bf16), *(None if t is None else t.data_ptr() for t in eps[:1]),
        int(relu), *(None if t is None else t.data_ptr() for t in eps[1:]),
        float(gate_keep), int(add_every), *dk, 1, None,
        None if scratch is None else scratch.data_ptr(),
        _build.stream_ptr(a.device))
    _build.check(err, "K18 gemm")
    K18.launches += 1
    K18.shapes[(layout, bool(bf16), M, N, K, _row_stride(a), _row_stride(b),
                _row_stride(c))] += 1
    return c


def weight_grad_plain(a, b, *, bf16: bool = False):
    """Plain version of K18's ``tn`` layout with the column sums: ``(aᵀ b
    [M, N], Σ_rows b [N])`` over a [rows, M] and b [rows, N], the product
    on rounded operands, the sums of b as it is."""
    return (gemm_plain(a, b, "tn", bf16=bf16),
            b.to(torch.float32).sum(0))


def weight_grad(a, b, *, bf16: bool = False):
    """K18 (``tn``, split over the rows in a fixed number of chunks summed
    in order, then the column sums of b) on CUDA tensors,
    :func:`weight_grad_plain` on CPU tensors."""
    if not _device_ok(a, b):
        return weight_grad_plain(a, b, bf16=bf16)
    M, N, K = _dims(a, b, "tn")
    dev = a.device
    c = torch.empty(M, N, dtype=torch.float32, device=dev)
    col = torch.empty(N, dtype=torch.float32, device=dev)
    a, b = _operands(a, b, bf16)
    if K == 0:
        return c.zero_(), col.zero_()
    lib = _build.load("rows_gemm")
    chunks = lib.gt_k18_chunks(M, N, K, int(bf16))
    part = torch.empty(chunks * M * N if chunks > 1 else 1,
                       dtype=torch.float32, device=dev)
    scratch = _packed(lib, M, N, K, bf16, dev)
    stream = _build.stream_ptr(dev)
    err = lib.gt_k18_gemm(
        a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
        int(b.dtype == torch.bfloat16), c.data_ptr(), M, N, K,
        *_strides(a, b, "tn"), N,
        int(bf16), None, 0, None, None, 1.0, 1, 0, 0, 1 << 24, 1.0, 0,
        chunks, part.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream)
    _build.check(err, "K18 weight product")
    cchunks = lib.gt_k18_colsum_chunks(K)
    cpart = torch.empty(cchunks * N, dtype=torch.float32, device=dev)
    err = lib.gt_k18_colsum(b.data_ptr(), int(b.dtype == torch.bfloat16),
                            col.data_ptr(), cpart.data_ptr(), K, N,
                            _row_stride(b), cchunks, stream)
    _build.check(err, "K18 column sums")
    K18.launches += 1
    K18.shapes[("tn", bool(bf16), M, N, K, _row_stride(a), _row_stride(b),
                N)] += 1
    return c, col


def _packed(lib, M, N, K, bf16, dev):
    """The scratch of K18's bf16 products (both operands' tiles rounded to
    bf16 and packed), None for float32 products."""
    if not bf16:
        return None
    return torch.empty(lib.gt_k18_bf16_scratch(M, N, K), dtype=torch.uint8,
                       device=dev)


def _operands(a, b, bf16):
    """a, b with unit column stride (a view keeps its row stride); float32
    products take float32 operands."""
    for t in (a, b):
        _build.check_rows_dtype(t)
        if not bf16 and t.dtype != torch.float32:
            raise TypeError("K18's float32 products take float32 operands")
    return tuple(t if t.shape[1] < 2 or t.stride(1) == 1 else t.contiguous()
                 for t in (a, b))


def _row_stride(t) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _out(out, M, N):
    """``out`` checked as K18's output: float32 [M, N], unit column
    stride."""
    if (out.dtype != torch.float32 or tuple(out.shape) != (M, N)
            or (N > 1 and out.stride(1) != 1) or out.device.type != "cuda"):
        raise ValueError(f"K18 out: a float32 [{M}, {N}] CUDA view with unit "
                         "column stride")
    return out


def _f32(t):
    return None if t is None else t.detach().to(torch.float32).contiguous()


def _dims(a, b, layout):
    """(M, N, K) of row-major a, b in ``layout``."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("K18 takes 2-d operands")
    if layout == "nn":
        (M, K), (K2, N) = a.shape, b.shape
    elif layout == "nt":
        (M, K), (N, K2) = a.shape, b.shape
    elif layout == "tn":
        (K, M), (K2, N) = a.shape, b.shape
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if K != K2:
        raise ValueError(f"K18 {layout}: inner dimensions {K} and {K2}")
    return M, N, K


def _strides(a, b, layout):
    """(A's m and k strides, B's k and n strides) of a, b (unit column
    stride, any row stride) in ``layout``."""
    lda, ldb = _row_stride(a), _row_stride(b)
    if layout == "nn":
        return lda, 1, ldb, 1
    if layout == "nt":
        return lda, 1, 1, ldb
    return 1, lda, ldb, 1


# ===================================================================== K19
def _qkv(qkv, S, D):
    N = qkv.shape[0] // S
    t = qkv.view(N, S, 3 * D)
    return t[..., :D], t[..., D:2 * D], t[..., 2 * D:]


def _probs(q, k, slot0, D, mm):
    """Undropped attention probabilities [N, S, S] ([N, S] for slot 0)."""
    scale = 1.0 / math.sqrt(D)
    if slot0:
        s = (rnd(q[:, :1], mm) @ rnd(k, mm).transpose(1, 2))[:, 0] * scale
    else:
        s = (rnd(q, mm) @ rnd(k, mm).transpose(1, 2)) * scale
    return torch.softmax(s, dim=-1)


def attention_forward_plain(qkv, S: int, *, slot0: bool = False,
                            rate: float = 0.0, seed: Optional[int] = None,
                            layer: int = 0, bf16: bool = False):
    """Plain version of K19's forward: ``ctx`` [N·S, D] ([N, D] for slot 0)
    float32 from ``qkv`` [N·S, 3D] float32."""
    D = qkv.shape[1] // 3
    mm = _mm(bf16)
    q, k, v = _qkv(qkv, S, D)
    attn = _probs(q, k, slot0, D, mm)
    ad = rnd(dropout(attn, rate, seed, layer, ATTN_SITE), mm)
    if slot0:
        return (ad[:, None, :] @ rnd(v, mm))[:, 0]
    return (ad @ rnd(v, mm)).reshape(-1, D)


def attention_backward_plain(qkv, dctx, S: int, *, slot0: bool = False,
                             rate: float = 0.0, seed: Optional[int] = None,
                             layer: int = 0, bf16: bool = False):
    """Plain version of K19's backward: ``dqkv`` [N·S, 3D] float32 from
    ``qkv`` and the context's cotangent ``dctx`` (dq is zero off slot 0 in
    the slot-0 layer)."""
    D = qkv.shape[1] // 3
    mm = _mm(bf16)
    q, k, v = _qkv(qkv, S, D)
    N = q.shape[0]
    attn = _probs(q, k, slot0, D, mm)

    def drop(t):
        return dropout(t, rate, seed, layer, ATTN_SITE)

    attn_d = drop(attn)
    if slot0:
        dc = dctx.view(N, D)
        dattn = drop((rnd(v, mm) @ rnd(dc, mm)[:, :, None])[..., 0])
        ds = attn * (dattn - (dattn * attn).sum(-1, keepdim=True)) \
            * (1.0 / math.sqrt(D))
        dq = torch.zeros_like(q)
        dq[:, 0] = (rnd(ds, mm)[:, None, :] @ rnd(k, mm))[:, 0]
        dk = rnd(ds, mm)[:, :, None] * rnd(q[:, 0], mm)[:, None, :]
        dv = rnd(attn_d, mm)[:, :, None] * rnd(dc, mm)[:, None, :]
    else:
        dc = dctx.view(N, S, D)
        dattn = drop(rnd(dc, mm) @ rnd(v, mm).transpose(1, 2))
        ds = attn * (dattn - (dattn * attn).sum(-1, keepdim=True)) \
            * (1.0 / math.sqrt(D))
        dq = rnd(ds, mm) @ rnd(k, mm)
        dk = rnd(ds, mm).transpose(1, 2) @ rnd(q, mm)
        dv = rnd(attn_d, mm).transpose(1, 2) @ rnd(dc, mm)
    return torch.cat([dq, dk, dv], dim=-1).reshape(N * S, 3 * D)


def _attn_check(qkv, S):
    check_rows_shapes(S)
    if qkv.dtype != torch.float32 or qkv.shape[0] % S or qkv.shape[1] % 3:
        raise ValueError("K19 takes qkv [N*S, 3D] float32")


def attention_forward(qkv, S: int, *, slot0: bool = False, rate: float = 0.0,
                      seed: Optional[int] = None, layer: int = 0,
                      bf16: bool = False):
    """K19's forward on CUDA tensors, :func:`attention_forward_plain` on
    CPU tensors."""
    _attn_check(qkv, S)
    if not _device_ok(qkv):
        return attention_forward_plain(qkv, S, slot0=slot0, rate=rate,
                                       seed=seed, layer=layer, bf16=bf16)
    N, D = qkv.shape[0] // S, qkv.shape[1] // 3
    seed = device_seed(seed, qkv.device)
    ctx = torch.empty(N if slot0 else N * S, D, dtype=torch.float32,
                      device=qkv.device)
    if N:
        err = _build.load("rows_attention").gt_k19_attn_fwd(
            qkv.contiguous().data_ptr(), ctx.data_ptr(), N, S, D, int(slot0),
            int(bf16), 1.0 / math.sqrt(D),
            *_drop_key(rate, seed, layer, ATTN_SITE),
            _build.stream_ptr(qkv.device))
        _build.check(err, "K19 attention forward")
        K19.launches += 1
    return ctx


def attention_backward(qkv, dctx, S: int, *, slot0: bool = False,
                       rate: float = 0.0, seed: Optional[int] = None,
                       layer: int = 0, bf16: bool = False):
    """K19's backward on CUDA tensors, :func:`attention_backward_plain` on
    CPU tensors."""
    _attn_check(qkv, S)
    if not _device_ok(qkv, dctx):
        return attention_backward_plain(qkv, dctx, S, slot0=slot0, rate=rate,
                                        seed=seed, layer=layer, bf16=bf16)
    N, D = qkv.shape[0] // S, qkv.shape[1] // 3
    seed = device_seed(seed, qkv.device)
    dqkv = torch.empty(N * S, 3 * D, dtype=torch.float32, device=qkv.device)
    if N:
        err = _build.load("rows_attention").gt_k19_attn_bwd(
            qkv.contiguous().data_ptr(),
            dctx.to(torch.float32).contiguous().data_ptr(), dqkv.data_ptr(),
            N, S, D, int(slot0), int(bf16), 1.0 / math.sqrt(D),
            *_drop_key(rate, seed, layer, ATTN_SITE),
            _build.stream_ptr(qkv.device))
        _build.check(err, "K19 attention backward")
        K19.launches += 1
    return dqkv


# ===================================================================== K20
def _res_rows(res, res_every: int):
    return res.to(torch.float32)[::res_every]


def res_ln_forward_plain(res, v, gamma, beta, *, res_every: int = 1,
                         rate: float = 0.0, seed: Optional[int] = None,
                         layer: int = 0, site: int = OUT_SITE):
    """Plain version of K20's forward: ``LN(res + drop(v))`` [R, D]
    float32, ``v`` [R, D] float32 dropped at (layer, site), ``res`` row r
    the row r·res_every of ``res`` (any float dtype)."""
    u = _res_rows(res, res_every) + dropout(v, rate, seed, layer, site)
    return layer_norm(u, gamma, beta)[0]


def res_ln_backward_plain(g, res, v, gamma, beta, *, res_every: int = 1,
                          rate: float = 0.0, seed: Optional[int] = None,
                          layer: int = 0, site: int = OUT_SITE):
    """Plain version of K20's backward, the statistics recomputed from
    ``res`` and ``v``: ``(du, dv, dγ, dβ)``: du the cotangent of ``res +
    drop(v)`` [R, D], dv = drop(du) that of ``v``, dγ = Σ g·û, dβ = Σ g."""
    u = _res_rows(res, res_every) + dropout(v, rate, seed, layer, site)
    _, uhat, rstd = layer_norm(u, gamma, beta)
    g = g.to(torch.float32)
    gg = g * gamma
    du = (gg - gg.mean(-1, keepdim=True)
          - uhat * (gg * uhat).mean(-1, keepdim=True)) * rstd
    dv = dropout(du, rate, seed, layer, site)
    return du, dv, (g * uhat).sum(0), g.sum(0)


def _ln_args(res, v, res_every):
    R, D = v.shape
    if res.shape[1] != D or (R and res.shape[0] < (R - 1) * res_every + 1):
        raise ValueError("K20: res rows do not cover v's")
    _build.check_rows_dtype(res)
    return R, D


def res_ln_forward(res, v, gamma, beta, *, res_every: int = 1,
                   rate: float = 0.0, seed: Optional[int] = None,
                   layer: int = 0, site: int = OUT_SITE):
    """K20's forward on CUDA tensors, :func:`res_ln_forward_plain` on CPU
    tensors."""
    if not _device_ok(res, v):
        return res_ln_forward_plain(res, v, gamma, beta, res_every=res_every,
                                    rate=rate, seed=seed, layer=layer,
                                    site=site)
    R, D = _ln_args(res, v, res_every)
    seed = device_seed(seed, v.device)
    y = torch.empty(R, D, dtype=torch.float32, device=v.device)
    if R:
        res = res.contiguous()
        err = _build.load("rows_ln").gt_k20_ln_fwd(
            res.data_ptr(), int(res.dtype == torch.bfloat16), res_every,
            v.to(torch.float32).contiguous().data_ptr(),
            _f32(gamma).data_ptr(), _f32(beta).data_ptr(), y.data_ptr(), R,
            D, *_drop_key(rate, seed, layer, site),
            _build.stream_ptr(v.device))
        _build.check(err, "K20 LayerNorm forward")
        K20.launches += 1
    return y


def res_ln_backward(g, res, v, gamma, beta, *, res_every: int = 1,
                    rate: float = 0.0, seed: Optional[int] = None,
                    layer: int = 0, site: int = OUT_SITE):
    """K20's backward on CUDA tensors (a row a block of 8 warps, dγ and dβ
    from per-block partials summed in a fixed order; D up to
    ``LN_BWD_MAX_D``), :func:`res_ln_backward_plain` on CPU tensors."""
    if not _device_ok(g, res, v):
        return res_ln_backward_plain(g, res, v, gamma, beta,
                                     res_every=res_every, rate=rate,
                                     seed=seed, layer=layer, site=site)
    R, D = _ln_args(res, v, res_every)
    dev = v.device
    seed = device_seed(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty(R, D, **f32)
    dv = torch.empty(R, D, **f32)
    dgb = torch.zeros(2, D, **f32)
    if R:
        lib = _build.load("rows_ln")
        blocks = lib.gt_k20_bwd_blocks(R, D)
        if blocks < 1:
            raise NotImplementedError(
                f"D={D}: K20's backward takes rows of at most "
                f"{LN_BWD_MAX_D} columns")
        part = torch.empty(blocks * 2 * D, **f32)
        res = res.contiguous()
        err = lib.gt_k20_ln_bwd(
            g.to(torch.float32).contiguous().data_ptr(), res.data_ptr(),
            int(res.dtype == torch.bfloat16), res_every,
            v.to(torch.float32).contiguous().data_ptr(),
            _f32(gamma).data_ptr(), _f32(beta).data_ptr(), du.data_ptr(),
            dv.data_ptr(), part.data_ptr(), dgb.data_ptr(), R, D, blocks,
            *_drop_key(rate, seed, layer, site), _build.stream_ptr(dev))
        _build.check(err, "K20 LayerNorm backward")
        K20.launches += 1
    return du, dv, dgb[0], dgb[1]


# ========================================================== compositions
def layer_forward_rows(x, p: Sequence[torch.Tensor], S: int, *, layer: int,
                       rate: float, seed: Optional[int], bf16: bool,
                       slot0: bool, keep: bool = False):
    """One encoder layer over rows ``x`` [N·S, D] (any float dtype, values
    as given), ``p`` the layer's 12 tensors in KERNEL_ORDER: the out rows
    [N·S, D] ([N, D] for ``slot0``) float32, and with ``keep`` the dict of
    what the backward reads (qkv, ctx, a, y1, h, z)."""
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    every = S if slot0 else 1
    qkv = _qkv_rows(x, w_in, b_in, S, bf16, slot0)
    ctx = attention_forward(qkv, S, slot0=slot0, rate=rate, seed=seed,
                            layer=layer, bf16=bf16)
    a = gemm(ctx, w_out, bf16=bf16, bias=b_out)
    y1 = res_ln_forward(x, a, g1, c1, res_every=every, rate=rate, seed=seed,
                        layer=layer, site=OUT_SITE)
    h, z = _ffn_hidden(y1, w1, b1, w2, b2, bf16, rate, seed, layer)
    if keep:
        return dict(qkv=qkv, ctx=ctx, a=a, y1=y1, h=h, z=z)
    return res_ln_forward(y1, z, g2, c2, rate=rate, seed=seed, layer=layer,
                          site=FFN_SITE)


def layer_backward_rows(x, g, p: Sequence[torch.Tensor], S: int, *,
                        layer: int, rate: float, seed: Optional[int],
                        bf16: bool, slot0: bool, need_dx: bool = True):
    """The backward of :func:`layer_forward_rows`, recomputed from the
    layer input ``x`` [N·S, D]: ``g`` the out rows' cotangent [N·S, D]
    ([N, D] for ``slot0``).  Returns (dx [N·S, D] float32, or None without
    ``need_dx``, the 12 gradients in KERNEL_ORDER)."""
    (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = p
    every = S if slot0 else 1
    r = layer_forward_rows(x, p, S, layer=layer, rate=rate, seed=seed,
                           bf16=bf16, slot0=slot0, keep=True)
    kw = dict(rate=rate, seed=seed, layer=layer)
    du2, dz, dg2, dc2 = res_ln_backward(g, r["y1"], r["z"], g2, c2,
                                        site=FFN_SITE, **kw)
    keep = 1.0 - rate if rate > 0.0 else 1.0
    dh = gemm(dz, w2, "nt", bf16=bf16, gate=r["h"], gate_keep=keep)
    dy1 = gemm(dh, w1, "nt", bf16=bf16, add=du2)
    du1, da, dg1, dc1 = res_ln_backward(dy1, x, r["a"], g1, c1,
                                        res_every=every, site=OUT_SITE, **kw)
    dctx = gemm(da, w_out, "nt", bf16=bf16)
    dqkv = attention_backward(r["qkv"], dctx, S, slot0=slot0, bf16=bf16,
                              **kw)
    dx = (gemm(dqkv, w_in, "nt", bf16=bf16, add=du1, add_every=every)
          if need_dx else None)
    dw_in, db_in = _w_in_grad(x, dqkv, S, bf16, slot0)
    dw_out, db_out = weight_grad(r["ctx"], da, bf16=bf16)
    dw1, db1 = weight_grad(r["y1"], dh, bf16=bf16)
    dw2, db2 = weight_grad(r["h"], dz, bf16=bf16)
    return dx, (dw_in, db_in, dw_out, db_out, dg1, dc1, dw1, db1, dw2, db2,
                dg2, dc2)


def _qkv_rows(x, w_in, b_in, S: int, bf16: bool, slot0: bool):
    """QKV [N·S, 3D] float32; in the slot-0 layer q is formed on slot 0's
    rows only, its other rows left unwritten."""
    if not slot0:
        return gemm(x, w_in, bf16=bf16, bias=b_in)
    D = x.shape[1]
    qkv = torch.empty(x.shape[0], 3 * D, dtype=torch.float32,
                      device=x.device)
    gemm(x[::S], w_in[:, :D], bf16=bf16, bias=b_in[:D], out=qkv[::S, :D])
    gemm(x, w_in[:, D:], bf16=bf16, bias=b_in[D:], out=qkv[:, D:])
    return qkv


def _w_in_grad(x, dqkv, S: int, bf16: bool, slot0: bool):
    """(dW_in, db_in); in the slot-0 layer the q columns from slot 0's
    rows (dq is zero on the others)."""
    if not slot0:
        return weight_grad(x, dqkv, bf16=bf16)
    D = x.shape[1]
    dwq, dbq = weight_grad(x[::S], dqkv[::S, :D], bf16=bf16)
    dwkv, dbkv = weight_grad(x, dqkv[:, D:], bf16=bf16)
    return torch.cat([dwq, dwkv], 1), torch.cat([dbq, dbkv])


def _layer_params(params, t):
    return [a[t % a.shape[0]].to(torch.float32) for a in params]


def encoder_train_rows(x2d, params: Sequence[torch.Tensor], S: int, T: int,
                       rate: float = 0.0, seed: Optional[int] = None):
    """K4t's contract past D = 128: T layers over ``x2d`` [N·S, D] (the
    12 stacked tensors, timestep t on slice ``t % stored``), the last for
    slot 0: ``(out [N, D] float32, xs [T-1, N·S, D])`` with ``xs`` the
    inputs of layers 1..T-1 in ``x2d``'s dtype."""
    check_rows_shapes(S)
    _build.check_rows_dtype(x2d)
    if x2d.shape[0] % S:
        raise ValueError("x2d rows must be a multiple of seq_len")
    bf16 = x2d.dtype == torch.bfloat16
    h, xs = x2d, []
    for t in range(T):
        if t > 0:
            xs.append(h.to(x2d.dtype))
        h = layer_forward_rows(h, _layer_params(params, t), S, layer=t,
                               rate=rate, seed=seed, bf16=bf16,
                               slot0=(t == T - 1))
    xs = torch.stack(xs) if xs else x2d.new_empty(0, *x2d.shape)
    return h, xs


def recompute_backward_rows(x, g, params: Sequence[torch.Tensor], layer: int,
                            rate: float, seed: Optional[int], slot0: bool,
                            need_dx: bool = True):
    """K8's (``slot0``: K8s's) contract past D = 128: x [N, S, D] the
    saved input, g [N, S, D] ([N, D] for ``slot0``), ``params`` the 12
    stacked tensors (slice ``layer % stored``).  Returns (dx [N, S, D]
    float32, or None without ``need_dx``, 12 grads in KERNEL_ORDER)."""
    N, S, D = x.shape
    check_rows_shapes(S)
    _build.check_rows_dtype(x)
    dx, grads = layer_backward_rows(
        x.reshape(N * S, D), g.reshape(-1, D).to(torch.float32),
        _layer_params(params, layer), S, layer=layer, rate=rate, seed=seed,
        bf16=x.dtype == torch.bfloat16, slot0=slot0, need_dx=need_dx)
    return (None if dx is None else dx.view(N, S, D)), grads


def layer_rows_forward(x2d, params: Sequence[torch.Tensor], S: int,
                       rate: float = 0.0, seed: Optional[int] = None,
                       layer: int = 0):
    """K9's contract past D = 128: every row out, in ``x2d``'s dtype."""
    check_rows_shapes(S)
    _build.check_rows_dtype(x2d)
    out = layer_forward_rows(x2d, [a.to(torch.float32) for a in params], S,
                             layer=layer, rate=rate, seed=seed,
                             bf16=x2d.dtype == torch.bfloat16, slot0=False)
    return out.to(x2d.dtype)


def layer_rows_backward(x2d, dout, params: Sequence[torch.Tensor], S: int,
                        rate: float = 0.0, seed: Optional[int] = None,
                        layer: int = 0):
    """K10's contract past D = 128: ``(dx in x2d's dtype, 12 grads)``,
    ``dout`` taken in ``x2d``'s dtype."""
    check_rows_shapes(S)
    _build.check_rows_dtype(x2d)
    g = dout.to(x2d.dtype).to(torch.float32)
    dx, grads = layer_backward_rows(
        x2d, g, [a.to(torch.float32) for a in params], S, layer=layer,
        rate=rate, seed=seed, bf16=x2d.dtype == torch.bfloat16, slot0=False)
    return dx.to(x2d.dtype), grads


def _ffn_hidden(x, w1, b1, w2, b2, bf16, rate, seed, layer):
    h = gemm(x, w1, bf16=bf16, bias=b1, relu=True,
             drop=(rate, seed, layer, HIDDEN_SITE) if rate > 0 else None)
    return h, gemm(h, w2, bf16=bf16, bias=b2)


def ffn_rows_forward(x, w1, b1, w2, b2, gamma, beta, rate: float = 0.0,
                     seed: Optional[int] = None, layer: int = 0):
    """K11's contract past D = 128: ``LN(x + drop(drop(relu(x W1 + b1))
    W2 + b2))`` in ``x``'s dtype."""
    _build.check_rows_dtype(x)
    bf16 = x.dtype == torch.bfloat16
    _, z = _ffn_hidden(x, w1, b1, w2, b2, bf16, rate, seed, layer)
    out = res_ln_forward(x, z, gamma, beta, rate=rate, seed=seed,
                         layer=layer, site=FFN_SITE)
    return out.to(x.dtype)


def ffn_rows_backward(x, dout, w1, b1, w2, b2, gamma, beta,
                      rate: float = 0.0, seed: Optional[int] = None,
                      layer: int = 0):
    """K12's contract past D = 128: ``(dx in x's dtype, (dW1, db1, dW2,
    db2, dγ, dβ) float32)``, ``dout`` taken in ``x``'s dtype."""
    _build.check_rows_dtype(x)
    bf16 = x.dtype == torch.bfloat16
    h, z = _ffn_hidden(x, w1, b1, w2, b2, bf16, rate, seed, layer)
    g = dout.to(x.dtype).to(torch.float32)
    du, dz, dg, dbeta = res_ln_backward(g, x, z, gamma, beta, rate=rate,
                                        seed=seed, layer=layer,
                                        site=FFN_SITE)
    keep = 1.0 - rate if rate > 0.0 else 1.0
    dh = gemm(dz, w2, "nt", bf16=bf16, gate=h, gate_keep=keep)
    dx = gemm(dh, w1, "nt", bf16=bf16, add=du)
    dw1, db1 = weight_grad(x, dh, bf16=bf16)
    dw2, db2 = weight_grad(h, dz, bf16=bf16)
    return dx.to(x.dtype), (dw1, db1, dw2, db2, dg, dbeta)
