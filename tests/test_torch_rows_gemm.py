"""K18's float32 arithmetic and the slot-0 layer's queries
(``ops/csrc/rows_gemm.cu``, ``ops/rows_encoder.py``), on the CPU.

1. K18's float32 products run on the tensor cores as 3xTF32: each operand x
   splits into hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``:
   to nearest, ties away from zero, on the 13 low mantissa bits), and
   ``mma.sync`` m16n8k8 sums lo·hi, hi·lo, then hi·hi over each 8 of K.  The
   tensor cores' additions are modelled as exact, then rounded toward zero
   to float32 (the pessimistic reading of their accumulator; chained over
   all of K it is what the card shows, ``PERF.md`` PR 17).  Each 32 of K
   sums from zero and is then added to the output in float32, rounded to
   nearest, as the kernel does.  That emulation, on node-like operands (0/1
   features, Glorot weights; dqkv-like cotangents) and on the card checks'
   operands at K = 1,433, 3,703 and 14,080, is held to
   ``chip_smoke.check_rows_forward``'s float32 rule (within 1e-4, relative
   L2 <= 1e-5) against float64; one accumulator chained over all of K misses
   it at K = 3,703.
2. The slot-0 layer forms q on slot 0's rows only: its forward and all 12
   gradients equal the formulation that forms q on every row (the parent
   design), float32 and bf16, rates 0 and 0.5, within 1e-6.
3. K18's bf16 products round each operand element once to bf16 (to
   nearest even; ``rg_pack_kernel``) and run ``wgmma`` m64n128k16
   (``rg_wgmma_bf16_kernel``): 16 products of bf16 values, exact, added to
   one float32 accumulator chained over the block's K, two such a step of
   32; the weight products split
   their rows into chunks (``rg_bf16_chunks``, emulated here) summed in chunk
   order in float32.  The tensor cores' additions are modelled as above
   (exact, then rounded toward zero).  On bf16-rounded operands at K =
   1,433, 3,703 and 14,080 that emulation is held against float64 of the
   same rounded operands to ``chip_smoke.check_bf16_spread``'s rule, and
   within relative L2 1e-5 (the float32 forward rule, far inside it).
"""

import math

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.ops import rows_encoder as rows

FWD_MAX, FWD_REL = 1e-4, 1e-5  # chip_smoke.check_rows_forward, float32
STEP = 32  # K a step of the kernel: its per-step sums start from zero


# ======================================================== 1. 3xTF32 emulation
def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on float32 values: add half of the 13 dropped
    bits to the magnitude, then drop them (ties away from zero)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def round_toward_zero(s: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def emulate_3xtf32(a: np.ndarray, b: np.ndarray, chained: bool = False):
    """C = a @ b (a [M, K], b [K, N] float32) as K18's float32 kernel sums
    it; ``chained``: one accumulator over all of K instead of per-step
    sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    M, K = a.shape
    acc = np.zeros((M, b.shape[1]), np.float32)
    s = np.zeros_like(acc)
    for k0 in range(0, K, 8):
        k = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = x[:, k].astype(np.float64) @ y[k].astype(np.float64)
            s = round_toward_zero(s.astype(np.float64) + part)
        if not chained and ((k0 + 8) % STEP == 0 or k0 + 8 >= K):
            acc = acc + s
            s = np.zeros_like(s)
    return s if chained else acc


def distance(got, a, b):
    want = a.astype(np.float64) @ b.astype(np.float64)
    d = np.abs(got.astype(np.float64) - want)
    return float(d.max()), float(np.linalg.norm(d) / np.linalg.norm(want))


def operands(kind: str, K: int, rng):
    """(a [16, K], b [K, 16]) float32: ``node`` a node step's forward (0/1
    features of Cora's density, a Glorot W_in); ``node_dw`` its dW_in (x's
    0/1 columns against dqkv-like cotangents); ``rows`` the card checks'
    (randn rows, weights 0.3 / sqrt(K / 6)); ``rows_dw`` randn rows against
    the cotangents."""
    if kind == "node":
        a = (rng.random((16, K)) < 0.0127).astype(np.float32)
        lim = math.sqrt(6.0 / (K + 3 * K))
        b = rng.uniform(-lim, lim, (K, 16)).astype(np.float32)
    elif kind == "node_dw":
        a = (rng.random((16, K)) < 0.0127).astype(np.float32)
        b = (rng.standard_normal((K, 16)) * 1e-2).astype(np.float32)
    elif kind == "rows":
        a = rng.standard_normal((16, K)).astype(np.float32)
        b = (rng.standard_normal((K, 16)) * 0.3 / math.sqrt(K / 6.0)
             ).astype(np.float32)
    else:
        a = rng.standard_normal((16, K)).astype(np.float32)
        b = (rng.standard_normal((K, 16)) * 1e-2).astype(np.float32)
    return a, b


def test_tf32_rounds_to_nearest_ties_away():
    """The 13 dropped bits: below half truncates, half and above round the
    magnitude up, a carry moves the exponent, signs alike."""
    one = np.float32(1.0).view(np.uint32)
    cases = {0x0FFF: 0, 0x1000: 0x2000, 0x1001: 0x2000, 0x1FFF: 0x2000,
             0x2FFF: 0x2000, 0x3000: 0x4000}
    for low, up in cases.items():
        x = np.uint32(one + low).view(np.float32)
        want = np.uint32(one + up).view(np.float32)
        assert tf32(np.array([x, -x])).tolist() == [want, -want]
    top = np.uint32(0x3FFFF000).view(np.float32)  # just under 2
    assert tf32(np.array([top]))[0] == 2.0
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(x)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    # hi + lo keeps ~22 bits: the split's own error
    lo = tf32(x - hi)
    err = np.abs(x.astype(np.float64) - hi - lo)
    assert np.all(err <= np.abs(x) * 2.0 ** -21)


@pytest.mark.parametrize("kind,K", [("node", 1433), ("rows", 1433),
                                    ("rows", 3703), ("node_dw", 14080),
                                    ("rows_dw", 14080)])
def test_3xtf32_per_step_sums_hold_the_float32_rule(kind, K):
    """256 outputs of the kernel's arithmetic against float64, within
    ``check_rows_forward``'s float32 rule, and no farther than 2x a float32
    product summed in order."""
    rng = np.random.default_rng(K + len(kind))
    a, b = operands(kind, K, rng)
    mx, rel = distance(emulate_3xtf32(a, b), a, b)
    assert mx <= FWD_MAX and rel <= FWD_REL, (mx, rel)
    ordered = np.zeros((16, 16), np.float32)
    for k in range(K):
        ordered = ordered + np.outer(a[:, k], b[k])
    assert rel <= 2 * max(distance(ordered, a, b)[1], 1e-8), rel


def test_3xtf32_chained_accumulation_misses_the_rule():
    """Why the kernel sums each 32 of K from zero: one accumulator over all
    of K = 3,703, rounded toward zero at each product, misses the
    relative-L2 rule that the per-step sums hold 30x inside."""
    a, b = operands("rows", 3703, np.random.default_rng(3703 + 4))
    _, rel_chained = distance(emulate_3xtf32(a, b, chained=True), a, b)
    _, rel_steps = distance(emulate_3xtf32(a, b), a, b)
    assert rel_chained > FWD_REL > 30 * rel_steps, (rel_chained, rel_steps)


# ================================= 2. the slot-0 layer's q on slot 0's rows
S, N, F = 5, 8, 32


def layer_params(D, seed):
    rng = np.random.default_rng(seed)
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,),
              (F, D), (D,), (D,), (D,))
    scale = 0.3 / np.sqrt(D / 6.0)
    p = [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
         for s in shapes]
    p[4] += 1.0
    p[10] += 1.0
    return p


def full_q_rows(x, w_in, b_in, S_, bf16, slot0):
    return rows.gemm(x, w_in, bf16=bf16, bias=b_in)


def full_q_grad(x, dqkv, S_, bf16, slot0):
    return rows.weight_grad(x, dqkv, bf16=bf16)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 160])
def test_slot0_queries_equal_full_queries(monkeypatch, D, dtype, rate):
    """The slot-0 layer (q = x[::S] W_in[:, :D] over N rows, k and v over
    N·S; dW_in's q columns from slot 0's rows) against the layer that forms
    q on every row and feeds dq's zero rows to dW_in: forward, dx and the
    12 gradients within 1e-6."""
    p = layer_params(D, D + 1)
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((N * S, D), np.float32)).to(
        getattr(torch, dtype))
    g = torch.from_numpy(rng.standard_normal((N, D), np.float32))
    kw = dict(layer=0, rate=rate, seed=11, bf16=dtype == "bfloat16",
              slot0=True)

    def run():
        out = rows.layer_forward_rows(x, p, S, **kw)
        dx, grads = rows.layer_backward_rows(x, g, p, S, **kw)
        return out, dx, grads

    out, dx, grads = run()
    qkv = rows._qkv_rows(x, p[0], p[1], S, kw["bf16"], True)
    assert qkv.shape == (N * S, 3 * D)
    monkeypatch.setattr(rows, "_qkv_rows", full_q_rows)
    monkeypatch.setattr(rows, "_w_in_grad", full_q_grad)
    out_f, dx_f, grads_f = run()
    qkv_f = rows._qkv_rows(x, p[0], p[1], S, kw["bf16"], True)
    # q on slot 0's rows and k, v on every row are the full product's
    assert float((qkv[::S, :D] - qkv_f[::S, :D]).abs().max()) <= 1e-6
    assert float((qkv[:, D:] - qkv_f[:, D:]).abs().max()) <= 1e-6
    assert out.shape == (N, D)
    assert float((out - out_f).abs().max()) <= 1e-6
    assert float((dx - dx_f).abs().max()) <= 1e-6
    assert len(grads) == len(grads_f) == 12
    for a, b in zip(grads, grads_f):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6


# =========================================== 3. the bf16 products' sum order
def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest, ties to even), as
    float32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    up = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1)))
    return (up & np.uint32(0xFFFF0000)).view(np.float32)


def bf16_chunks(M: int, N: int, K: int) -> int:
    """``rows_gemm.cu``'s ``rg_bf16_chunks``: of 1 to 8 chunks of at least
    512 rows, the fewest waves of 132 blocks of 256 x 128 a chunk's share,
    plus 0.05 a chunk."""
    tiles = -(-M // 256) * -(-N // 128)
    most = max(1, min(8, K // 512))
    costs = [((tiles * c + 131) // 132) / c + 0.05 * c
             for c in range(1, most + 1)]
    return 1 + min(range(most), key=lambda i: (costs[i] + 1e-9 * i))


def emulate_bf16(a: np.ndarray, b: np.ndarray, chunks: int = 1):
    """C = a @ b (a [M, K], b [K, N] float32) as K18's bf16 kernel sums it:
    operands rounded to bf16; per chunk of rows (``kchunk`` = K / chunks
    rounded up to a step of 32) one accumulator from zero, each 16 of K
    added exactly then rounded toward zero; the chunks' sums added in
    order, rounded to nearest."""
    ab, bb = bf16(a).astype(np.float64), bf16(b).astype(np.float64)
    K = a.shape[1]
    kchunk = -(-(-(-K // chunks)) // STEP) * STEP
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, K, kchunk):
        acc = np.zeros_like(out)
        for k0 in range(c0, min(K, c0 + kchunk), 16):
            k = slice(k0, min(K, c0 + kchunk, k0 + 16))
            acc = round_toward_zero(acc.astype(np.float64)
                                    + ab[:, k] @ bb[k])
        out = out + acc
    return out


def test_bf16_rounds_to_nearest_even():
    """The 16 dropped bits: below half truncates, above half rounds the
    magnitude up, half to the even neighbour; torch's bf16 cast agrees."""
    one = np.float32(1.0).view(np.uint32)
    cases = {0x7FFF: 0, 0x8000: 0, 0x8001: 0x10000, 0x18000: 0x20000,
             0x17FFF: 0x10000}
    for low, up in cases.items():
        x = np.uint32(one + low).view(np.float32)
        want = np.uint32(one + up).view(np.float32)
        assert bf16(np.array([x, -x])).tolist() == [want, -want]
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    ref = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(bf16(x), ref)


def test_bf16_chunks_of_the_node_step():
    """The weight products' chunks at the node step's shapes (N = 2,816,
    S = 5, D = 1,433, F = 1,024): dW_in's k, v over 14,080 rows in 4, the
    others over 2,816 rows in 2 or 3."""
    assert bf16_chunks(1433, 2866, 14080) == 4
    assert bf16_chunks(1433, 1433, 2816) == 3
    assert bf16_chunks(1433, 1024, 2816) == 2
    assert bf16_chunks(1024, 1433, 2816) == 2
    assert bf16_chunks(100, 100, 400) == 1


@pytest.mark.parametrize("kind,K", [("node", 1433), ("rows", 1433),
                                    ("rows", 3703), ("node_dw", 14080),
                                    ("rows_dw", 14080)])
def test_bf16_chained_sums_hold_the_bf16_rule(kind, K):
    """256 outputs of the bf16 kernel's arithmetic (chunks as the weight
    products' at 14,080 rows) against float64 on the same bf16-rounded
    operands: ``check_bf16_spread``'s rule (relative L2 <= 1e-2, at most 1%
    beyond 2e-2 + 2e-2 |ref|), and within relative L2 1e-5."""
    rng = np.random.default_rng(K + 7 * len(kind))
    a, b = operands(kind, K, rng)
    chunks = bf16_chunks(1433, 2866, K) if K == 14080 else 1
    got = emulate_bf16(a, b, chunks).astype(np.float64)
    want = bf16(a).astype(np.float64) @ bf16(b).astype(np.float64)
    d = np.abs(got - want)
    rel = float(np.linalg.norm(d) / np.linalg.norm(want))
    frac = float(np.mean(d > 2e-2 + 2e-2 * np.abs(want)))
    assert rel <= 1e-2 and frac <= 1e-2, (rel, frac)
    assert rel <= 1e-5, rel
