#!/usr/bin/env python3
"""How far each float32 sum order of the wide forward's products moves the
encoder's output from the float64 function, on the CPU:

    python3 scripts/torch_f32_sum_orders.py [--orders a,b,...] [N S D F T CASE DROP ONE_HOT ...]

Runs the plain post-norm layer stack (the port's ``layer_forward`` steps,
float32 rows from ``chip_smoke.random_case(seed=CASE, one_hot=ONE_HOT)``,
dropout seed DROP at rate 0 and 0.5, the last layer for slot 0) with its
four products computed in each order and prints, per case and rate, the
max |out - float64| of the plain float32 version and each order's multiple
of it, the quantity the float32 forward checks hold within 2
(``chip_smoke.check_forward``):

- ``fma``: FMAs in K order over the whole of K;
- ``u128``, ``u32``, ``u16``: FMAs in K order over each unit of 128, 32 or
  16 K values from zero, the units' partials added in K order by float32
  adds (``u128`` is the CUDA-core layer's order, ``wd_gemm``: one chain
  over each 128-column hidden chunk of h W2, one over all of K = D for the
  other products);
- ``exact``: each product's exact sum rounded once to float32;
- ``exact_w2``: h W2 exact, the K = D products FMAs in K order;
- ``exact_kd``: the K = D products exact, h W2 as ``u128``;
- ``x3chain``: 3xTF32 (hi = tf32(x), lo = tf32(x - hi); lo*hi, hi*lo, hi*hi)
  in one accumulator over K, each k8 ``mma`` rounding C plus its 8 exact
  products toward zero (the tensor cores' accumulation);
- ``x3fresh``: the same products, each k8 step's three from a zero tile,
  the step's sum added in float32 round to nearest;
- ``x4fresh``: as x3fresh with each weight split exactly into three TF32
  parts (hi, mid, lo), four products a step.

The default cases are the float32 card tests'
(``test_wide_two_pass_kernels_match_plain_versions[9-68-float32]``; the
quickstart batch of ``test_wide_forward_kernels_at_quickstart_batch``;
K17's float32 rows in ``test_stored_rows_kernel_matches_k5_and_plain``).
The plain version here is the CPU's float32 matmul, FMAs in K order at
these sizes; on the card it is cuBLAS's, whose own distance differs.
"""
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from graph_transformer_tpu_torch.ops.attention import (  # noqa: E402
    dropout, layer_norm)

DEFAULT_CASES = [(301, 9, 68, 256, 3, 1, 97531, 0),
                 (640, 9, 68, 1024, 4, 3, 97531, 0),
                 (301, 9, 68, 256, 3, 5, 24680, 1)]


def tf32(a):
    """Round to TF32 (10 mantissa bits), to nearest, ties away (cvt.rna)."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a):
    hi = tf32(a)
    return hi.double(), tf32(a - hi).double()


def to_zero(v):
    """float64 to float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mm_fma(a, b):
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k:k + 1].double()
               * b[k:k + 1].double()).float()
    return acc


def mm_units(a, b, unit):
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], unit):
        part = mm_fma(a[:, k0:k0 + unit], b[k0:k0 + unit])
        acc = acc + part if k0 else part
    return acc


def mm_exact(a, b):
    return (a.double() @ b.double()).float()


def mm_x3(a, b, fresh, exact_b=False):
    ah, al = split(a)
    bh, bm = split(b)
    # exact_b: b = hi + mid + lo exactly; hi*lo, lo*hi, hi*mid, hi*hi
    pairs = (((ah, b.double() - bh - bm), (al, bh), (ah, bm), (ah, bh))
             if exact_b else ((al, bh), (ah, bm), (ah, bh)))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        t = torch.zeros_like(acc) if fresh else acc
        for x, y in pairs:
            t = to_zero(t.double() + x[:, s] @ y[s])
        acc = (acc.double() + t.double()).float() if fresh else t
    return acc


ORDERS = {"fma": mm_fma, "exact": mm_exact,
          "u128": lambda a, b: mm_units(a, b, 128),
          "u32": lambda a, b: mm_units(a, b, 32),
          "u16": lambda a, b: mm_units(a, b, 16),
          "exact_w2": lambda a, b: mm_fma(a, b) if a.shape[1] <= 128
          else mm_exact(a, b),
          "exact_kd": lambda a, b: mm_exact(a, b) if a.shape[1] <= 128
          else mm_units(a, b, 128),
          "x3chain": lambda a, b: mm_x3(a, b, False),
          "x3fresh": lambda a, b: mm_x3(a, b, True),
          "x4fresh": lambda a, b: mm_x3(a, b, True, exact_b=True)}


def layer(x, p, t, rate, seed, mm, slot0):
    """layer_forward's float32 steps with the products through ``mm``."""
    N, S, D = x.shape
    w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2 = p

    def drop(v, site):
        return dropout(v, rate, seed, t, site)

    qkv = mm(x.reshape(N * S, D), w_in).view(N, S, 3 * D) + b_in
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    scale = 1.0 / math.sqrt(D)
    if slot0:
        s = (q[:, :1] @ k.transpose(1, 2))[:, 0] * scale
        ctx = (drop(torch.softmax(s, -1), 0)[:, None, :] @ v)[:, 0]
        x_res, R = x[:, 0], N
    else:
        s = (q @ k.transpose(1, 2)) * scale
        ctx = drop(torch.softmax(s, -1), 0) @ v
        x_res, R = x, N * S
    sh = ctx.shape
    a = drop(mm(ctx.reshape(R, D), w_out).view(sh) + b_out, 1)
    y1 = layer_norm(x_res + a, g1, c1)[0]
    h = drop(torch.relu(mm(y1.reshape(R, D), w1) + b1), 2)
    z = drop(mm(h, w2).view(sh) + b2, 3)
    return layer_norm(y1 + z, g2, c2)[0]


def run_case(N, S, D, F, T, case_seed, drop_seed, one_hot, orders=ORDERS):
    _, params, x2d = chip_smoke.random_case(
        N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T, seed=case_seed, dev="cpu",
        one_hot=bool(one_hot))
    x = x2d.float().view(N, S, D)
    for rate in (0.0, 0.5):
        def fwd(mm, f64=False):
            h = x.double() if f64 else x
            for t in range(T):
                p = [a[t].double() if f64 else a[t] for a in params]
                h = layer(h, p, t, rate, drop_seed, mm, t == T - 1)
            return h

        ref = fwd(lambda a, b: a @ b, f64=True)
        plain = float((fwd(lambda a, b: a @ b).double() - ref).abs().max())
        line = (f"N={N} S={S} D={D} F={F} T={T} case {case_seed}"
                f"{' one-hot' if one_hot else ''} rate {rate}: plain "
                f"{plain:.3e}")
        for name, mm in orders.items():
            e = float((fwd(mm).double() - ref).abs().max())
            line += f"; {name} {e:.3e} ({e / plain:.2f}x)"
        print(line, flush=True)


def main() -> int:
    args = sys.argv[1:]
    orders = ORDERS
    if args[:1] == ["--orders"]:
        orders = {k: ORDERS[k] for k in args[1].split(",")}
        args = args[2:]
    args = [int(a) for a in args]
    cases = ([tuple(args[i:i + 8]) for i in range(0, len(args), 8)]
             if args else DEFAULT_CASES)
    for case in cases:
        run_case(*case, orders=orders)
    return 0


if __name__ == "__main__":
    sys.exit(main())
