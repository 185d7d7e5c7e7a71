#!/usr/bin/env python3
"""Probe of the port's wide-row kernels on one NVIDIA H100 (run on the card):

    python3 scripts/torch_wide_probe.py

1. K5/K6 against K1/K2/K3 where both training paths run, at the MUTAG-like
   shape (N=1000, S=9, D=7, F=1024, T=4) and at the bench shape (N=8832,
   D=4, the constant 0.01 codebook of bench.py): device time per launch from
   torch.profiler, in turns (folded, wide, wide, folded).
2. K5, K6 (layer 0 and the slot-0 last layer) and the wide K4 at
   IMDBBINARY's width (N=4096, S=9, D=65 one-hot, F=1024, T=4): device
   time, bytes and bf16 FLOPs, their bound at the data sheet's rates, and
   the stored hidden h's share of K5's bytes.
3. How far bf16 alone spreads the wide forward (D=65 and D=128, N=4096):
   K5 against its plain version on the card, and the plain version on the
   CPU against the same on the card (relative L2 error, share of outputs
   beyond 2e-2, max).

Prints one line a measurement, the card's name and power limit, and a JSON
line of every number.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from graph_transformer_tpu_torch.ops import sampled_encoder as se  # noqa: E402
from graph_transformer_tpu_torch.ops import stored_encoder as st  # noqa: E402
from graph_transformer_tpu_torch.ops.u2gnn_encoder import wide_encoder  # noqa: E402

S, F, T, SEED = 9, 1024, 4, 99


def residual_args(res, t, g, keys):
    return tuple(res[k][t] for k in keys) + (g,)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from graph_transformer_tpu_torch.ops import _build

    _build.build_all()
    out = {}

    # ---- 1. both paths where both run
    k1 = ("xs", "qkv", "attn", "strip")
    k5 = k1 + ("h",)
    bwd = ("gt_layer_bwd_kernel", "gt_reduce_partials_kernel")
    wbwd = ("wd_stored_bwd_kernel", "wd_reduce_small_kernel",
            "wd_wgrad_mma_kernel", "gt_reduce_partials_kernel")
    for label, N, D, C in (("mutag-like", 1000, 7, 7), ("bench", 8832, 4, 1)):
        si, params, _ = cs.random_case(N=N, S=S, D=D, C=C, F=F, Tn=T,
                                       stored=1, seed=3, dev=dev)
        if label == "bench":
            si = si[:3] + (torch.full((1, D), 0.01, device=dev),)
        _, r1 = se.sampled_forward(*si, params, S, T, 0.5, SEED)
        _, r5 = st.stored_forward(*si, params, S, T, 0.5, SEED)
        g2 = torch.randn(N, S, D, device=dev)
        g3 = torch.randn(N, D, device=dev)
        pairs = {
            "fwd": ((lambda: se.sampled_forward(*si, params, S, T, 0.5, SEED),
                     ("gt_encoder_fwd_kernel",)),
                    (lambda: st.stored_forward(*si, params, S, T, 0.5, SEED),
                     ("wd_encoder_fwd_kernel",))),
            "layer_bwd": ((lambda: se.layer_backward(
                *residual_args(r1, 0, g2, k1), params, 0, 0.5, SEED), bwd),
                (lambda: st.stored_layer_backward(
                    *residual_args(r5, 0, g2, k5), params, 0, 0.5, SEED),
                 wbwd)),
            "slot0_bwd": ((lambda: se.slot0_backward(
                *residual_args(r1, T - 1, g3, k1), params, T - 1, 0.5, SEED),
                bwd),
                (lambda: st.stored_slot0_backward(
                    *residual_args(r5, T - 1, g3, k5), params, T - 1, 0.5,
                    SEED), wbwd)),
        }
        for name, ((fa, ka), (fb, kb)) in pairs.items():
            a1 = cs.device_ms(fa, 10, ka)
            b1 = cs.device_ms(fb, 10, kb)
            b2 = cs.device_ms(fb, 10, kb)
            a2 = cs.device_ms(fa, 10, ka)
            out[f"{label}_{name}"] = {"folded_ms": [a1, a2],
                                      "wide_ms": [b1, b2]}
            print(f"# {label} {name}: folded (K1-K3) {a1:.4f} {a2:.4f} ms, "
                  f"wide (K5/K6) {b1:.4f} {b2:.4f} ms, ratio "
                  f"{(b1 + b2) / (a1 + a2):.2f}", flush=True)
        h5 = sum(cs.nbytes(t) for t in r5["h"])
        all5 = sum(cs.nbytes(t) for k in k5 for t in r5[k])
        out[f"{label}_h_share"] = h5 / all5
        print(f"# {label} K5 residuals: {all5} bytes, h {h5} "
              f"({h5 / all5:.3f})", flush=True)

    # ---- 2. the wide kernels at IMDBBINARY's width
    N, D = 4096, 65
    si, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                   seed=4, dev=dev, one_hot=True)
    o5, r5 = st.stored_forward(*si, params, S, T, 0.5, SEED)
    g2 = torch.randn(N, S, D, device=dev)
    g3 = torch.randn(N, D, device=dev)
    x2d = r5["xs"][0].reshape(N * S, D)
    pb = cs.nbytes(*params)
    P = sum(p[0].numel() for p in params)
    h5 = sum(cs.nbytes(t) for t in r5["h"])
    b5 = (cs.nbytes(*si[1:]) + N * (S - 1) * 4 + pb
          + cs.nbytes(o5, r5["draws"].int())
          + sum(cs.nbytes(t) for k in k5 for t in r5[k]))
    a6 = residual_args(r5, 0, g2, k5)
    a6s = residual_args(r5, T - 1, g3, k5)
    calls = {
        "K5": (lambda: st.stored_forward(*si, params, S, T, 0.5, SEED),
               ("wd_encoder_fwd_kernel",), b5, cs.fwd_flops(N, S, D, F, T)),
        "K6": (lambda: st.stored_layer_backward(*a6, params, 0, 0.5, SEED),
               wbwd, cs.nbytes(*a6) + pb + cs.nbytes(g2) + 4 * P,
               N * S * (8 * D * F + 16 * D * D + 8 * S * D)),
        "K6s": (lambda: st.stored_slot0_backward(*a6s, params, T - 1, 0.5,
                                                 SEED),
                wbwd, cs.nbytes(*a6s) + pb + cs.nbytes(g2) + 4 * P,
                N * (8 * D * F + 4 * D * D + 8 * S * D)
                + N * S * 12 * D * D),
        "K4w": (lambda: wide_encoder(x2d, params, S, T),
                ("wd_encoder_fwd_kernel",),
                cs.nbytes(x2d) + pb + N * D * 4, cs.fwd_flops(N, S, D, F, T)),
    }
    for key, (fn, names, b, f) in calls.items():
        ms = cs.device_ms(fn, 10, names)
        bms, by = cs.bound(b, f)
        out[f"imdb_{key}"] = {"ms": ms, "bytes": b, "flops": f,
                              "bound_ms": bms, "bound_by": by}
        print(f"# imdb-width {key}: {ms:.4f} ms/launch, {b} bytes, {f} "
              f"FLOPs, bound {bms:.5f} ms by {by}", flush=True)
    out["imdb_h_share"] = h5 / b5
    print(f"# imdb-width K5 bytes {b5}, h {h5} ({h5 / b5:.3f})", flush=True)

    # ---- 3. bf16's own spread of the wide forward
    for D, one_hot in ((65, True), (128, False)):
        si, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T,
                                       stored=T, seed=1, dev=dev,
                                       one_hot=one_hot)
        sic = tuple(t.cpu() for t in si)
        pc = [p.cpu() for p in params]
        for rate in (0.0, 0.5):
            ok = st.stored_forward(*si, params, S, T, rate, 5)[0]
            og = st.stored_forward_plain(*si, params, S, T, rate, 5)[0]
            oc = st.stored_forward_plain(*sic, pc, S, T, rate, 5)[0].to(dev)
            for name, a, b in (("kernel_vs_plain_card", ok, og),
                               ("plain_cpu_vs_plain_card", oc, og)):
                d = (a - b).abs()
                row = {"rel_l2": float(d.norm() / b.norm()),
                       "share_beyond_2e-2": float(
                           (d > 2e-2 + 2e-2 * b.abs()).float().mean()),
                       "max": float(d.max())}
                out[f"spread_d{D}_rate{rate}_{name}"] = row
                print(f"# bf16 spread D={D} rate {rate} {name}: {row}",
                      flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out["card"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
