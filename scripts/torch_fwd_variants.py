#!/usr/bin/env python3
"""Variants of the D <= 32 forward layer's tensor-core FFN (``gt_ffn_tc``,
``graph_transformer_tpu_torch/ops/csrc/common.cuh``) against the committed
design, on one NVIDIA H100 (run on the card, from the root of a checkout):

    python3 scripts/torch_fwd_variants.py

Each variant is built from an edited copy of the sources (``nvcc``, the
port's flags, into ``build/fwd_variants/<variant>/``) and undoes one choice:

- ``chained``: float32 h W2 chained in the accumulators over a warp's units,
  not each unit from a zero tile added by FADD;
- ``branchy``: the hidden's dropout through ``gt_drop``, a branch around
  each quotient, and a mask drawn for padding rows too;
- ``mg8`` / ``mg1``: 8 / 1 m tiles of output sums a warp at a time, not 2;
- ``one_block``: the kernels compiled for 1 block an SM, not 2 (D <= 8).

For each and the committed design (``final``), with every launch sent to
the tensor cores: device ms a launch (``chip_smoke.device_ms``) of K4t at
the MUTAG HPO arm's batch (512 x S=17, D=6, T=5, float32; rate 0.5, rate 0,
and F=0, the attention part), of K4t with bf16 rows at 8,832 x S=9, D=4,
T=4, and of K9 at ACT's batch (512 x S=9, D=7, float32); on the float32
checks' cases, the distance from the float64 function of K4t's output and
last saved input and of K9's rows, as a multiple of the plain version's
(the float32 rule: within 1e-4 of the plain version, or 2x its distance);
whether the outputs equal the committed design's bit for bit.  Prints a line
a variant and case, the card's name and power limit, and writes every number
to ``chiprun_out/fwd_variants.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCES = ("encoder_fwd", "encoder_layer")
MG_FINAL = "static constexpr int MG = NTD == 1 ? 2 : 1;"
HIDDEN_FINAL = """            float v = fmaxf(hc[j][e] + f.b1[j][e & 1], 0.f);
            if (dr.on) {
              const float kept = v / dr.keep;
              bool keep = false;
              if (q < QR) keep = gt_keep(dr, kH, (qi0 + q) * (uint32_t)F + c);
              v = keep ? kept : 0.f;
            }"""
HIDDEN_BRANCHY = """            const float v = gt_drop(dr, kH, (qi0 + q) * (uint32_t)F + c,
                                    fmaxf(hc[j][e] + f.b1[j][e & 1], 0.f));"""
MIN_BLOCKS = "#define GT_FWD_MIN_BLOCKS(DM, MMA) ((MMA) && (DM) <= 8 ? 2 : 1)"
VARIANTS = {
    "final": [],
    "chained": [("gt_mma_step(p[nd], a, f.w2[s][nd], false);",
                 "gt_mma_step(z[mi][nd], a, f.w2[s][nd], false);")],
    "branchy": [(HIDDEN_FINAL, HIDDEN_BRANCHY)],
    "mg8": [(MG_FINAL, "static constexpr int MG = 8 / NTD;")],
    "mg1": [(MG_FINAL, "static constexpr int MG = 1;")],
    "one_block": [(MIN_BLOCKS, "#define GT_FWD_MIN_BLOCKS(DM, MMA) 1")],
}


def build(out_root: Path) -> None:
    """One nvcc per variant and source, all at once."""
    sys.path.insert(0, str(HERE))
    from graph_transformer_tpu_torch.ops import _build

    procs = []
    for name, edits in VARIANTS.items():
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "common.cuh").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the edit's text is not in common.cuh")
            src = src.replace(old, new)
        (d / "common.cuh").write_text(src)
        for s in SOURCES:
            procs.append((name, s, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                 str(d / f"{s}.so"), str(d / f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, s, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}/{s}:\n{log[-4000:]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops.attention import layer_forward
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train, u2gnn_encoder_train_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    root = HERE / "build" / "fwd_variants"
    build(root)
    dev = torch.device("cuda")
    fwd = ("gt_encoder_fwd_kernel",)

    def case(N, S, D, Tn, seed):
        _, p, x = cs.random_case(N=N, S=S, D=D, C=D, F=1024, Tn=Tn, stored=Tn,
                                 seed=seed, dev=dev)
        return p, x.float()

    ph, xh = case(512, 17, 6, 5, 31)
    ph0 = list(ph)
    ph0[6], ph0[7], ph0[8] = ph[6][..., :0], ph[7][..., :0], ph[8][..., :0, :]
    pb, xb = case(8832, 9, 4, 4, 33)
    xb = xb.to(torch.bfloat16)
    pa, xa = case(512, 9, 7, 1, 32)
    pa0 = [a[0] for a in pa]
    timed = {
        "K4t hpo f32 rate 0.5": (lambda: u2gnn_encoder_train(
            xh, ph, 17, 5, 0.5, 7), fwd),
        "K4t hpo f32 rate 0": (lambda: u2gnn_encoder_train(
            xh, ph, 17, 5, 0.0, 7), fwd),
        "K4t hpo f32 F=0": (lambda: u2gnn_encoder_train(
            xh, ph0, 17, 5, 0.5, 7), fwd),
        "K4t bf16 8832x9 D4": (lambda: u2gnn_encoder_train(
            xb, pb, 9, 4, 0.5, 7), fwd),
        "K9 act f32": (lambda: el.encoder_layer_forward(
            xa, pa0, 9, 0.5, 7, 0), ("gt_layer_fwd_kernel",)),
    }

    def k4t_f64(N, S, D, Tn, seed, rate):
        p, x = case(N, S, D, Tn, seed)
        ok, xk = u2gnn_encoder_train(x, p, S, Tn, rate, 97531)
        op, xp = u2gnn_encoder_train_plain(x, p, S, Tn, rate, 97531)
        return {"out": (ok, op, cs.plain_f64(x, p, S, Tn, rate, 97531)),
                "xs": (xk[-1], xp[-1], cs.plain_f64(
                    x, p, S, Tn - 1, rate, 97531, slot0=False))}

    def k9_f64(N, S, D, seed, rate):
        p, x = case(N, S, D, 1, seed)
        p0 = [a[0] for a in p]
        ref = layer_forward(x.double().view(N, S, D), [a.double() for a in p0],
                            layer=2, rate=rate, seed=424242, mm=torch.float32,
                            slot0=False)[0].reshape(N * S, D)
        return {"rows": (el.encoder_layer_forward(x, p0, S, rate, 424242, 2),
                         el.encoder_layer_forward_plain(x, p0, S, rate,
                                                        424242, 2), ref)}

    accuracy = {
        "K4t 4096x9 D18 T4": lambda r: k4t_f64(4096, 9, 18, 4, 6, r),
        "K4t 512x17 D6 T5": lambda r: k4t_f64(512, 17, 6, 5, 15, r),
        "K4t 4096x17 D7 T5": lambda r: k4t_f64(4096, 17, 7, 5, 6, r),
        "K4t 1000x9 D7 T4": lambda r: k4t_f64(1000, 9, 7, 4, 8, r),
        "K9 512x9 D7": lambda r: k9_f64(512, 9, 7, 16, r),
        "K9 4096x9 D7": lambda r: k9_f64(4096, 9, 7, 7, r),
    }
    results, first = {}, {}
    for name in VARIANTS:
        _build._libs.clear()
        _build.lib_path = (lambda n: (lambda s: root / n / f"{s}.so"))(name)
        _build.set_fwd_mma_rows(2 ** 31 - 1, SOURCES)
        res = {}
        for key, (fn, kernels) in timed.items():
            res[key] = {"ms": cs.device_ms(fn, 10, kernels)}
            out = fn()
            out = out[0] if isinstance(out, tuple) else out
            first.setdefault(key, out)
            res[key]["bit_equal_to_final"] = bool(torch.equal(out, first[key]))
            print(f"# {name} | {key}: {res[key]['ms']:.4f} ms, bit-equal to "
                  f"final {res[key]['bit_equal_to_final']}", flush=True)
        for key, fn in accuracy.items():
            for rate in (0.0, 0.5):
                for what, (k, p, ref) in fn(rate).items():
                    ek = float((k.double() - ref).abs().max())
                    ep = float((p.double() - ref).abs().max())
                    ok = bool(torch.allclose(k, p, rtol=1e-4, atol=1e-4)
                              or ek <= 2.0 * ep)
                    res[f"{key} rate {rate} {what}"] = dict(
                        kernel_f64=ek, plain_f64=ep, multiple=ek / ep,
                        holds_rule=ok)
                    print(f"# {name} | {key} rate {rate} {what}: "
                          f"{ek / ep:.2f}x the plain version's float64 "
                          f"distance ({ek:.3e} / {ep:.3e}), rule "
                          f"{'held' if ok else 'missed'}", flush=True)
        _build.set_fwd_mma_rows(0, SOURCES)
        results[name] = res
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fwd_variants.json").write_text(json.dumps(results, indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
