#!/usr/bin/env python3
"""Float32 sum orders of the wide forward layer's CUDA-core products
(``wd_fwd_layer``, ``graph_transformer_tpu_torch/ops/csrc/wide.cuh``) held
against the float32 checks, on one NVIDIA H100 (run on the card, from the
root of a checkout):

    python3 scripts/torch_wide_f32_orders.py

Each order is built from a copy of the sources (``nvcc``, the port's flags,
into ``build/f32_orders/<order>/``) whose ``wide.cuh`` takes the ``wd_gemm``
section of ``scripts/torch_wide_f32_orders.cuh`` (its sums in units of K,
``WD_KU_D`` for the K = D products x W_in, ctx W_out, y1 W1 and ``WD_KU_F``
for h W2, each unit from zero, the units added in K order; 0: one FMA
chain, the committed order) and sends the forward layer's four products
through it:

- ``chains``: the committed order (each product one FMA chain over K; h W2
  over each 128-column hidden chunk, the chunks added in order), through
  the spliced section;
- ``w2_u16``, ``w2_u32``: h W2 in units of 16 / 32 hidden columns
  (``-DWD_KU_F``);
- ``all_u16``, ``all_u4``: every product so (``-DWD_KU_D`` too);
- ``all_f64``: every product's FMAs in float64, rounded once to float32
  (the section edited): what accuracy buys, and its time.

For each: device ms a launch (``chip_smoke.device_ms``) of K4tw at the
README quickstart's two-pass batch (640 x S=9 float32 one-hot rows, D=68,
F=1024, T=4, rate 0.5); the
distance from the float64 function of K4tw's output on the float32 card
test's cases (``test_wide_forward_kernels_at_quickstart_batch``, case seeds
3-7, rate 0 and 0.5) and of K17's output on the quickstart-sized stored
case (``test_stored_backward_at_quickstart_batch``), each as a multiple of
the plain version's (the float32 rule: within 1e-4 of the plain version, or
2x its distance).  Prints a line an order and case, the card's name and
power limit, and writes every number to ``chiprun_out/wide_f32_orders.json``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCES = ("wide_fwd", "stored_fwd")
SECTION = ("// wd_gemm's tile where the weights' rows are not 16-byte aligned",
           "// LayerNorm statistics of one row held by a warp")
# the forward layer's four products through wd_fwd_gemm
CALLS = [
    ("  gemm(sOp, D, Rv, D, w.w_in, D3, 1, D3, mmbf,",
     "  wd_fwd_gemm(gemm, WD_KU_D, sOp, D, Rv, D, w.w_in, D3, 1, D3, mmbf,"),
    ("  gemm(sOp, D, QR, D, w.w_out, D, 1, D, mmbf,",
     "  wd_fwd_gemm(gemm, WD_KU_D, sOp, D, QR, D, w.w_out, D, 1, D, mmbf,"),
    ("    gemm(sOp, D, QR, D, w.w1 + f0, F, 1, nf, mmbf,",
     "    wd_fwd_gemm(gemm, WD_KU_D, sOp, D, QR, D, w.w1 + f0, F, 1, nf, mmbf,"),
    ("    gemm(sH, WD_FC, QR, nf, w.w2 + (size_t)f0 * D, D, 1, D, mmbf,",
     "    wd_fwd_gemm(gemm, WD_KU_F, sH, WD_FC, QR, nf, w.w2 + (size_t)f0 * D,"
     " D, 1, D, mmbf,"),
]
# float64 accumulators in the spliced section's two tiles
F64_EDITS = [
    ("    float acc[4][4];\n", "    double acc[4][4];\n"),
    ("      float part[4][4];\n", "      double part[4][4];\n"),
    ("""    auto step = [&](float a, const float4& v, float (&r)[4]) {
      r[0] = fmaf(a, v.x, r[0]);
      r[1] = fmaf(a, v.y, r[1]);
      r[2] = fmaf(a, v.z, r[2]);
      r[3] = fmaf(a, v.w, r[3]);""",
     """    auto step = [&](float a, const float4& v, double (&r)[4]) {
      r[0] = fma((double)a, (double)v.x, r[0]);
      r[1] = fma((double)a, (double)v.y, r[1]);
      r[2] = fma((double)a, (double)v.z, r[2]);
      r[3] = fma((double)a, (double)v.w, r[3]);"""),
    ("    float acc[WD_RT];\n", "    double acc[WD_RT];\n"),
    ("      float part[WD_RT];\n", "      double part[WD_RT];\n"),
    ("""            part[i] = fmaf(a.x, wv[0], part[i]);
            part[i] = fmaf(a.y, wv[1], part[i]);
            part[i] = fmaf(a.z, wv[2], part[i]);
            part[i] = fmaf(a.w, wv[3], part[i]);""",
     """            part[i] = fma((double)a.x, (double)wv[0], part[i]);
            part[i] = fma((double)a.y, (double)wv[1], part[i]);
            part[i] = fma((double)a.z, (double)wv[2], part[i]);
            part[i] = fma((double)a.w, (double)wv[3], part[i]);"""),
    ("          part[i] = fmaf(ap[i * lda + k], wv, part[i]);",
     "          part[i] = fma((double)ap[i * lda + k], (double)wv, part[i]);"),
]
ORDERS = {
    "chains": ([], []),
    "w2_u16": (["-DWD_KU_F=16"], []),
    "w2_u32": (["-DWD_KU_F=32"], []),
    "all_u16": (["-DWD_KU_D=16", "-DWD_KU_F=16"], []),
    "all_u4": (["-DWD_KU_D=4", "-DWD_KU_F=4"], []),
    "all_f64": ([], F64_EDITS),
}


def replace_once(src: str, old: str, new: str, what: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"{what}: the text is not there once: {old[:60]!r}")
    return src.replace(old, new)


def variant(wide: str, edits) -> str:
    """wide.cuh with the units' section spliced in, the four products sent
    through it and ``edits`` applied."""
    i, j = wide.index(SECTION[0]), wide.index(SECTION[1])
    sec = (HERE / "scripts" / "torch_wide_f32_orders.cuh").read_text()
    src = wide[:i] + sec[sec.index("// Units of the float32"):] + wide[j:]
    for old, new in CALLS + list(edits):
        src = replace_once(src, old, new, "wide.cuh")
    return src


def build(out_root: Path) -> None:
    """One nvcc per order and source, all at once."""
    sys.path.insert(0, str(HERE))
    from graph_transformer_tpu_torch.ops import _build

    procs = []
    for name, (flags, edits) in ORDERS.items():
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "wide.cuh").write_text(variant((d / "wide.cuh").read_text(),
                                            edits))
        for s in SOURCES:
            procs.append((name, s, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(d / f"{s}.so"), str(d / f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, s, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}/{s}:\n{log[-4000:]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_f32_orders: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train, u2gnn_encoder_train_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    root = HERE / "build" / "f32_orders"
    build(root)
    dev = torch.device("cuda")
    N, S, D, T, F = 640, 9, 68, 4, 1024
    fwd = ("wd_encoder_fwd_kernel",)
    _, pq, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                              seed=21, dev=dev, one_hot=True)
    rng = np.random.default_rng(21)
    xq = torch.eye(D, device=dev)[torch.tensor(rng.integers(0, D, N * S),
                                               device=dev)]
    cases = {f"K4tw case {c}": cs.random_case(
        N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T, seed=c, dev=dev)
        for c in (3, 4, 5, 6, 7)}
    _, p17, x17 = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                 seed=5, dev=dev, one_hot=True)
    results = {}
    for name in ORDERS:
        _build._libs.clear()
        _build.lib_path = (lambda n: (lambda s: root / n / f"{s}.so"))(name)
        res = {"K4tw ms": cs.device_ms(lambda: u2gnn_encoder_train(
            xq, pq, S, T, 0.5, 2024), 10, fwd)}
        print(f"# {name}: K4tw {res['K4tw ms']:.4f} ms a launch", flush=True)
        for rate in (0.0, 0.5):
            runs = {key: (lambda p=p, x=x: (
                u2gnn_encoder_train(x.float(), p, S, T, rate, 97531)[0],
                u2gnn_encoder_train_plain(x.float(), p, S, T, rate,
                                          97531)[0],
                cs.plain_f64(x.float(), p, S, T, rate, 97531)))
                for key, (_, p, x) in cases.items()}
            runs["K17 quickstart"] = lambda: (
                st.stored_rows_forward(x17.float(), p17, S, T, rate,
                                       24680)[0],
                st.stored_rows_forward_plain(x17.float(), p17, S, T, rate,
                                             24680)[0],
                cs.plain_f64(x17.float(), p17, S, T, rate, 24680))
            for key, run in runs.items():
                k, p, ref = run()
                ek = float((k.double() - ref).abs().max())
                ep = float((p.double() - ref).abs().max())
                ok = bool(torch.allclose(k, p, rtol=1e-4, atol=1e-4)
                          or ek <= 2.0 * ep)
                res[f"{key} rate {rate}"] = dict(
                    kernel_f64=ek, plain_f64=ep, multiple=ek / ep,
                    holds_rule=ok)
                print(f"# {name} | {key} rate {rate}: {ek / ep:.2f}x the "
                      f"plain version's float64 distance ({ek:.3e} / "
                      f"{ep:.3e}), rule {'held' if ok else 'missed'}",
                      flush=True)
        results[name] = res
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wide_f32_orders.json").write_text(
        json.dumps(results, indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
