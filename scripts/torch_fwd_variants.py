#!/usr/bin/env python3
"""Variants of the D <= 32 forward layer's FFN (``gt_ffn_units``,
``graph_transformer_tpu_torch/ops/csrc/common.cuh``) against the committed
design, on one NVIDIA H100 (run on the card, from the root of a checkout):

    python3 scripts/torch_fwd_variants.py

Each variant is built from an edited copy of the sources (``nvcc``, the
port's flags, into ``build/fwd_variants/<variant>/``) or launched with
another block shape, and undoes one choice:

- ``compare``: at rate 0.5 the word's tail compared with 2^31 and the
  value selected (an ISETP and an FSEL), not its top bit or-ed into the
  value's sign for the relu to drop it (a LOP3);
- ``prefetch``: each unit's weights loaded one unit ahead, not in the
  iteration that uses them;
- ``mg4`` / ``mg1``: 4 / 1 m tiles of output sums a warp at a time, not 2;
- ``rows128``: blocks of at most 128 rows, as many as fill one wave where
  they can (the parent's blocks), not up to 256 rows in whole waves.

For each and the committed design (``final``): device ms a launch
(``chip_smoke.device_ms``) of K1 at the bench's rows (8,832 x S=9, D=4,
T=4, bf16) at rate 0.5, 0.3 and 0, of K4t with bf16 rows at the same rows,
of K4t at the MUTAG HPO arm's batch (512 x S=17, D=6, T=5, float32) and of
K9 at ACT's (512 x S=9, D=7, float32); whether the outputs equal the
committed design's bit for bit; the SASS of each K1 build's FFN loop a
dropout word (``chip_smoke.hash_loops``); on the float32 checks' cases, the
distance from the float64 function of K4t's output and of K9's rows as a
multiple of the plain version's (the float32 rule: within 1e-4 of the plain
version, or 2x its distance).  Prints a line a variant and case and each
build's spills (``-Xptxas -v``), the card's name and power limit, and
writes every number to ``chiprun_out/fwd_variants.json``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCES = ("sampled_fwd", "encoder_fwd", "encoder_layer")
MG_FINAL = "static constexpr int MG = NTD == 1 ? 2 : 1;"
IN_PLACE = """    for (int u = warp; u < NU; u += GT_FWD_WARPS) {
      GtFfnRaw<DM, BF> raw;
      gt_ffn_load<DM, BF, FULL>(raw, w, u * GT_FWD_UNIT, D, F);
      GtFfnFrag<DM, BF> f;
      gt_ffn_frag(f, raw);
"""
PREFETCH = """    GtFfnRaw<DM, BF> raw;
    if (warp < NU) gt_ffn_load<DM, BF, FULL>(raw, w, warp * GT_FWD_UNIT, D, F);
    for (int u = warp; u < NU; u += GT_FWD_WARPS) {
      GtFfnFrag<DM, BF> f;
      gt_ffn_frag(f, raw);
      if (u + GT_FWD_WARPS < NU)
        gt_ffn_load<DM, BF, FULL>(raw, w, (u + GT_FWD_WARPS) * GT_FWD_UNIT, D,
                                  F);
"""
HALF = """                const uint32_t top =
                    gt_bits_tail(kH, hd ^ (8 * j + e1)) & 0x80000000u;
                hv[j][e] = fmaxf(__uint_as_float(__float_as_uint(pre) | top),
                                 0.f);"""
# the rate-0.5 word compared with 2^31 and the value selected
COMPARE = """                hv[j][e] = gt_bits_tail(kH, hd ^ (8 * j + e1)) < thr ? v : 0.f;"""
VARIANTS = {
    "final": [],
    "compare": [(HALF, COMPARE)],
    "prefetch": [(IN_PLACE, PREFETCH)],
    "mg4": [(MG_FINAL, "static constexpr int MG = NTD == 1 ? 4 : 1;")],
    "mg1": [(MG_FINAL, "static constexpr int MG = 1;")],
    "rows128": [],
}


def build(out_root: Path) -> None:
    """One nvcc per variant and source, all at once (the variants that only
    change the launch use the final build)."""
    sys.path.insert(0, str(HERE))
    from graph_transformer_tpu_torch.ops import _build

    procs = []
    for name, edits in VARIANTS.items():
        if name == "rows128":
            continue
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "common.cuh").read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: the edit's text is not in common.cuh")
            src = src.replace(old, new)
        (d / "common.cuh").write_text(src)
        for s in SOURCES if name == "final" else SOURCES[:2]:
            procs.append((name, s, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-o", str(d / f"{s}.so"), str(d / f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = HERE / "chiprun_out"
    logs.mkdir(exist_ok=True)
    with open(logs / "fwd_variants_ptxas.log", "w") as f:
        for name, s, p in procs:
            log = p.communicate()[0]
            f.write(f"# {name}/{s}\n{log}\n")
            if p.returncode:
                raise SystemExit(f"nvcc failed for {name}/{s}:\n{log[-4000:]}")
            kernel = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '_Z\d+"
                              r"(gt_encoder_fwd_kernelI\w+?EE)v", line)
                if m:
                    kernel = m.group(1)
                elif kernel and "spill" in line and s == "sampled_fwd":
                    print(f"# {name} | {kernel}: {line.strip()}", flush=True)
                    kernel = None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
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
    sib, pb, xb = cs.random_case(N=8832, S=9, D=4, C=4, F=1024, Tn=4,
                                 stored=4, seed=33, dev=dev)
    pa, xa = case(512, 9, 7, 1, 32)
    pa0 = [a[0] for a in pa]
    timed = {
        "K1 bench rate 0.5": (lambda: se.sampled_forward(
            *sib, pb, 9, 4, 0.5, 7)[0], fwd),
        "K1 bench rate 0.3": (lambda: se.sampled_forward(
            *sib, pb, 9, 4, 0.3, 7)[0], fwd),
        "K1 bench rate 0": (lambda: se.sampled_forward(
            *sib, pb, 9, 4, 0.0, 7)[0], fwd),
        "K4t bf16 8832x9 D4": (lambda: u2gnn_encoder_train(
            xb, pb, 9, 4, 0.5, 7)[0], fwd),
        "K4t hpo f32 rate 0.5": (lambda: u2gnn_encoder_train(
            xh, ph, 17, 5, 0.5, 7)[0], fwd),
        "K9 act f32": (lambda: el.encoder_layer_forward(
            xa, pa0, 9, 0.5, 7, 0), ("gt_layer_fwd_kernel",)),
    }

    def k4t_f64(N, S, D, Tn, seed, rate):
        p, x = case(N, S, D, Tn, seed)
        ok, _ = u2gnn_encoder_train(x, p, S, Tn, rate, 97531)
        op, _ = u2gnn_encoder_train_plain(x, p, S, Tn, rate, 97531)
        return ok, op, cs.plain_f64(x, p, S, Tn, rate, 97531)

    def k9_f64(N, S, D, seed, rate):
        p, x = case(N, S, D, 1, seed)
        p0 = [a[0] for a in p]
        ref = layer_forward(x.double().view(N, S, D), [a.double() for a in p0],
                            layer=2, rate=rate, seed=424242, mm=torch.float32,
                            slot0=False)[0].reshape(N * S, D)
        return (el.encoder_layer_forward(x, p0, S, rate, 424242, 2),
                el.encoder_layer_forward_plain(x, p0, S, rate, 424242, 2), ref)

    accuracy = {
        "K4t 4096x9 D18 T4": lambda r: k4t_f64(4096, 9, 18, 4, 6, r),
        "K4t 512x17 D6 T5": lambda r: k4t_f64(512, 17, 6, 5, 15, r),
        "K4t 1000x9 D7 T4": lambda r: k4t_f64(1000, 9, 7, 4, 8, r),
        "K9 512x9 D7": lambda r: k9_f64(512, 9, 7, 16, r),
        "K9 4096x9 D7": lambda r: k9_f64(4096, 9, 7, 7, r),
    }
    pick_fwd_groups = _build.pick_fwd_groups
    results, first = {}, {}
    for name in VARIANTS:
        _build._libs.clear()
        lib_dir = root / ("final" if name == "rows128" else name)
        _build.lib_path = (lambda d: (lambda s: d / f"{s}.so"))(lib_dir)
        _build.pick_fwd_groups = (
            (lambda lib, fn, S, D, n: _build.pick_groups(lib, fn, S, D, 128,
                                                         n=n))
            if name == "rows128" else pick_fwd_groups)
        res = {}
        for key, (fn, kernels) in timed.items():
            if name not in ("final", "rows128") and key.startswith("K9"):
                continue
            res[key] = {"ms": cs.device_ms(fn, 10, kernels)}
            out = fn()
            first.setdefault(key, out)
            res[key]["bit_equal_to_final"] = bool(torch.equal(out, first[key]))
            print(f"# {name} | {key}: {res[key]['ms']:.4f} ms, bit-equal to "
                  f"final {res[key]['bit_equal_to_final']}", flush=True)
        funcs = cs.sass_functions(lib_dir / "sampled_fwd.so")
        fname = next(f for f in funcs if "gt_encoder_fwd_kernelILi4ELb0EE" in f)
        res["sass"] = cs.hash_loops(funcs[fname])
        for lp in res["sass"]:
            pw = lp["per_word"]
            print(f"# {name} | SASS loop {lp['span']} (bf16 mma "
                  f"{lp['bf16_mma']}, divides {lp['divides']}): a word "
                  + ", ".join(f"{u} {v:.2f}" for u, v in pw.items()),
                  flush=True)
        for key, fn in accuracy.items():
            if name not in ("final", "mg4", "mg1"):
                continue
            for rate in (0.0, 0.5):
                k, p, ref = fn(rate)
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
    _build.pick_fwd_groups = pick_fwd_groups
    out_dir = HERE / "chiprun_out"
    (out_dir / "fwd_variants.json").write_text(json.dumps(results, indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
