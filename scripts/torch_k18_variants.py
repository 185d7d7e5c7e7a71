#!/usr/bin/env python3
"""K18's float32 kernel against edited copies of itself, on one card:

    python3 scripts/torch_k18_variants.py

Builds ``ops/csrc/rows_gemm.cu`` as committed and five copies, each with one
part of ``rg_tf32_kernel`` changed by an exact-text edit (the script stops
if an edit's text is not found once), written with their libraries into
``build/k18_variants/`` (``ops._build.nvcc_command``, in parallel):

- ``chained``: one accumulator over all of K (the step's sums never start
  from zero and are never added to a float32 sum on the CUDA cores);
- ``one pass``: hi*hi only (the TF32 product, not 3xTF32: wrong by design,
  timed only);
- ``loads only``: no products (the copies, the split and the barriers);
- ``pure loads``: the copies and the barriers alone (no products, no split,
  no fragments);
- ``no loads``: no copies after the first tiles (products on stale tiles).

Times each, by torch.profiler device time a launch (``chip_smoke.device_ms``),
at three of the node step's launches at Cora's shape
(``chip_smoke.node_k18_launches``, the step's views: k and v over 14,080
rows, q over 2,816, W_in's k, v columns' weight product), beside one
``torch.addmm``/``torch.mm`` (allow_tf32 False); the committed kernel also at the kv product with rows of
1,436 and 2,872 words (16-byte aligned) against 1,433 and 2,866, and the
kv product in bf16 (``rg_wgmma_bf16_kernel``) beside torch's bf16 product.  Then the
float32 distance from float64 (max |err| and relative L2) of the committed
and the chained kernel beside torch's, on randn rows against weights 0.3 /
sqrt(K / 6) at K = 1,433 and 3,703 (nn) and on 0/1 and randn rows against
1e-2 randn cotangents over 14,080 rows (tn).  Prints one line each and the
card's name and power limit; about two minutes on an H100.  Exits non-zero
without a CUDA device.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# edits of rows_gemm.cu: (old text, new text), each found exactly once
PASSES = ("      rg_wgmma(s, al[kk], bh, kk > 0);\n"
          "      rg_wgmma(s, ah[kk], bl, 1);\n"
          "      rg_wgmma(s, ah[kk], bh, 1);\n")
VARIANTS = {
    "kernel": [],
    "chained": [("      rg_wgmma(s, al[kk], bh, kk > 0);",
                 "      rg_wgmma(s, al[kk], bh, 1);"),
                ("    for (int i = 0; i < 64; ++i) acc[i] += s[i];",
                 "    for (int i = 0; i < 64; ++i) acc[i] = s[i];")],
    "one pass": [(PASSES, "      rg_wgmma(s, ah[kk], bh, kk > 0);\n"
                          "      (void)al; (void)bl;\n")],
    "loads only": [(PASSES, "      (void)bh; (void)bl;\n")],
    "pure loads": [(PASSES, "      (void)bh; (void)bl;\n"),
                   ("      split_b((t + 1) % RG_RING, (t + 1) & 1);\n", ""),
                   ("        rg_split(As[araw[0] + dk], ah[kk][2 * h], "
                    "al[kk][2 * h]);\n"
                    "        rg_split(As[araw[1] + dk], ah[kk][2 * h + 1], "
                    "al[kk][2 * h + 1]);\n", "        (void)dk;\n")],
    "no loads": [("    if (nxt < steps) issue(k0 + nxt * RG_BK, "
                  "nxt % RG_RING);",
                  "    if (nxt < 0) issue(k0 + nxt * RG_BK, nxt % RG_RING);")],
}


def build(_build) -> dict:
    """{variant: its library}, each built from an edited copy of
    ``rows_gemm.cu`` written into ``build/k18_variants/`` (the package's
    headers by ``nvcc -I``), all ``nvcc`` runs started at once."""
    src = (_build.CSRC / "rows_gemm.cu").read_text()
    out = os.path.join(ROOT, "build", "k18_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for n, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: edit not found once: {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out, f"rows_gemm_{n}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(out, f"rows_gemm_{n}.so")
        procs[name] = (so, subprocess.Popen(
            _build.nvcc_command(path, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"# {name}: registers {regs}", flush=True)
        libs[name] = _build.open_lib(so)
    return libs


def distance(got, want) -> tuple:
    d = got.double() - want
    return float(d.abs().max()), float(d.norm() / want.norm())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k18_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build(_build)
    print(f"# build: {time.perf_counter() - t0:.1f} s", flush=True)
    N, S, D, F = 2816, 5, 1433, 1024
    launches = cs.node_k18_launches("cuda", N, S, D, F)
    for case in ("kv nn", "q nn", "dW_in kv tn"):
        fn, lib = launches[case][:2]
        line = []
        for name, so in libs.items():
            _build._libs["rows_gemm"] = so
            line.append(f"{name} {cs.device_ms(fn, 10, cs.K18_KERNELS):.4f}")
        print(f"# {case}: " + ", ".join(line)
              + f"; library {cs.time_ms(lib, 10):.4f} ms", flush=True)
    del launches
    _build._libs["rows_gemm"] = libs["kernel"]
    g = torch.Generator(device="cuda").manual_seed(1)
    xb = torch.randn(N * S, D, device="cuda", generator=g).bfloat16()
    wb = (torch.randn(D, 2 * D, device="cuda", generator=g) * 0.02).bfloat16()
    ms = cs.device_ms(lambda: re.gemm(xb, wb, bf16=True), 10, cs.K18_KERNELS)
    print(f"# kv nn in bf16 (rg_wgmma_bf16_kernel): {ms:.4f} ms, torch's bf16 "
          f"product {cs.time_ms(lambda: xb @ wb, 10):.4f}", flush=True)
    del xb, wb
    g = torch.Generator(device="cuda").manual_seed(1)
    for width in (1433, 1436):
        x = torch.randn(N * S, width, device="cuda", generator=g)
        w = torch.randn(width, 2 * width, device="cuda", generator=g) * 0.02
        ms = cs.device_ms(lambda: re.gemm(x, w), 10, cs.K18_KERNELS)
        print(f"# kv nn at rows of {width} and {2 * width} words: kernel "
              f"{ms:.4f} ms, addmm {cs.time_ms(lambda: x @ w, 10):.4f}",
              flush=True)
        del x, w
    cases = {}
    for K in (1433, 3703):
        a = torch.randn(2048, K, device="cuda", generator=g)
        b = torch.randn(K, 512, device="cuda", generator=g) * (
            0.3 / (K / 6) ** 0.5)
        cases[f"nn K={K}"] = (lambda a=a, b=b: re.gemm(a, b), a @ b,
                              a.double() @ b.double())
    cot = torch.randn(14080, 256, device="cuda", generator=g) * 1e-2
    for kind in ("0/1", "randn"):
        a = (torch.rand(14080, 512, device="cuda", generator=g) < 0.0127
             ).float() if kind == "0/1" else torch.randn(
                 14080, 512, device="cuda", generator=g)
        cases[f"tn K=14080 {kind}"] = (
            lambda a=a: re.weight_grad(a, cot)[0], a.t() @ cot,
            a.double().t() @ cot.double())
    for label, (fn, torch_out, want) in cases.items():
        line = [f"torch {distance(torch_out, want)}"]
        for name in ("kernel", "chained"):
            _build._libs["rows_gemm"] = libs[name]
            line.append(f"{name} {distance(fn(), want)}")
        print(f"# float64 distance (max, relative L2), {label}: "
              + ", ".join(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: rc {smi.returncode}")
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
