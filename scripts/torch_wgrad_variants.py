#!/usr/bin/env python3
"""Variants of the split-K weight products' staging (``wd_wgrad_mma_kernel``,
``graph_transformer_tpu_torch/ops/csrc/wide_mma.cuh``) against the committed
design, on one NVIDIA H100 (run on the card, from the root of a checkout):

    python3 scripts/torch_wgrad_variants.py

Each variant is built from a copy of the sources whose ``wide_mma.cuh`` sets
other rows a staged chunk (``WG_BK``) and chunks in the ring
(``WG_STAGES``) (``nvcc``, the port's flags, ``ffn.cu`` alone, into
``build/wgrad_variants/<variant>/``):

- ``final``: the committed 32 rows x 4 stages (104 KB, 2 blocks an SM);
- ``s3``: 32 x 3 (78 KB, 2 blocks an SM);
- ``s6``: 32 x 6 (156 KB, 1 block an SM);
- ``bk16_s8``: 16 x 8 (104 KB, 2 blocks an SM);
- ``bk64_s3``: 64 x 3 (156 KB, 1 block an SM);
- ``s2_b3``: 32 x 2 (52 KB) compiled for 3 blocks an SM;
- ``carve``: the committed design with the launch asking for the largest
  shared-memory carveout (``cudaSharedmemCarveoutMaxShared``);
- ``blocks132``: splits for 132 blocks a batch, not 264 (other sums: not
  bit-equal), to see whether a second block an SM runs beside the first.

For each: device ms a call (``chip_smoke.device_ms``) of one product
(``ffn.weight_product``, the kernel and its reduction) at the wide
backward's four shapes over the README quickstart's 5,760 rows (x^T dqkv
68 x 204, ctx^T da 68 x 68, y1^T dhpre 68 x 1024, h^T dz 1024 x 68) and at
h^T dz over the slot-0 layer's 640 rows, in float32 and bf16; whether each
output equals the committed design's bit for bit (the splits do not
depend on the staging, so they should).  Prints a line a variant and shape,
the card's name and power limit, and writes every number to
``chiprun_out/wgrad_variants.json``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BK = "#define WG_BK 32          // rows of the sum a staged chunk"
STAGES = "#define WG_STAGES 4       // chunks in the ring"
LAUNCH = "__launch_bounds__(256, 2) wd_wgrad_mma_kernel"
BLOCKS = "#define WG_BLOCKS 264"
SMEM_SET = """      k, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  if (e != cudaSuccess) return e;
"""
CARVE = SMEM_SET + """  e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
"""
# rows a chunk, chunks in the ring, other edits
VARIANTS = {"final": (32, 4, []), "s3": (32, 3, []), "s6": (32, 6, []),
            "bk16_s8": (16, 8, []), "bk64_s3": (64, 3, []),
            "s2_b3": (32, 2, [(LAUNCH, LAUNCH.replace("2)", "3)"))]),
            "carve": (32, 4, [(SMEM_SET, CARVE)]),
            "blocks132": (32, 4, [(BLOCKS, BLOCKS.replace("264", "132"))])}
SHAPES = ((5760, 68, 204), (5760, 68, 68), (5760, 68, 1024),
          (5760, 1024, 68), (640, 1024, 68))


def build(out_root: Path) -> None:
    """One nvcc per variant, all at once."""
    sys.path.insert(0, str(HERE))
    from graph_transformer_tpu_torch.ops import _build

    procs = []
    for name, (bk, stages, edits) in VARIANTS.items():
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "wide_mma.cuh").read_text()
        if stages * bk * (72 + 136) * 4 > 113 * 1024:  # one block an SM
            edits = edits + [(LAUNCH, LAUNCH.replace("2)", "1)"))]
        for old, new in [(BK, BK.replace("32", str(bk))),
                         (STAGES, STAGES.replace("4", str(stages), 1))] + edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in wide_mma.cuh")
            src = src.replace(old, new)
        (d / "wide_mma.cuh").write_text(src)
        procs.append((name, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "ffn.so"),
             str(d / "ffn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_wgrad_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import ffn

    root = HERE / "build" / "wgrad_variants"
    build(root)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(51)
    cases = {}
    for rows, m1, n1 in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(rows, m1, device=dev, generator=gen).to(dt)
            b = torch.randn(rows, n1, device=dev, generator=gen).to(dt)
            cases[f"{rows} rows {m1}x{n1} {str(dt)[6:]}"] = (a, b)
    kernels = ("wd_wgrad_mma_kernel", "wd_wgrad_reduce_kernel")
    results, first = {}, {}
    for name in VARIANTS:
        _build._libs.clear()
        _build.lib_path = (lambda n: (lambda s: root / n / f"{s}.so"))(name)
        res = {}
        for key, (a, b) in cases.items():
            ms = cs.device_ms(lambda: ffn.weight_product(a, b), 10, kernels)
            out = ffn.weight_product(a, b)
            same = bool(torch.equal(out, first.setdefault(key, out)))
            res[key] = {"ms": ms, "bit_equal_to_final": same}
            print(f"# {name} | {key}: {ms:.4f} ms, bit-equal to final "
                  f"{same}", flush=True)
        results[name] = res
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wgrad_variants.json").write_text(json.dumps(results,
                                                            indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
