#!/usr/bin/env python3
"""What the compiler made of K1's forward kernel in one or more checkouts
(run where ``nvcc`` and ``cuobjdump`` are; no card needed):

    python3 scripts/torch_fwd_sass.py ROOT [ROOT ...]

For each ROOT (a checkout; an older commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists) it builds ``sampled_fwd.cu``
with that checkout's ``ops/_build.py`` (``-Xptxas -v``) and prints, for
each instantiation of ``gt_encoder_fwd_kernel`` up to D=4 and D=8, its
registers, spills and shared memory, and for each innermost loop of it
that draws dropout words its instructions a word by unit
(``chip_smoke.hash_loops``: INT32, FP32, LDS, HMMA, other), with the
integer floor of the bench's K1 launch (8,832 x S=9, F=1024, T=4:
253,231,104 words) at 64 INT32 lanes x 132 SMs x 1,980 MHz.  Then, for the
forward kernels of ``FLOORS`` at their shapes, the integer floor from the
loop their rate-0.5 launch takes (of the loops of that D bound and dtype,
the one of the fewest instructions a word).  The SASS of each such kernel
goes to ``chiprun_out/sass-<n>-<kernel>.txt``.  Prints one JSON line at
the end.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = (3 * 8832 * 9 + 8832) * 1024
MHZ = 1980.0
# forward kernels of the layer at their main paths' shapes: (D bound,
# bf16, words a launch: ((T-1) N S + N) F, or N S F for K9's one layer)
FLOORS = {
    "K1, K13 (bench), K15, K16, K17 (A/B rows), bf16": (4, True, WORDS),
    "K4t (HPO arm: 512 x S=17, D=6, T=5), float32": (
        8, False, (4 * 512 * 17 + 512) * 1024),
    "K9 (ACT: 512 x S=9, D=7), float32": (8, False, 512 * 9 * 1024),
}


def main() -> int:
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    result = {}
    for n, root in enumerate(roots):
        build = subprocess.run(
            [sys.executable, "-c", "from graph_transformer_tpu_torch.ops "
             "import _build; _build.build_all(('sampled_fwd',), verbose=True);"
             " print('LIB', _build.lib_path('sampled_fwd'))"],
            cwd=root, capture_output=True, text=True)
        if build.returncode:
            print(build.stdout[-4000:], build.stderr[-4000:], file=sys.stderr)
            return 1
        lib = re.search(r"^LIB (.*)$", build.stdout, re.M).group(1)
        ptxas = {}
        cur = None
        for line in build.stdout.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
            elif cur and "Used" in line:
                ptxas[cur] = line.split("ptxas info    :")[-1].strip()
            elif cur and "spill" in line:
                ptxas[cur + " spills"] = line.split(":")[-1].strip()
        funcs = cs.sass_functions(lib)
        res = {}
        for name, insts in funcs.items():
            if not re.search(r"gt_encoder_fwd_kernelILi[48]E", name):
                continue
            short = re.sub(r"v7GtFwdIO.*$", "", name)
            with open(os.path.join(out_dir, f"sass-{n}-{short}.txt"),
                      "w") as f:
                f.write("\n".join(f"/*{a:05x}*/ {t}" for a, _, t, _ in insts))
            loops = cs.hash_loops(insts)
            res[short] = {"ptxas": ptxas.get(name), "spills":
                          ptxas.get(name + " spills"), "loops": loops}
            print(f"# {root} | {short}: {ptxas.get(name)}; "
                  f"{ptxas.get(name + ' spills')}", flush=True)
            for lp in loops:
                pw = lp["per_word"]
                floor_ms = pw["int32"] * WORDS / (64 * 132 * MHZ * 1e6) * 1e3
                lp["int32_floor_ms_at_bench"] = floor_ms
                print(f"#   loop {lp['span']} ({lp['instructions']} "
                      f"instructions, {lp['words']:g} words; bf16 mma "
                      f"{lp['bf16_mma']}, divides {lp['divides']}): a word "
                      + ", ".join(f"{u} {v:.2f}" for u, v in pw.items())
                      + f"; integer floor at the bench {floor_ms:.4f} ms",
                      flush=True)
        for label, (dm, bf, words) in FLOORS.items():
            # gt_encoder_fwd_kernel<dm, false>, the one FFN of the layer
            loops = [lp for k, r in res.items() if k.endswith(f"ILi{dm}ELb0EE")
                     for lp in r["loops"] if lp["bf16_mma"] == bf]
            if not loops:
                continue
            lp = min(loops, key=lambda lp: lp["instructions"] / lp["words"])
            floor_ms = lp["per_word"]["int32"] * words / (64 * 132 * MHZ
                                                          * 1e6) * 1e3
            res[label] = {"int32_per_word": lp["per_word"]["int32"],
                          "words": words, "int32_floor_ms": floor_ms}
            print(f"# {root} | {label}: {lp['per_word']['int32']:.2f} INT32 "
                  f"a word x {words:,} words: integer floor {floor_ms:.4f} "
                  f"ms at {MHZ:.0f} MHz", flush=True)
        result[root] = res
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
