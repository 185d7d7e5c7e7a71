#!/usr/bin/env python3
"""K19's and K20's backward kernels against edited copies of themselves, on
one card:

    python3 scripts/torch_rows_bwd_variants.py [--edits-only]

Builds ``ops/csrc/rows_attention.cu`` and ``ops/csrc/rows_ln.cu`` as
committed and copies with one setting or part changed by an exact-text edit
(the script stops if an edit's text is not found once), written with their
libraries into ``build/rows_bwd_variants/`` (``ops._build.nvcc_command``,
all ``nvcc`` runs at once):

- K19 (``ra_bwd_kernel``): a shared-memory budget of half and all of an
  SM's 227 KB instead of a third (fewer column chunks, fewer blocks an SM);
  4 output columns a lane instead of 8; ``no stores`` (dqkv computed,
  never stored: timed only); ``phases``: clock64 at the block's phases
  (copies issued and waited for, the score and dattn sums, the softmax
  backward, the gradients and their stores), summed over the blocks by
  atomics into a device array, printed as cycles a neighborhood;
- K20 (``rl_bwd_kernel``, ``rl_colsum_kernel``): compiled for 5 blocks an
  SM (fewer registers, more rows in flight); 128 threads a row; the column
  sums' pass on blocks of 8 warps instead of 32; ``no stores``;
  ``phases``: clock64 a row (its loads and mean, the variance, the two
  means of du, du's and dv's stores); ``rl_colsum_kernel`` alone.

Each is timed by torch.profiler device time a launch
(``chip_smoke.device_ms``) at ``chip_smoke.rows_bwd_calls``' shapes, Cora's
(N = 2,816 neighborhoods, S = 5, D = 1,433, float32, rate 0.5): the slot-0
layer's and a full layer's;
the committed kernels and the variants that compute the same function are
first held against the plain versions (``chip_smoke.check_rows_bwd``).
Prints each time beside its bytes bound and share of it, the library
yardsticks, and the card's name and power limit.  Exits non-zero without a
CUDA device; ``--edits-only`` writes the edited copies and stops (no card or
``nvcc`` needed).
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE_HEAD = '''
__device__ unsigned long long gt_probe[8];
extern "C" int gt_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gt_probe, sizeof(gt_probe));
}
extern "C" int gt_probe_zero() {
  unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(gt_probe, z, sizeof(z));
}
#define GT_PROBE(i, t0, t1) \\
  if (threadIdx.x == 0)           \\
  atomicAdd(&gt_probe[i], (unsigned long long)((t1) - (t0)))
'''
RA_GRADS = ("    ra_grads<BF>(a, n, buf, sb, sds, sad, c0, L);\n"
            "    __syncthreads();\n  }\n")
RA_PHASES = [
    ('#define RA_JT 8\n', PROBE_HEAD + '#define RA_JT 8\n'),
    ("  const int n = blockIdx.x;\n",
     "  const int n = blockIdx.x;\n"
     "  long long p0 = clock64(), p1 = p0, p2 = p0;\n"),
    ("    __syncthreads();\n    ra_dots<BF>(a, buf, sb, L, red, c == 0);\n"
     "    __syncthreads();\n",
     "    __syncthreads();\n    p1 = clock64();\n"
     "    ra_dots<BF>(a, buf, sb, L, red, c == 0);\n"
     "    __syncthreads();\n    p2 = clock64();\n"
     "    GT_PROBE(0, p0, p1);\n    GT_PROBE(1, p1, p2);\n    p0 = p2;\n"),
    ("  ra_softmax_bwd(a, n, red, sds, sad);\n  __syncthreads();\n",
     "  ra_softmax_bwd(a, n, red, sds, sad);\n  __syncthreads();\n"
     "  const long long p3 = clock64();\n  GT_PROBE(2, p2, p3);\n"),
    (RA_GRADS, RA_GRADS + "  GT_PROBE(3, p3, clock64());\n"
     "  GT_PROBE(4, 0, 1);\n"),
]
RL_PHASES = [
    ("#define RL_BWD_THREADS 256",
     PROBE_HEAD + "#define RL_BWD_THREADS 256"),
    ("    float u[E], x[E], y[E];\n",
     "    float u[E], x[E], y[E];\n    const long long p0 = clock64();\n"),
    ("    float q = 0.f;\n", "    const long long p1 = clock64();\n"
     "    float q = 0.f;\n"),
    ("    float s1 = 0.f, s2 = 0.f;\n", "    const long long p2 = clock64();\n"
     "    float s1 = 0.f, s2 = 0.f;\n"),
    ("    const float m1 = m.x", "    const long long p3 = clock64();\n"
     "    const float m1 = m.x"),
    ("      }\n    }\n  }\n  __syncthreads();\n",
     "      }\n    }\n    const long long p4 = clock64();\n"
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&gt_probe[0], (unsigned long long)(p1 - p0));\n"
     "      atomicAdd(&gt_probe[1], (unsigned long long)(p2 - p1));\n"
     "      atomicAdd(&gt_probe[2], (unsigned long long)(p3 - p2));\n"
     "      atomicAdd(&gt_probe[3], (unsigned long long)(p4 - p3));\n"
     "      atomicAdd(&gt_probe[4], 1ull);\n"
     "    }\n  }\n  __syncthreads();\n"),
]
RA_BUDGET = "#define RA_BWD_BUDGET (232448 / 3)"


def LN_BOUNDS(n):
    old = "__global__ void __launch_bounds__(RL_BWD_THREADS, 1)"
    return (old, old.replace(", 1)", f", {n})"))


VARIANTS = {
    "rows_attention": {
        "kernel": [],
        "budget 1/2": [(RA_BUDGET, "#define RA_BWD_BUDGET (232448 / 2)")],
        "budget 1/1": [(RA_BUDGET, "#define RA_BWD_BUDGET 232448")],
        "4 columns a lane": [("#define RA_EPL 8", "#define RA_EPL 4")],
        "no stores": [("      if (d0 + 32 * e < L) out[d0 + 32 * e] = acc[e];",
                       "      if (d0 + 32 * e < L && acc[e] == 1234.5f)\n"
                       "        out[d0 + 32 * e] = 0.f;")],
        "phases": RA_PHASES,
    },
    "rows_ln": {
        "kernel": [],
        "5 blocks an SM": [LN_BOUNDS(5)],
        "128 threads a row": [("#define RL_BWD_THREADS 256",
                               "#define RL_BWD_THREADS 128")],
        "column sums a block of 8 warps": [(
            "#define RL_RED_SLICES 32", "#define RL_RED_SLICES 8")],
        "no stores": [("      if (d < D) {\n        du[rv + d] = o;",
                       "      if (d < D && o == 1234.5f) {\n"
                       "        du[rv + d] = o;")],
        "phases": RL_PHASES,
    },
}
# variants whose outputs are not the function's (timed only)
TIMED_ONLY = {"no stores"}
RA_PHASE_NAMES = ("copies", "score and dattn sums", "softmax backward",
                  "gradients and stores")
RL_PHASE_NAMES = ("loads and mean", "variance", "means of du",
                  "du and dv stores")


def build(_build, compile_them=True) -> dict:
    """{(source, variant): its library}, each written from an edited copy
    into ``build/rows_bwd_variants/`` and built, all at once."""
    out = os.path.join(ROOT, "build", "rows_bwd_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for src, variants in VARIANTS.items():
        text0 = (_build.CSRC / f"{src}.cu").read_text()
        for n, (name, edits) in enumerate(variants.items()):
            text = text0
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{src} {name}: edit not found once: "
                                     f"{old!r}")
                text = text.replace(old, new)
            path = os.path.join(out, f"{src}_{n}.cu")
            with open(path, "w") as f:
                f.write(text)
            so = os.path.join(out, f"{src}_{n}.so")
            if not compile_them:
                continue
            procs[(src, name)] = (so, subprocess.Popen(
                _build.nvcc_command(path, so), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log[-3000:]}")
        if key[1] == "kernel":
            print(f"# ptxas, {key[0]} as committed:\n" + "\n".join(
                line for line in log.splitlines()
                if "entry function" in line or "Used" in line
                or "spill" in line), flush=True)
        libs[key] = _build.open_lib(so)
    return libs


def phases(lib, fn, names) -> str:
    """Cycles a unit (a neighborhood for K19, a row for K20) in each phase
    of one launch of ``fn`` (the ``phases`` copy's device counters)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    lib.gt_probe_zero()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.gt_probe_read(buf)
    units = max(1, buf[4])
    return ", ".join(f"{n} {buf[i] / units:.0f}" for i, n in enumerate(names))


def main() -> int:
    if sys.argv[1:] == ["--edits-only"]:
        from graph_transformer_tpu_torch.ops import _build

        build(_build, compile_them=False)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_rows_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graph_transformer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build(_build)
    print(f"# build: {time.perf_counter() - t0:.1f} s", flush=True)
    N, S, D = 2816, 5, 1433
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to("cuda")

    x, qkv = rnd(N * S, D), rnd(N * S, 3 * D)
    gamma, beta = 1.0 + 0.1 * rnd(D), 0.1 * rnd(D)
    calls = cs.rows_bwd_calls(qkv, x, S, gamma, beta, rnd)
    for name, (fn, plain, lib, names, b, f) in calls.items():
        key, shape = name.split()
        src = "rows_attention" if key == "K19" else "rows_ln"
        want = plain()
        bms = cs.bound(b, f, cs.F32_FLOP_PER_S)[0]
        line = []
        for (s, variant), so in libs.items():
            if s != src:
                continue
            _build._libs[src] = so
            if variant.startswith("phases"):
                ph = phases(so, fn, RA_PHASE_NAMES if key == "K19"
                            else RL_PHASE_NAMES)
                print(f"# {name} {variant} (cycles a "
                      f"{'neighborhood' if key == 'K19' else 'row'}): {ph}",
                      flush=True)
                continue
            if variant not in TIMED_ONLY:
                cs.check_rows_bwd(f"{name} {variant}", fn(), want)
            ms = cs.device_ms(fn, 10, names)
            line.append(f"{variant} {ms:.4f} ({bms / ms:.1%})")
        _build._libs[src] = libs[(src, "kernel")]
        if key == "K20":
            line.append("rl_colsum_kernel alone "
                        f"{cs.device_ms(fn, 10, ('rl_colsum_kernel',)):.4f}")
        lib_ms = cs.device_ms(lib, 10, ("",))
        print(f"# {name}: bound {bms:.5f} ms ({b / 1e6:.1f} MB); "
              + ", ".join(line) + f"; library {lib_ms:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
