#!/usr/bin/env python3
"""The node path's phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/torch_node_phases.py

Builds the three sources of the encoder past D = 128 (K18-K20) and runs
``chip_smoke.node_phases``: K18-K20 against their plain versions at the node
path's widths, the routes at D = 160, the node CLI on Planetoid files at
Cora's shape (written under ``build/node/cora``), 20 timed node steps with a
profile of 5, two 5-step runs bit for bit, and each kernel's time at one
launch of the node step beside its bound, its plain version and a library
call; then the CLI, the steps and K18's timings again with
``--compute_dtype bfloat16``.  Prints the phases' JSON and the card's name
and power limit; about a minute on an H100 with the build, where
``chip_smoke.py`` takes ten.
Exits non-zero without a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_node_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from graph_transformer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = _build.build_all(("rows_gemm", "rows_attention", "rows_ln"))
    print(f"# build: {build_s:.1f} s", flush=True)
    _, node, entries = chip_smoke.node_phases(
        os.path.join(ROOT, "build", "node", "cora"), "cuda")
    print(json.dumps({"node": node, "kernels": entries}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: rc {smi.returncode}")
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
