#!/usr/bin/env python3
"""A/B of two checkouts of the port's kernels on one NVIDIA H100 (run on the
card):

    python3 scripts/torch_ab_kernels.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Both are built first, in parallel, each into its own ``build/kernels/``.
Then, for each ROOT in the order given, a fresh process imports that
checkout's package and times, by torch.profiler device time a launch (10
launches after one warm-up, ``chip_smoke.device_ms``):

- K8w, K8ws and K10w at the README quickstart's two-pass batch (640
  neighborhoods x S=9 = 5,760 float32 one-hot rows, D=68, F=1024, T=4,
  rate 0.5): the whole launch, the row kernel (``wd_recompute_bwd_kernel``)
  and the split-K weight products with their partial sums;
- K17 and K15 at the A/B scripts' workload (79,488 bf16 rows, S=9, D=4,
  F=1024, T=4, rate 0.5) and ``torch.nn.TransformerEncoder`` in training on
  the same rows (host clock with CUDA events, ``chip_smoke.time_ms``);
- K14w on the same rows at the quickstart's width (one-hot D=68, bf16),
  3 launches.

Prints one line a checkout and a JSON line of every number, then the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW = ("wd_recompute_bwd_kernel",)
PRODUCTS = ("wd_reduce_small_kernel", "wd_wgrad_kernel",
            "gt_reduce_partials_kernel")
FWD = ("gt_encoder_fwd_kernel", "wd_encoder_fwd_kernel")


def worker(root: str) -> dict:
    """The timings of the checkout at ``root``."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train)

    assert os.path.dirname(os.path.dirname(st.__file__)).startswith(
        os.path.abspath(root)), st.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    seed, rate, out = 2024, 0.5, {}

    # the quickstart's two-pass batch
    N, S, D, F, T = 640, 9, 68, 1024, 4
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                  seed=7, dev=dev, one_hot=True)
    rng = np.random.default_rng(7)
    x = torch.eye(D, device=dev)[torch.tensor(rng.integers(0, D, N * S),
                                              device=dev)].view(N, S, D)
    g = torch.randn(N, S, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    p0 = [a[0] for a in params]
    calls = {
        "K8w": lambda: ut.wide_layer_recompute_backward(x, g, params, 0, rate,
                                                        seed),
        "K8ws": lambda: ut.wide_slot0_recompute_backward(
            x, g[:, 0], params, T - 1, rate, seed),
        "K10w": lambda: el.wide_encoder_layer_backward(
            x.view(N * S, D), g.view(N * S, D), p0, S, rate, seed),
    }
    for key, fn in calls.items():
        out[key] = {"ms": cs.device_ms(fn, 10, ROW + PRODUCTS),
                    "row_ms": cs.device_ms(fn, 10, ROW),
                    "products_ms": cs.device_ms(fn, 10, PRODUCTS)}

    # the A/B scripts' rows
    N, S, D = 8832, 9, 4
    _, params, x2d = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                    seed=8, dev=dev)
    lib = cs.library_encoder(params, S, T, D, F, dev, torch.bfloat16, rate)
    x3 = x2d.view(N, S, D)
    out["K17"] = {"ms": cs.device_ms(
        lambda: st.stored_rows_forward(x2d, params, S, T, rate, seed), 10,
        FWD)}
    out["K15"] = {"ms": cs.device_ms(
        lambda: fe.folded_stored_forward(x2d, params, S, T, rate, seed), 10,
        FWD)}
    out["library"] = {"ms": cs.time_ms(lambda: lib(x3), 10)}

    # the same rows at the quickstart's width
    D = 68
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                  seed=9, dev=dev, one_hot=True)
    x2d = torch.eye(D, device=dev)[torch.tensor(
        rng.integers(0, D, N * S), device=dev)].to(torch.bfloat16)
    _, xs = u2gnn_encoder_train(x2d, params, S, T, rate, seed)
    g = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    out["K14w"] = {"ms": cs.device_ms(
        lambda: ut.mega_recompute_backward(x2d, xs, g, params, S, T, rate,
                                           seed), 3,
        ("wd_mega_bwd_kernel",) + PRODUCTS + ("gt_mega_reduce_kernel",))}
    return out


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if not torch.cuda.is_available():
        print("torch_ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from graph_transformer_tpu_torch.ops import "
         "_build; print(_build.build_all())"], cwd=r)
        for r in dict.fromkeys(roots)]
    if any(b.wait() for b in builds):
        print("torch_ab_kernels: a build failed", file=sys.stderr)
        return 1
    runs = []
    for r in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", r], capture_output=True, text=True,
                             cwd=r, check=True)
        t = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"root": r, **t})
        print(f"# {r}: " + "; ".join(
            f"{k} " + ", ".join(f"{n} {v:.4f}" for n, v in d.items())
            for k, d in t.items()), flush=True)
    print(json.dumps({"runs": runs}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
