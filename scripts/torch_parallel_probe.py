"""The parallel layer on one card, without the rest of chip_smoke.py.

    python3 scripts/torch_parallel_probe.py

Builds the kernels, asks gloo for each collective form on CUDA tensors in
2 ranks sharing cuda:0 (``all_reduce``, ``broadcast``, the list
``all_gather`` with and without ``async_op``, ``all_gather_into_tensor``;
each form's outcome printed), then runs ``chip_smoke.parallel_phases``
(section 9f) and the 10-fold CLI with ``cv_runners`` reusing 9f's
unsharded runner.  Writes chiprun_out/torch_parallel_probe.json."""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def probe(device):
    import torch
    import torch.distributed as dist

    out = {}
    t = torch.full((4,), float(dist.get_rank() + 1), device=device)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(t.clone())),
            ("broadcast", lambda: dist.broadcast(t.clone(), src=0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t)),
            ("all_gather_async", lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t,
                async_op=True).wait()),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(8, device=device), t))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # record what gloo refuses
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    parts = [torch.empty_like(t) for _ in range(2)]
    dist.all_gather(parts, t)
    out["all_gather_values"] = [p.cpu().tolist() for p in parts]
    return out


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.parallel.launch import launch

    t_start = time.perf_counter()
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    b = _build.build_all()
    print(f"# build {b:.1f} s", flush=True)
    t0 = time.perf_counter()
    pr = launch(probe, 2, backend="gloo", device="cuda", timeout_s=120)
    print(f"# gloo probe ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(pr)}", flush=True)
    out = {"probe": pr, "build_s": b, "smi": smi.stdout.strip()}
    cora = os.path.join(HERE, "build", "node", "cora")
    cs.write_planetoid_like(cora)
    ds_cv, data_cv = cs.cv_data(os.path.join(HERE, "build", "tenfold"))
    ds = synthetic_powerlaw_dataset("REDDITMULTI5K-like", num_graphs=64,
                                    mean_nodes=509, seed=0)
    t0 = time.perf_counter()
    r4, par = cs.parallel_phases(ds, cora, ds_cv)
    out["parallel"] = par
    out["parallel_s"] = time.perf_counter() - t0
    print(f"# parallel phases {out['parallel_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    cli = cs.cv_cli(ds_cv, data_cv)
    out["runners"] = cs.cv_runners(cli, r4)
    out["cv_s"] = time.perf_counter() - t0
    out["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "torch_parallel_probe.json"),
              "w") as f:
        json.dump(out, f, default=str, indent=1)
    print(f"# done in {out['total_s']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
