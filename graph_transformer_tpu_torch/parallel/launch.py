"""Spawn W local ranks — the counterpart of ``scripts/bench_scaling.py
--multiprocess N`` and ``scripts/mp_worker.py``.

:func:`launch` starts W processes (``torch.multiprocessing``, spawn) with
the ``GT_*`` variables of ``parallel/bootstrap.py`` set, maps rank r to its
device explicitly (``cuda:{r % device_count}``, so every rank shares
``cuda:0`` on one card; the CPU for ``cpu``) and prints the mapping; each
rank initialises the group with the caller's backend, runs ``fn(device,
*args)`` and hands its result back through a file.  On CUDA the parent
builds every kernel first and the ranks only load them (``ops/_build.py``,
``GT_TORCH_NO_BUILD``).  The job has one deadline: a rank that has not
finished by it is killed with all the others and :func:`launch` raises, as
it does when a rank exits with an error — a hung rendezvous fails instead
of waiting.

    python -m graph_transformer_tpu_torch.parallel.launch --ranks 4 \\
        --backend gloo --device cpu -- \\
        graph_transformer_tpu_torch.parallel.dryrun --backend gloo --device cpu

runs the module as ``python -m <module> [args]`` would, in each rank that
:func:`launch` spawns (``runpy``; the group is up before the module runs,
so the module's own ``initialize_from_env`` does nothing).
"""

from __future__ import annotations

import argparse
import os
import runpy
import socket
import sys
import tempfile
import time
from typing import Any, Callable, List

import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.parallel import bootstrap

ENV_DEVICE = "GT_DEVICE"
ENV_BACKEND = "GT_BACKEND"


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago (bound to 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, backend: str,
             device: str) -> dict:
    """The variables rank ``rank`` of a local job runs with."""
    dev = bootstrap.device_for(rank, device)
    return {bootstrap.ENV_COORDINATOR: f"127.0.0.1:{port}",
            bootstrap.ENV_NUM_PROCESSES: str(world),
            bootstrap.ENV_PROCESS_ID: str(rank),
            ENV_BACKEND: backend, ENV_DEVICE: str(dev)}


def _rank_main(fn, args, env: dict, out: str, timeout_s: int) -> None:
    os.environ.update(env)
    dev = torch.device(env[ENV_DEVICE])
    rank = env[bootstrap.ENV_PROCESS_ID]
    print(f"# rank {rank} of {env[bootstrap.ENV_NUM_PROCESSES]}: "
          f"{env[ENV_BACKEND]} on {dev}", flush=True)
    bootstrap.initialize_from_env(env[ENV_BACKEND], dev, timeout_s)
    try:
        result = fn(dev, *args)
    finally:
        bootstrap.destroy()
    torch.save(result, out)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def launch(fn: Callable, world: int, *args, backend: str, device: str = "cuda",
           timeout_s: int = 120) -> List[Any]:
    """Run ``fn(device, *args)`` in ``world`` spawned ranks of one group
    and return their results in rank order.  ``fn`` must be importable by
    the children (a module-level function).  Raises when a rank fails or
    the job outlasts ``timeout_s``."""
    bootstrap.check_backend(backend, device)
    if torch.device(device).type == "cuda":
        _build.build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="gt_launch_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = []
        for r in range(world):
            env = rank_env(r, world, port, backend, device)
            env[_build.NO_BUILD_ENV] = "1"
            procs.append(ctx.Process(target=_rank_main,
                                     args=(fn, args, env, outs[r], timeout_s)))
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late:
                raise TimeoutError(f"ranks {late} of {world} still running "
                                   f"after {timeout_s} s")
            failed = {r: p.exitcode for r, p in enumerate(procs)
                      if p.exitcode != 0}
            if failed:
                raise RuntimeError(f"ranks exited with codes {failed}")
        finally:
            _stop(procs)
        return [torch.load(o, weights_only=False) for o in outs]


def _run_module(device, module: str, args: List[str]) -> None:
    """One rank of :func:`main`: ``python -m module args`` in this process,
    the group already up (the module's own ``initialize_from_env`` is then
    a no-op).  A nonzero exit fails the rank."""
    sys.argv = [module, *args]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="run `python -m MODULE ARGS` in W local ranks")
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--backend", choices=bootstrap.BACKENDS,
                        required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("module")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    try:
        launch(_run_module, a.ranks, a.module, a.args, backend=a.backend,
               device=a.device, timeout_s=a.timeout)
    except TimeoutError as e:
        print(f"launch: {e}", file=sys.stderr)
        return 124
    except RuntimeError as e:
        print(f"launch: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
