"""Multi-process bootstrap — port of
``graph_transformer_tpu/parallel/bootstrap.py`` on ``torch.distributed``.

Every process calls :func:`initialize_from_env` first.  The same three
``GT_*`` variables as JAX's (``GT_COORDINATOR`` ``host:port`` of rank 0,
``GT_NUM_PROCESSES``, ``GT_PROCESS_ID``) become
``init_process_group(backend, init_method="tcp://host:port", world_size,
rank)``; the backend (``nccl`` or ``gloo``) and the device are the
caller's, and nothing is guessed: a failed initialisation raises, and
NCCL without a CUDA device raises.  Without ``GT_COORDINATOR`` nothing
happens and the function returns False, as JAX's does.

:func:`make_global_mesh` is :func:`~.mesh.make_mesh` over the world: one
process is one device, so the ``data`` axis spans processes (and hosts)
and, ranks being numbered host by host (``parallel/launch.py``), the
``model`` axis stays within a host.  :func:`host_local_array` and
:func:`put_tree` give each rank only its own block of an array every rank
holds on the host, as JAX's ``make_array_from_callback`` does: no
inter-process data movement.

Launchers: ``parallel/launch.py`` (``launch`` spawns W local ranks with the
variables set; ``python -m graph_transformer_tpu_torch.parallel.launch``
runs a module in each), the counterpart of ``scripts/bench_scaling.py
--multiprocess N`` and ``scripts/mp_worker.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from graph_transformer_tpu_torch.parallel.mesh import Mesh, make_mesh

ENV_COORDINATOR = "GT_COORDINATOR"  # "host:port" of process 0
ENV_NUM_PROCESSES = "GT_NUM_PROCESSES"
ENV_PROCESS_ID = "GT_PROCESS_ID"
BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, device) -> torch.device:
    """The device (``cuda`` as the current CUDA device), after checking that
    ``backend`` can serve it: NCCL needs a CUDA device that exists; gloo
    takes the CPU or a CUDA device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of "
                         f"{', '.join(BACKENDS)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device "
                           "is available")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_from_env(backend: str, device, timeout_s: int = 120) -> bool:
    """Initialise the default process group from the ``GT_*`` variables;
    returns True when a group is up (also one that was up already, as in a
    rank of ``parallel/launch.py``), False without ``GT_COORDINATOR``.
    ``device`` (``cuda:i`` or ``cpu``) becomes the current CUDA device
    before the group forms; ``timeout_s`` bounds the rendezvous and every
    collective."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    if dist.is_initialized():
        return True
    device = check_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ[ENV_NUM_PROCESSES]),
        rank=int(os.environ[ENV_PROCESS_ID]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_global_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the world: ``data`` across processes,
    ``model`` within consecutive ranks (one host's)."""
    return make_mesh(model_parallel, device=device)


def _block(global_np: np.ndarray, mesh: Mesh, pspec: Sequence) -> np.ndarray:
    index = []
    for dim, axis in enumerate(tuple(pspec) + (None,) * (
            global_np.ndim - len(pspec))):
        if axis is None:
            index.append(slice(None))
            continue
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        size = global_np.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split over "
                             f"{n} ranks of {axis!r}")
        index.append(slice(i * size // n, (i + 1) * size // n))
    return global_np[tuple(index)]


def host_local_array(global_np, mesh: Mesh, pspec: Sequence) -> torch.Tensor:
    """This rank's block of ``global_np`` under ``pspec`` (one mesh axis
    name or None per dimension, as a ``PartitionSpec``), on the mesh's
    device.  Every rank holds the whole host array; each materializes its
    own block only."""
    block = _block(np.asarray(global_np), mesh, pspec)
    return torch.from_numpy(np.ascontiguousarray(block)).to(mesh.device)


def put_tree(tree: Any, mesh: Mesh, spec_tree: Any) -> Any:
    """:func:`host_local_array` over a dataclass or dict of host arrays
    (or CPU tensors) and the matching tree of specs."""
    def put(x, s):
        if torch.is_tensor(x):
            x = x.numpy()
        return host_local_array(x, mesh, s)

    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: put(getattr(tree, f.name),
                                         getattr(spec_tree, f.name))
                             for f in dataclasses.fields(tree)})
    return {k: put(v, spec_tree[k]) for k, v in tree.items()}


def device_for(local_rank: int, device: str) -> torch.device:
    """Rank → device, explicitly: ``cuda:{local_rank % device_count}`` for
    ``device`` ``cuda`` (every rank on ``cuda:0`` with one card), the CPU
    for ``cpu``."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but no CUDA device "
                               "is available")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def destroy() -> None:
    """Tear the default group down, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()

