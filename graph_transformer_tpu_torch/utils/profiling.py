"""Tracing and step timing — port of ``graph_transformer_tpu/utils/
profiling.py``.

- :class:`StepTimer`: step timing that waits for the card, with warm-up
  steps discarded and derived throughput (edges/s, nodes/s); its
  ``summary`` has JAX's keys.
- :func:`trace`: a ``torch.profiler`` trace of the card and the host,
  written as a Chrome trace into ``logdir``.
- :func:`annotate`: a named range in the profiler's timeline
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _wait(tensors) -> None:
    """Wait until the work that writes ``tensors`` has finished on their
    devices (JAX's ``block_until_ready``)."""
    devices = {t.device for t in tensors if torch.is_tensor(t)
               and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock step timing; ``mark`` synchronizes with the card.

    >>> timer = StepTimer(warmup=3)
    >>> timer.start()
    >>> for _ in range(n):
    ...     out = step(...)
    ...     timer.mark(out)   # waits for `out`, records the step time
    >>> timer.summary(edges_per_step=E)

    ``mark(*tensors)`` waits for the devices of the CUDA tensors it is given
    (with none, it waits for nothing, as JAX's does)."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._last: Optional[float] = None
        self._seen = 0

    def start(self):
        self._last = time.perf_counter()

    def mark(self, *tensors):
        if tensors:
            _wait(tensors)
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(
        self,
        edges_per_step: Optional[float] = None,
        nodes_per_step: Optional[float] = None,
    ) -> Dict[str, float]:
        out: Dict[str, float] = {
            "steps": float(len(self.times)),
            "mean_step_ms": self.mean_step_s * 1e3,
        }
        if self.times:
            out["p50_step_ms"] = sorted(self.times)[len(self.times) // 2] * 1e3
            out["max_step_ms"] = max(self.times) * 1e3
        if edges_per_step and self.mean_step_s > 0:
            out["edges_per_s"] = edges_per_step / self.mean_step_s
        if nodes_per_step and self.mean_step_s > 0:
            out["nodes_per_s"] = nodes_per_step / self.mean_step_s
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels where a card
    is present, the host's operations), written to
    ``logdir/trace.json`` (Chrome trace format).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range visible in profiler timelines."""
    return torch.profiler.record_function(name)
