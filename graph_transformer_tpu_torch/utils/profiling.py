"""Tracing and step timing — port of ``graph_transformer_tpu/utils/
profiling.py``.

- :class:`StepTimer`: step timing that waits for the card, with warm-up
  steps discarded and derived throughput (edges/s, nodes/s); its
  ``summary`` has JAX's keys.
- :func:`trace`: a ``torch.profiler`` trace of the card and the host,
  written as a Chrome trace into ``logdir``.
- :func:`annotate`: a named range in the profiler's timeline
  (``torch.profiler.record_function``).
- :func:`kernel_counters`: every kernel wrapper's launch counter, by the
  kernel's name (K1-K20), each counting the launches its wrapper made.
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


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter (``.launches``), by kernel."""
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import ffn
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import rows_encoder as re
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.sampling import neighbor_table as nt

    return {"K1": se.sampled_forward, "K2": se.layer_backward,
            "K3": se.slot0_backward, "K4": ue.u2gnn_encoder,
            "K4w": ue.wide_encoder, "K5": st.stored_forward,
            "K6": st.stored_layer_backward, "K6s": st.stored_slot0_backward,
            "K7": nt.sample_neighborhoods, "K4t": ue.u2gnn_encoder_train,
            "K8": ut.layer_recompute_backward,
            "K8s": ut.slot0_recompute_backward,
            "K9": el.encoder_layer_forward, "K10": el.encoder_layer_backward,
            "K11": ffn.ffn_forward, "K12": ffn.ffn_backward,
            "K4tw": ue.wide_encoder_train,
            "K8w": ut.wide_layer_recompute_backward,
            "K8ws": ut.wide_slot0_recompute_backward,
            "K9w": el.wide_encoder_layer_forward,
            "K10w": el.wide_encoder_layer_backward,
            "K13": fs.fused_sampled_forward,
            "K14": ut.mega_recompute_backward,
            "K14w": ut.wide_mega_recompute_backward,
            "K15": fe.folded_stored_forward, "K16": fe.folded_forward,
            "K17": st.stored_rows_forward, "K18": re.K18, "K19": re.K19,
            "K20": re.K20}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for c in kernel_counters().values():
        c.launches = 0


def read_launches() -> Dict[str, int]:
    """Every kernel's launch count, by kernel."""
    return {k: c.launches for k, c in kernel_counters().items()}
