"""One training step captured as a CUDA graph and replayed — the port of
JAX's one-dispatch training, the ``lax.scan`` bodies of ``_train_scan``
and ``_train_scan_stacked`` (``graph_transformer_tpu/train/
sup_trainer.py:204-283``, ``unsup_trainer.py:190-221``).

JAX traces a step once and runs n of them as one device program.  The port
captures one step's kernels into a CUDA graph and replays it once a step,
so that the host issues one graph launch a step in place of the step's
hundreds of operations, and every hand-written kernel stays on the path.
What a step reads lives in static device buffers that the graph was
captured over:

- ``batches``: the batches' fields stacked ``[m, ...]`` (one padded shape,
  ``data/batching.BatchBuilder``), and ``order`` [cap] the batch each step
  takes (the epoch's m batches in turn, or the one fixed batch n times);
- ``seeds`` [cap] int64: step i's seed, read by every kernel from device
  memory (``ops/random.device_seed``);
- ``counter`` [1] int64: the step the next replay runs, which the step
  advances, and ``losses`` [cap] float32, where step i writes its loss.

The captured step reads batch ``order[counter]`` and seed
``seeds[counter]``, runs the trainer's step (forward, backward, clip and
Adam, in place on the trainer's parameters and moments; Adam's count and
scale are device tensors, ``train/optim.py``), writes its loss and advances
the counter.  Capture needs each kernel's module loaded, which happens at a
kernel's first launch and is not allowed while capturing, so one eager
step runs first on the capture's side stream; the parameters, moments and
Adam's count are saved before it and restored after it, so that the graph
starts from the state an eager run would.  The kernels' launch counters
(``utils/profiling.kernel_counters``) count neither that step nor the
capture; each replay adds the launches the capture recorded.

There is no fallback: a capture that fails raises, naming the step, and
no eager loop runs in its place.  On the CPU, which has no graphs, the same
step runs eagerly over the same buffers, so the CPU tests run the code that
is captured.  A :class:`StepGraph` holds one capture, for one batch shape
and room for ``MIN_STEPS`` steps a call or more; a call of another shape or
of more steps captures anew.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.utils import profiling

# steps a call the buffers hold at least, so that short and long calls
# (warm-up steps, then timed ones) share one capture
MIN_STEPS = 32


def stack_batches(batches: Sequence[GraphBatch], device) -> GraphBatch:
    """The batches' fields stacked on a new leading axis, on ``device``
    (one host-to-device copy a field)."""
    return GraphBatch(**{
        f.name: torch.stack([getattr(b, f.name) for b in batches]).to(device)
        for f in dataclasses.fields(GraphBatch)})


def _shapes(b: GraphBatch) -> tuple:
    return tuple((f.name, tuple(getattr(b, f.name).shape),
                  getattr(b, f.name).dtype)
                 for f in dataclasses.fields(GraphBatch))


class StepGraph:
    """Replays ``step(batch, seed) -> loss`` over static buffers.

    ``step`` runs one whole training step on ``batch`` (a
    :class:`GraphBatch` on ``device``) with ``seed`` (a 0-d int64 device
    tensor) and returns the loss, a 0-d float32 tensor; ``params`` and
    ``opt`` are what it updates in place (saved around the warm-up step)."""

    def __init__(self, step: Callable, params: Sequence[torch.Tensor], opt,
                 device):
        self.step = step
        self.params = list(params)
        self.opt = opt
        self.device = torch.device(device)
        self.graph = None
        self.batches: Optional[GraphBatch] = None
        self.order = self.seeds = self.losses = self.counter = None
        self.launches: dict = {}

    # -------------------------------------------------------------- buffers
    def _fits(self, batches: GraphBatch, n: int) -> bool:
        return (self.batches is not None and self.order.shape[0] >= n
                and _shapes(self.batches) == _shapes(batches))

    def _allocate(self, batches: GraphBatch, n: int) -> None:
        dev = self.device
        self.batches = GraphBatch(**{
            f.name: torch.empty_like(getattr(batches, f.name), device=dev)
            for f in dataclasses.fields(GraphBatch)})
        n = max(n, MIN_STEPS)
        self.order = torch.zeros(n, dtype=torch.int64, device=dev)
        self.seeds = torch.zeros(n, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(n, dtype=torch.float32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None

    def _body(self) -> None:
        """The step as captured: batch ``order[counter]``, seed
        ``seeds[counter]``, the loss into ``losses[counter]``, then the
        counter advances."""
        i = self.counter
        b = self.order.index_select(0, i)
        batch = GraphBatch(**{
            f.name: getattr(self.batches, f.name).index_select(0, b)[0]
            for f in dataclasses.fields(GraphBatch)})
        seed = self.seeds.index_select(0, i)[0]
        loss = self.step(batch, seed)
        self.losses.index_copy_(0, i, loss.reshape(1).to(torch.float32))
        self.counter.add_(1)

    # -------------------------------------------------------------- capture
    def _state(self) -> List[torch.Tensor]:
        return (self.params + list(self.opt.mu) + list(self.opt.nu)
                + [self.opt.count_t])

    def _capture(self) -> None:
        """Warm up one eager step on a side stream (its effects undone),
        then capture the step on that stream."""
        counters = profiling.kernel_counters()
        before = {k: c.launches for k, c in counters.items()}
        saved = [t.detach().clone() for t in self._state()]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.counter.zero_()
            self._body()
            with torch.no_grad():
                for t, s in zip(self._state(), saved):
                    t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        for k, c in counters.items():
            c.launches = before[k]
        self.opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self._body()
        except RuntimeError as e:
            raise RuntimeError(
                "capturing the training step as a CUDA graph failed (an "
                "operation of the step syncs with the host or allocates "
                f"outside the graph's pool): {e}") from e
        self.launches = {k: c.launches - before[k]
                         for k, c in counters.items()
                         if c.launches != before[k]}
        for k, c in counters.items():
            c.launches = before[k]
        self.graph = graph

    # ------------------------------------------------------------------ run
    def run(self, batches: GraphBatch, order: Sequence[int],
            seeds: Sequence[int]) -> torch.Tensor:
        """``len(seeds)`` steps, step i on batch ``order[i]`` of the stacked
        ``batches`` (on the device) with seed ``seeds[i]``; returns the
        steps' losses [n], float32 on the device, unsynchronised.  On CUDA
        one graph replay a step; on the CPU the same step, eagerly."""
        n = len(seeds)
        if len(order) != n:
            raise ValueError(f"{len(order)} batch indices for {n} seeds")
        if not self._fits(batches, n):
            self._allocate(batches, n)
        for f in dataclasses.fields(GraphBatch):
            getattr(self.batches, f.name).copy_(getattr(batches, f.name))
        self.order[:n].copy_(torch.as_tensor(order, dtype=torch.int64))
        self.seeds[:n].copy_(torch.as_tensor(seeds, dtype=torch.int64))
        if self.device.type != "cuda":
            self.counter.zero_()
            for _ in range(n):
                self._body()
            return self.losses[:n].clone()
        if self.graph is None:
            self._capture()
        self.counter.zero_()
        for _ in range(n):
            self.graph.replay()
        counters = profiling.kernel_counters()
        for k, d in self.launches.items():
            counters[k].launches += n * d
        return self.losses[:n].clone()
