"""The port's ``utils/profiling.py`` and ``train/prefetch.py`` against the
JAX package's:

1. ``StepTimer``: for the same step times (the clock replaced by a list of
   stamps in both packages), the same ``times`` and the same ``summary``,
   with and without warm-up steps and throughput counters; ``mark`` with
   CPU tensors waits for nothing and records as JAX's does.
2. ``trace`` writes a Chrome trace that holds an ``annotate`` range and
   the operations run inside it.
3. ``BatchPrefetcher`` (both packages') keeps the producer's order, also
   over the port's C++ batch assembler (the batches of a builder of the
   same seed), and re-raises a worker's exception in the consumer (JAX's
   ``tests/test_hpo_and_losses.py:124-136``), one not derived from
   ``Exception`` too; the port's stops its thread on close.
"""

import json
import threading

import numpy as np
import pytest
import torch

from graph_transformer_tpu.train import prefetch as jprefetch
from graph_transformer_tpu.utils import profiling as jprof
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.train.prefetch import BatchPrefetcher
from graph_transformer_tpu_torch.utils import profiling


def run_timer(module, monkeypatch, stamps, warmup, **summary):
    clock = iter(stamps)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StepTimer(warmup=warmup)
    timer.start()
    for _ in stamps[1:]:
        timer.mark()
    monkeypatch.undo()
    return timer.times, timer.summary(**summary)


@pytest.mark.parametrize("warmup", [0, 2, 9])
@pytest.mark.parametrize("summary", [{}, dict(edges_per_step=1000.0),
                                     dict(edges_per_step=5e5,
                                          nodes_per_step=300.0)])
def test_step_timer_summary_equals_jax(warmup, summary, monkeypatch):
    rng = np.random.default_rng(warmup)
    stamps = np.cumsum(rng.uniform(0.001, 0.05, 8)).tolist()
    got = run_timer(profiling, monkeypatch, stamps, warmup, **summary)
    want = run_timer(jprof, monkeypatch, stamps, warmup, **summary)
    assert got == want
    assert set(got[1]) >= {"steps", "mean_step_ms"}
    if warmup < 7:
        assert {"p50_step_ms", "max_step_ms"} <= set(got[1])


def test_mark_waits_for_cpu_tensors_as_for_none():
    timer = profiling.StepTimer(warmup=0)
    timer.start()
    timer.mark(torch.ones(3) * 2, "not a tensor")
    timer.mark()
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)
    assert timer.summary()["steps"] == 2.0


def test_trace_holds_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("gt_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "gt_step" in names and any("mm" in str(n) for n in names)


def small_builder():
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=10,
                                    seed=0, reddit_like=False)
    return BatchBuilder(ds, 4, 2, seed=0)


@pytest.mark.parametrize("module", [jprefetch, None])
def test_prefetcher_keeps_order_and_reraises(module):
    cls = BatchPrefetcher if module is None else module.BatchPrefetcher
    counter = iter(range(100))
    with cls(lambda: next(counter), depth=3) as pf:
        assert [pf.get() for _ in range(10)] == list(range(10))
    bb, ref = small_builder(), small_builder()
    with cls(bb.sample, depth=2) as pf:
        for _ in range(4):
            b, r = pf.get(), ref.sample()
            assert b.labels.shape == (4,)
            np.testing.assert_array_equal(b.neigh.numpy(), r.neigh.numpy())

    def boom():
        raise RuntimeError("worker failure")

    with pytest.raises(RuntimeError, match="worker failure"):
        with cls(boom) as pf:
            pf.get()


def test_prefetcher_stops_and_reraises_base_exceptions():
    before = threading.active_count()
    pf = BatchPrefetcher(lambda: np.zeros(2), depth=1)
    pf.get()
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() == before

    class Done(BaseException):
        pass

    def ends():
        raise Done()

    with BatchPrefetcher(ends) as pf:
        with pytest.raises(Done):
            pf.get()
