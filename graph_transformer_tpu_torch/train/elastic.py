"""Elastic recovery: a retry supervisor around checkpoint-backed runs —
port of ``graph_transformer_tpu/train/elastic.py`` (plain Python; the port
keeps its own copy).

The reference has no failure handling of any kind — scripts run to
completion or crash (SURVEY.md §5 "Failure detection / elastic recovery:
none").  Long sweeps in preemptible environments need one, and the
framework already has the hard half: ``run_cv_on_device`` snapshots its
whole training carry at every chunk boundary and resumes bit-exactly from
``latest_checkpoint`` (``train/cv_ondevice.py``; proven by
``tests/test_torch_cv_ondevice.py``).

This module adds the supervisor: call a resumable run, and when it dies of
a transient fault (preemption, a lost device, an interrupted host), call it
again — each retry resumes from the last snapshot instead of restarting
from scratch.  Combined with bit-exact resume, a run killed at any chunk
boundary reproduces the uninterrupted result (the fault-injection test in
``tests/test_torch_cv_ondevice.py`` proves it).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

from graph_transformer_tpu_torch.train.cv_ondevice import run_cv_on_device

__all__ = ["run_elastic", "run_cv_elastic"]


def run_elastic(
    fn: Callable[[], object],
    max_restarts: int = 3,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
    backoff_s: float = 0.0,
):
    """Run ``fn()`` to completion, restarting it after retryable failures.

    ``fn`` must be *resumable*: re-invoking it after a failure must continue
    (not redo) the work — e.g. a ``run_cv_on_device`` closure with a
    ``checkpoint_dir``.  ``max_restarts`` bounds the restarts (the original
    attempt is free); the final failure re-raises.  ``on_failure(attempt,
    exc)`` observes each failure (logging, metrics); ``backoff_s`` sleeps
    between attempts (transient infrastructure faults often need a beat).
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as exc:  # noqa: PERF203 — the loop IS the feature
            attempt += 1
            if on_failure is not None:
                on_failure(attempt, exc)
            if attempt > max_restarts:
                raise
            if backoff_s > 0.0:
                time.sleep(backoff_s)


def run_cv_elastic(
    ds,
    cfg,
    checkpoint_dir: str,
    max_restarts: int = 3,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
    backoff_s: float = 0.0,
    **cv_kwargs,
):
    """Elastic on-device CV: ``run_cv_on_device`` under the supervisor.

    ``checkpoint_dir`` is mandatory — without snapshots a retry would
    restart from scratch, which is a silent correctness hazard for
    best-epoch protocols (the reported best would span two histories)."""
    if not checkpoint_dir:
        raise ValueError("run_cv_elastic requires a checkpoint_dir")
    return run_elastic(
        lambda: run_cv_on_device(
            ds, cfg, checkpoint_dir=checkpoint_dir, **cv_kwargs
        ),
        max_restarts=max_restarts,
        retryable=retryable,
        on_failure=on_failure,
        backoff_s=backoff_s,
    )
