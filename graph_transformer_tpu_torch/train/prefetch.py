"""Background batch prefetching — port of
``graph_transformer_tpu/train/prefetch.py``.

Overlaps host-side batch assembly with device compute: a worker thread keeps
a bounded queue of assembled batches ahead of the training loop (the
reference assembles batches synchronously inside its hot loop,
``train_pytorch_U2GNN_Sup.py:149-164``).  The C++ assembler
(``native/batcher.py``) runs in ``ctypes``, which releases the interpreter
lock while it runs.  An exception in the worker is raised again by the next
:meth:`BatchPrefetcher.get`.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class BatchPrefetcher:
    """Pulls batches from ``make_batch()`` on a worker thread."""

    def __init__(self, make_batch: Callable[[], object], depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            while not self._stop.is_set():
                batch = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised again by the next get()
            self._exc = e

    def get(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("prefetch worker exited")

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
