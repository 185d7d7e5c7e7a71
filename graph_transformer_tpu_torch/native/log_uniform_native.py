"""ctypes binding of the port's native log-uniform sampler — port of
``graph_transformer_tpu/native/log_uniform_native.py``.

Host-side twin of the device sampler (the reference shipped its sampler as a
Cython extension, ``U2GNN_pytorch/log_uniform/log_uniform.pyx``; here the
binding is ctypes over a plain C ABI).  The library is the port's own build of
``native/log_uniform.cpp``, under ``build/native/`` (``native/build.py``).
API shape mirrors the reference's ``LogUniformSampler``: ``sample(size,
labels) -> (sample_ids, true_expected, sample_expected)`` plus
``sample_unique`` / ``expected_count`` / ``probability`` /
``accidental_matches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from graph_transformer_tpu_torch.native.build import ensure

    path = ensure("log_uniform")
    lib = ctypes.CDLL(path)
    lib.lus_create.restype = ctypes.c_void_p
    lib.lus_create.argtypes = [ctypes.c_int64, ctypes.c_uint64]
    lib.lus_destroy.argtypes = [ctypes.c_void_p]
    lib.lus_probability.restype = ctypes.c_double
    lib.lus_probability.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.lus_sample_unique.restype = ctypes.c_int64
    lib.lus_sample_unique.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.lus_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.lus_expected_count.argtypes = [
        ctypes.c_void_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.lus_accidental_matches.restype = ctypes.c_int64
    lib.lus_accidental_matches.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr_f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class LogUniformSampler:
    """Native Zipfian candidate sampler over ``[0, vocab)``.

    The reference seeds its RNG with the fixed constant 1111
    (``Log_Uniform_Sampler.cpp:10``); that is the default here too so
    parity harnesses line up.
    """

    def __init__(self, vocab_size: int, seed: int = 1111):
        self._lib = _load()
        self.vocab_size = int(vocab_size)
        self._h = self._lib.lus_create(self.vocab_size, seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lus_destroy(self._h)
            self._h = None

    def probability(self, k: int) -> float:
        return self._lib.lus_probability(self._h, int(k))

    def sample_unique(self, size: int) -> Tuple[np.ndarray, int]:
        """(ids[size], num_tries) — rejection to `size` distinct candidates."""
        out = np.empty(size, dtype=np.int64)
        tries = self._lib.lus_sample_unique(self._h, size, _ptr_i64(out))
        return out, int(tries)

    def sample_iid(self, size: int) -> np.ndarray:
        out = np.empty(size, dtype=np.int64)
        self._lib.lus_sample(self._h, size, _ptr_i64(out))
        return out

    def expected_count(self, num_tries: float, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty(len(ids), dtype=np.float64)
        self._lib.lus_expected_count(
            self._h, float(num_tries), _ptr_i64(ids), len(ids), _ptr_f64(out)
        )
        return out

    def accidental_matches(
        self, labels: np.ndarray, samples: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        labels = np.ascontiguousarray(labels, dtype=np.int64)
        samples = np.ascontiguousarray(samples, dtype=np.int64)
        cap = len(labels) * len(samples)
        rows = np.empty(cap, dtype=np.int64)
        cols = np.empty(cap, dtype=np.int64)
        n = self._lib.lus_accidental_matches(
            _ptr_i64(labels), len(labels), _ptr_i64(samples), len(samples),
            _ptr_i64(rows), _ptr_i64(cols), cap,
        )
        return rows[:n], cols[:n]

    def sample(
        self, size: int, labels: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Reference-API form (``log_uniform.pyx:16-40``): unique candidates
        plus expected-count corrections for the true labels and samples."""
        ids, tries = self.sample_unique(size)
        sample_freq = self.expected_count(float(tries), ids)
        true_freq = (
            self.expected_count(float(tries), labels)
            if labels is not None
            else None
        )
        return ids, true_freq, sample_freq
