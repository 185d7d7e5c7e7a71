"""ctypes binding of the port's native batch assembler — port of
``graph_transformer_tpu/native/batcher.py``.

The library is the port's own build of ``native/batcher.cpp`` under
``build/native/`` (``native/build.py``), whose draws are the JAX package's
(``std::mt19937_64`` seeded by the caller), so ``data/batching.BatchBuilder``
builds JAX's default batches array for array.  A failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from graph_transformer_tpu_torch.native.build import ensure

    lib = ctypes.CDLL(ensure("batcher"))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.batch_assemble.restype = ctypes.c_int
    lib.batch_assemble.argtypes = [
        i64p, i32p, f32p, ctypes.c_int64, i64p,
        i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        f32p, i32p, i32p, i32p, f32p, i32p, i32p, f32p, i64p,
    ]
    _lib = lib
    return lib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBatchAssembler:
    """Holds contiguous dataset arrays; assembles padded batches in C++."""

    def __init__(self, ds):
        self.nbr_offsets = np.ascontiguousarray(ds.nbr_offsets, np.int64)
        self.nbr_ids = np.ascontiguousarray(ds.nbr_ids, np.int32)
        self.node_feat = np.ascontiguousarray(ds.node_feat, np.float32)
        self.graph_offsets = np.ascontiguousarray(ds.graph_offsets, np.int64)
        self.feat_dim = ds.feature_dim
        self.num_graphs = len(self.graph_offsets) - 1
        self._lib = _load()

    def assemble(self, graph_ids, num_neighbors: int, n_pad: int, e_pad: int,
                 seed: int) -> dict:
        """The padded arrays of the graphs ``graph_ids`` (numpy, as JAX's
        ``assemble``), neighborhoods drawn from ``seed``; raises
        ``ValueError`` when their nodes or edges exceed the padding."""
        g = np.ascontiguousarray(graph_ids, np.int64)
        if g.size and (g.min() < 0 or g.max() >= self.num_graphs):
            raise IndexError(f"graph ids outside [0, {self.num_graphs})")
        B, D, K1 = len(g), self.feat_dim, num_neighbors + 1
        x = np.empty((n_pad, D), np.float32)
        neigh = np.empty((n_pad, K1), np.int32)
        graph_id = np.empty(n_pad, np.int32)
        node_gidx = np.empty(n_pad, np.int32)
        node_mask = np.empty(n_pad, np.float32)
        edge_src = np.empty(e_pad, np.int32)
        edge_dst = np.empty(e_pad, np.int32)
        edge_mask = np.empty(e_pad, np.float32)
        counts = np.empty(2, np.int64)
        rc = self._lib.batch_assemble(
            _p(self.nbr_offsets, ctypes.c_int64),
            _p(self.nbr_ids, ctypes.c_int32),
            _p(self.node_feat, ctypes.c_float),
            D,
            _p(self.graph_offsets, ctypes.c_int64),
            _p(g, ctypes.c_int64), B, num_neighbors, n_pad, e_pad, seed,
            _p(x, ctypes.c_float), _p(neigh, ctypes.c_int32),
            _p(graph_id, ctypes.c_int32), _p(node_gidx, ctypes.c_int32),
            _p(node_mask, ctypes.c_float), _p(edge_src, ctypes.c_int32),
            _p(edge_dst, ctypes.c_int32), _p(edge_mask, ctypes.c_float),
            _p(counts, ctypes.c_int64),
        )
        if rc == -1:
            raise ValueError(f"batch has {counts[0]} nodes > n_pad={n_pad}")
        if rc == -2:
            raise ValueError(f"batch has {counts[1]} edges > e_pad={e_pad}")
        return {
            "x": x, "neigh": neigh, "graph_id": graph_id,
            "node_gidx": node_gidx, "node_mask": node_mask,
            "edge_src": edge_src, "edge_dst": edge_dst, "edge_mask": edge_mask,
            "n_real": int(counts[0]), "e_real": int(counts[1]),
        }
