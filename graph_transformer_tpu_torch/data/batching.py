"""Padded graph batches as torch tensors — port of
``graph_transformer_tpu/data/batching.py``.

Batches are built on the host and moved to the device with
:meth:`GraphBatch.to`.  As in JAX (``batching.py:82-136``), ``backend``
picks the assembler: ``"auto"`` (the default) and ``"native"`` take the C++
assembler (``native/batcher.cpp``, the port's copy: one
``rng.integers(0, 2**63 - 1)`` seed a batch, neighborhoods drawn with
``std::mt19937_64``), ``"numpy"`` the vectorized path (``:147-214``, the
neighborhoods drawn by the ``np.random.Generator``).  Each equals JAX's
path of the same name array for array, so the port's default batches are
JAX's.  Unlike JAX's ``"auto"``, a failed build of the assembler raises
(with the compiler's message) instead of falling back to numpy, which would
change every draw without showing it.

Layout of a :class:`GraphBatch` (B graphs, padded to N_pad nodes / E_pad
directed edges):

- ``x``          [N_pad, D]   node features (zeros on padding)
- ``neigh``      [N_pad, K+1] batch-local neighbor indices, slot 0 = self
- ``graph_id``   [N_pad]      owning graph in [0, B); padding rows get B
- ``node_gidx``  [N_pad]      dataset-global node id (pad -> 0)
- ``node_mask``  [N_pad]      1.0 for real nodes
- ``edge_src/dst`` [E_pad]    batch-local directed edges, ``edge_mask`` 1.0 real
- ``labels``     [B]          graph labels
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from graph_transformer_tpu_torch.data.tu import GraphDataset


BACKENDS = ("auto", "native", "numpy")
_ARRAYS = ("x", "neigh", "graph_id", "node_gidx", "node_mask", "edge_src",
           "edge_dst", "edge_mask")


def pad_to_multiple(n: int, m: int) -> int:
    return ((int(n) + m - 1) // m) * m


@dataclasses.dataclass
class GraphBatch:
    x: torch.Tensor  # [N_pad, D] f32
    neigh: torch.Tensor  # [N_pad, K+1] i32 (batch-local)
    graph_id: torch.Tensor  # [N_pad] i32 (pad -> B)
    node_gidx: torch.Tensor  # [N_pad] i32 (global node ids, pad -> 0)
    node_mask: torch.Tensor  # [N_pad] f32
    edge_src: torch.Tensor  # [E_pad] i32
    edge_dst: torch.Tensor  # [E_pad] i32
    edge_mask: torch.Tensor  # [E_pad] f32
    labels: torch.Tensor  # [B] i32

    @property
    def num_graphs(self) -> int:
        return self.labels.shape[0]

    @property
    def n_pad(self) -> int:
        return self.x.shape[0]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


class BatchBuilder:
    """Assembles fixed-shape :class:`GraphBatch` objects from a dataset.

    The padded sizes are chosen once per (dataset, batch_size) so that every
    batch has the same shapes; ``backend`` is ``"auto"``/``"native"`` (the
    C++ assembler) or ``"numpy"``."""

    def __init__(
        self,
        ds: GraphDataset,
        batch_size: int,
        num_neighbors: int,
        pad_multiple: int = 128,
        seed: int = 123,
        indices: Optional[np.ndarray] = None,
        backend: str = "auto",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: one of "
                             f"{', '.join(BACKENDS)}")
        self.ds = ds
        self.batch_size = int(batch_size)
        self.K = int(num_neighbors)
        self.rng = np.random.default_rng(seed)
        self.indices = (
            np.arange(ds.num_graphs) if indices is None else np.asarray(indices)
        )
        self._native = None
        if backend != "numpy":
            from graph_transformer_tpu_torch.native.batcher import (
                NativeBatchAssembler)

            self._native = NativeBatchAssembler(ds)
        sizes = ds.graph_num_nodes
        deg = ds.degrees.astype(np.int64)
        # per-graph directed edge counts via cumulative degree at graph bounds
        ecnt = np.diff(
            np.concatenate([[0], np.cumsum(deg)])[ds.graph_offsets]
        )
        k = min(self.batch_size, ds.num_graphs)
        self.n_pad = pad_to_multiple(
            int(np.sort(sizes)[-k:].sum()), pad_multiple
        )
        self.e_pad = max(
            pad_to_multiple(int(np.sort(ecnt)[-k:].sum()), pad_multiple),
            pad_multiple,
        )
        self._deg = deg

    def build(
        self, graph_indices: Sequence[int],
        rng: Optional[np.random.Generator] = None,
    ) -> GraphBatch:
        """Assemble one padded batch (CPU tensors) for the given graph ids."""
        ds = self.ds
        rng = rng or self.rng
        g = np.asarray(graph_indices, dtype=np.int64)
        if self._native is not None:
            out = self._native.assemble(
                g, self.K, self.n_pad, self.e_pad,
                seed=int(rng.integers(0, 2**63 - 1)))
            arrays = {k: out[k] for k in _ARRAYS}
            arrays["labels"] = ds.labels[g].astype(np.int32)
            return GraphBatch(**{k: torch.from_numpy(v)
                                 for k, v in arrays.items()})
        B = len(g)
        sizes = ds.graph_num_nodes[g].astype(np.int64)
        starts = ds.graph_offsets[g]
        total = int(sizes.sum())
        if total > self.n_pad:
            raise ValueError(f"batch has {total} nodes > n_pad={self.n_pad}")

        local_start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        seg = np.repeat(np.arange(B), sizes)  # [total] graph slot per node
        within = np.arange(total) - np.repeat(local_start, sizes)
        gidx = (starts[seg] + within).astype(np.int64)  # global node ids

        # fixed-fanout sampling with replacement; isolated -> self
        deg_n = self._deg[gidx]
        off_n = ds.nbr_offsets[gidx]
        r = rng.integers(0, np.maximum(deg_n, 1)[:, None], size=(total, self.K))
        nbr_g = ds.nbr_ids[off_n[:, None] + r].astype(np.int64)
        nbr_g = np.where(deg_n[:, None] > 0, nbr_g, gidx[:, None])
        # global -> batch-local (neighbors never cross graph boundaries)
        shift = (local_start - starts)[seg]
        nbr_l = (nbr_g + shift[:, None]).astype(np.int32)
        self_l = np.arange(total, dtype=np.int32)
        neigh = np.concatenate([self_l[:, None], nbr_l], axis=1)

        # edges (CSR expansion of the selected graphs)
        e_total = int(deg_n.sum())
        if e_total > self.e_pad:
            raise ValueError(f"batch has {e_total} edges > e_pad={self.e_pad}")
        e_start = np.concatenate([[0], np.cumsum(deg_n)[:-1]])
        ptr = np.repeat(off_n, deg_n) + (
            np.arange(e_total) - np.repeat(e_start, deg_n)
        )
        edge_dst_g = ds.nbr_ids[ptr].astype(np.int64)
        edge_seg = np.repeat(seg, deg_n)
        edge_src = np.repeat(self_l, deg_n).astype(np.int32)
        edge_dst = (edge_dst_g + (local_start - starts)[edge_seg]).astype(np.int32)

        # padding
        N_pad, E_pad = self.n_pad, self.e_pad
        x = np.zeros((N_pad, ds.feature_dim), dtype=np.float32)
        x[:total] = ds.node_feat[gidx]
        neigh_p = np.tile(np.arange(N_pad, dtype=np.int32)[:, None], (1, self.K + 1))
        neigh_p[:total] = neigh
        graph_id = np.full(N_pad, B, dtype=np.int32)
        graph_id[:total] = seg
        node_gidx = np.zeros(N_pad, dtype=np.int32)
        node_gidx[:total] = gidx
        node_mask = np.zeros(N_pad, dtype=np.float32)
        node_mask[:total] = 1.0
        es = np.zeros(E_pad, dtype=np.int32)
        ed = np.zeros(E_pad, dtype=np.int32)
        em = np.zeros(E_pad, dtype=np.float32)
        es[:e_total] = edge_src
        ed[:e_total] = edge_dst
        em[:e_total] = 1.0

        arrays = dict(x=x, neigh=neigh_p, graph_id=graph_id,
                      node_gidx=node_gidx, node_mask=node_mask, edge_src=es,
                      edge_dst=ed, edge_mask=em,
                      labels=ds.labels[g].astype(np.int32))
        return GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})

    def sample(self) -> GraphBatch:
        """Random batch: a random subset of ``batch_size`` training graphs."""
        sel = self.rng.permutation(len(self.indices))[: self.batch_size]
        return self.build(self.indices[sel])

    def eval_batches(self, eval_indices: Sequence[int]):
        """Deterministic batches covering eval_indices in order; the last
        batch is padded by repeating the final graph (the caller masks it out
        via the returned count)."""
        idx = np.asarray(eval_indices)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            n_real = len(chunk)
            if n_real < self.batch_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1], self.batch_size - n_real)]
                )
            yield self.build(chunk), n_real


def whole_dataset_batch(ds: GraphDataset, num_neighbors: int,
                        pad_multiple: int = 128, seed: int = 123
                        ) -> GraphBatch:
    """One batch holding every graph (the transductive modes: the node
    trainer's one graph)."""
    builder = BatchBuilder(ds, batch_size=ds.num_graphs,
                           num_neighbors=num_neighbors,
                           pad_multiple=pad_multiple, seed=seed)
    return builder.build(np.arange(ds.num_graphs))
