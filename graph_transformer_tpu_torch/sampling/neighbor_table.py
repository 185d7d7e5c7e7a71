"""Neighbor and tag tables, and the two-pass path's neighbor sampler.

Ports of ``build_neighbor_table`` (``graph_transformer_tpu/sampling/
pallas_sampler.py:69-91``) and of ``dataset_codebook``, ``build_tag_table``
and ``setup_fused_tables`` (``graph_transformer_tpu/ops/
pallas_sampled_encoder.py:88-136``).  All numpy; the tables are built once per
trainer and moved to the device.

Row v of the neighbor table holds v's neighbor list tiled to 128 entries (self
for isolated nodes).  A hub whose degree exceeds 128 holds a seeded uniform
with-replacement 128-subsample of its list instead; the sampler clamps the
degree to 128, so every draw stays marginally uniform over the true list.
The subsample is drawn once per trainer build, as in the JAX package.

:func:`sample_neighbors` is the two-pass path's sampler, kernel K7
(``ops/csrc/sampler.cu``), a port of ``resample_batch_neighbors_fast``
(``graph_transformer_tpu/sampling/pallas_sampler.py:165``, kernel
``_sample_kernel``): on a CUDA tensor it launches K7, on a CPU tensor it runs
:func:`sample_neighbors_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.random import M32, uniform_draws

TABLE_WIDTH = 128  # entries per table row; the sampler clamps degree to it


def build_neighbor_table(ds: GraphDataset, hub_seed: int = 0) -> np.ndarray:
    """[num_nodes, 128] int32 global-id table (see module docstring)."""
    n = ds.num_nodes
    table = np.empty((n, TABLE_WIDTH), np.int32)
    rng = np.random.default_rng(hub_seed)
    for v in range(n):
        s, e = ds.nbr_offsets[v], ds.nbr_offsets[v + 1]
        if e - s > TABLE_WIDTH:
            table[v] = rng.choice(ds.nbr_ids[s:e], TABLE_WIDTH)
        elif e > s:
            reps = -(-TABLE_WIDTH // (e - s))
            table[v] = np.tile(ds.nbr_ids[s:e], reps)[:TABLE_WIDTH]
        else:
            table[v] = v
    return table


def dataset_codebook(node_feat: np.ndarray, max_codes: int = TABLE_WIDTH):
    """(tags [N] i32, codebook [n_codes, D] f32) when the feature rows take at
    most ``max_codes`` distinct values; None when they do not."""
    f = np.asarray(node_feat, np.float32)
    if f.ndim != 2:
        return None
    codes, tags = np.unique(f, axis=0, return_inverse=True)
    if codes.shape[0] > max_codes:
        return None
    return tags.reshape(-1).astype(np.int32), codes.astype(np.float32)


def build_tag_table(neighbor_table: np.ndarray, tags: np.ndarray) -> np.ndarray:
    """[N, 128] int32 — the neighbor table with every id replaced by that
    neighbor's tag."""
    return tags[neighbor_table].astype(np.int32)


def setup_fused_tables(node_feat, neighbor_table: np.ndarray):
    """(tag_table [N,128] i32, tags [N] i32, codebook [C,D] f32) when the
    dataset's features factor through a ≤128-row codebook; None otherwise."""
    cb = dataset_codebook(node_feat)
    if cb is None:
        return None
    tags, codebook = cb
    return build_tag_table(neighbor_table, tags), tags, codebook


def sample_neighbors_plain(seed: int, table_rows: torch.Tensor,
                           deg: torch.Tensor, node_gidx: torch.Tensor,
                           K: int) -> torch.Tensor:
    """The plain version of K7: [N, K+1] int32 global neighbor ids, slot 0
    the node itself (``node_gidx``), slots 1..K the entries
    ``min(floor(u·d), d-1)`` of the node's ``table_rows`` row with
    ``d = clamp(deg, 1, 128)``.  The draws are K1's (``uniform_draws``), so a
    codebook dataset gets the neighborhoods K1 draws for the same seed."""
    N = table_rows.shape[0]
    draws = uniform_draws(seed, N, K, deg.reshape(-1), TABLE_WIDTH)
    ids = table_rows.to(torch.int64).gather(1, draws)
    return torch.cat([node_gidx.reshape(N, 1).to(torch.int64), ids],
                     dim=1).to(torch.int32)


def sample_neighbors(seed: int, table_rows: torch.Tensor, deg: torch.Tensor,
                     node_gidx: torch.Tensor, K: int) -> torch.Tensor:
    """K7 on CUDA tensors, :func:`sample_neighbors_plain` on CPU tensors.
    ``table_rows`` [N, 128] int global ids, ``deg`` [N] or [N, 1] int,
    ``node_gidx`` [N] int; returns [N, K+1] int32."""
    if not table_rows.is_cuda:
        return sample_neighbors_plain(seed, table_rows, deg, node_gidx, K)
    N, W = table_rows.shape
    if W != TABLE_WIDTH:
        raise ValueError(f"table rows are {TABLE_WIDTH} wide, got {W}")
    rows = table_rows.to(torch.int32).contiguous()
    deg = deg.to(torch.int32).reshape(N).contiguous()
    gidx = node_gidx.to(torch.int32).reshape(N).contiguous()
    out = torch.empty(N, K + 1, dtype=torch.int32, device=rows.device)
    err = _build.load("sampler").gt_k7_sample(
        rows.data_ptr(), W, deg.data_ptr(), gidx.data_ptr(), out.data_ptr(),
        N, K, int(seed) & M32, _build.stream_ptr(rows.device))
    _build.check(err, "K7 sample")
    sample_neighbors.launches += 1
    return out


sample_neighbors.launches = 0
