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

:func:`sample_neighborhoods` is the two-pass path's sampling stage, kernel
K7 (``ops/csrc/sampler.cu``), a port of ``resample_batch_neighbors_fast``
(``graph_transformer_tpu/sampling/pallas_sampler.py:165``, kernel
``_sample_kernel``) with the feature gather the JAX trainer runs after it:
one launch draws each batch row's neighbors from the dataset's table, writes
their feature rows and their batch slots (the rows of the batch that hold
them), so that a deeper model re-gathers a layer's output by slot.
:func:`sample_neighbors` draws the same ids from table rows the caller
gathered, through the same kernel.  On a CUDA tensor each launches K7, on a
CPU tensor each runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.random import device_seed, uniform_draws

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
    seed = device_seed(seed, rows.device)
    err = _build.load("sampler").gt_k7_sample(
        rows.data_ptr(), W, deg.data_ptr(), 0, gidx.data_ptr(), None, None, 0,
        None, None, out.data_ptr(), N, K, seed.data_ptr(),
        _build.stream_ptr(rows.device))
    _build.check(err, "K7 sample")
    sample_neighbors.launches += 1
    return out


sample_neighbors.launches = 0


def sample_neighborhoods_plain(seed: int, table: torch.Tensor,
                               deg: torch.Tensor, x_global: torch.Tensor,
                               node_gidx: torch.Tensor,
                               node_mask: torch.Tensor, K: int,
                               with_ids: bool = False) -> tuple:
    """The plain version of K7's sampling stage: (feat [N, K+1, D] in
    ``x_global``'s dtype, slots [N, K+1] int64, ids [N, K+1] int32 or
    None).  ``ids`` are :func:`sample_neighbors_plain`'s draws from the
    dataset's ``table`` and ``deg`` at the batch's ``node_gidx``, ``feat``
    is ``x_global[ids]`` and a real row n (``node_mask > 0``) has the slots
    ``n + ids - node_gidx[n]``, the batch rows that hold its neighbors (the
    batch keeps each graph's nodes together in global order); a padding row
    has slots n."""
    g = node_gidx.to(torch.int64)
    ids = sample_neighbors_plain(seed, table[g], deg[g], node_gidx, K)
    n = torch.arange(g.shape[0], device=g.device)[:, None]
    slots = torch.where(node_mask[:, None] > 0, n + ids - g[:, None], n)
    return x_global[ids.to(torch.int64)], slots, ids if with_ids else None


def sample_neighborhoods(seed: int, table: torch.Tensor, deg: torch.Tensor,
                         x_global: torch.Tensor, node_gidx: torch.Tensor,
                         node_mask: torch.Tensor, K: int,
                         with_ids: bool = False) -> tuple:
    """K7 on CUDA tensors, :func:`sample_neighborhoods_plain` on CPU tensors:
    (feat, slots, ids or None) of a batch's rows, as the plain version
    says.  The dataset's ``table`` [num_nodes, 128] int32, ``deg``
    [num_nodes] int32 and ``x_global`` [num_nodes, D] (float32 or bf16)
    and the batch's ``node_gidx`` [N] int32 and ``node_mask`` [N] float32
    are taken as they are: contiguous, of these dtypes, or the wrapper
    raises (the trainer prepares them once, so a step converts nothing)."""
    if not table.is_cuda:
        return sample_neighborhoods_plain(seed, table, deg, x_global,
                                          node_gidx, node_mask, K, with_ids)
    for t, dt in ((table, torch.int32), (deg, torch.int32),
                  (node_gidx, torch.int32), (node_mask, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"K7 takes contiguous {dt}, got {t.dtype}")
    _build.check_rows_dtype(x_global)
    if table.shape[1] != TABLE_WIDTH or not x_global.is_contiguous():
        raise ValueError("K7 takes 128-wide table rows and contiguous "
                         "feature rows")
    N, D = node_gidx.shape[0], x_global.shape[1]
    dev = table.device
    feat = torch.empty(N, K + 1, D, dtype=x_global.dtype, device=dev)
    slots = torch.empty(N, K + 1, dtype=torch.int64, device=dev)
    ids = (torch.empty(N, K + 1, dtype=torch.int32, device=dev) if with_ids
           else None)
    seed = device_seed(seed, dev)
    err = _build.load("sampler").gt_k7_sample(
        table.data_ptr(), TABLE_WIDTH, deg.data_ptr(), 1, node_gidx.data_ptr(),
        node_mask.data_ptr(), x_global.data_ptr(),
        D * x_global.element_size(), feat.data_ptr(), slots.data_ptr(),
        None if ids is None else ids.data_ptr(), N, K, seed.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "K7 sample")
    sample_neighborhoods.launches += 1
    return feat, slots, ids


sample_neighborhoods.launches = 0
