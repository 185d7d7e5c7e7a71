"""Fixed-fanout neighborhood sampling over a CSR adjacency — port of
``graph_transformer_tpu/sampling/neighbors.py``.

The dataset's CSR adjacency lives on the device once (:class:`DeviceCSR`);
a draw is two gathers and one uniform integer per slot, in plain torch (XLA
in JAX).  The integers are ``min(floor(u · deg), deg - 1)`` with ``u`` the
top 24 bits of a word of ``ops/random`` (:func:`csr_draws`), keyed by an
explicit seed, so the card and the CPU draw the same neighbors.  The JAX
package draws with ``jax.random.randint``; tests hand its draws to the
functions that take them.

Semantics as the reference's: K neighbors uniformly *with replacement* from
the (deduplicated, bidirected) neighbor list, self at slot 0, isolated nodes
filled with self; ids and slots are int32, as JAX's.  The unsupervised
trainer's ``sampler_type='neighbor'`` loss reads the CSR
(``ops/sampled_neighbor.py``); its two-pass path samples with kernel K7
(``sampling/neighbor_table.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.ops.random import random_bits

CSR_STREAM = 0x43535252


@dataclasses.dataclass
class DeviceCSR:
    """CSR adjacency on a device (global node ids)."""

    offsets: torch.Tensor  # [N+1] int64
    nbr_ids: torch.Tensor  # [2E] int64
    degrees: torch.Tensor  # [N] int64

    @staticmethod
    def from_dataset(ds: GraphDataset, device="cpu") -> "DeviceCSR":
        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        return DeviceCSR(offsets=dev(ds.nbr_offsets), nbr_ids=dev(ds.nbr_ids),
                         degrees=dev(ds.degrees))

    def gather(self, pos: torch.Tensor) -> torch.Tensor:
        """``nbr_ids[pos]`` with positions clamped into the list, as XLA
        clamps a gather (an isolated node's position may be the list's
        end; its entries are replaced by the caller)."""
        return self.nbr_ids[pos.clamp(0, max(self.nbr_ids.numel() - 1, 0))]


def csr_draws(seed: int, deg: torch.Tensor, k: int,
              stream: int = CSR_STREAM) -> torch.Tensor:
    """[n, k] int64 uniform integers in ``[0, max(deg, 1))`` for the [n]
    degrees ``deg``: ``min(floor(u · d), d - 1)``, ``u`` the top 24 bits of
    word ``(i, j)`` of ``stream`` over 2^24, computed in float64."""
    n = deg.shape[0]
    bits = random_bits(seed, stream, n * k, deg.device).view(n, k)
    u = (bits >> 8).to(torch.float64) * (1.0 / (1 << 24))
    d = deg.clamp_min(1).to(torch.float64)[:, None]
    return torch.minimum(torch.floor(u * d), d - 1.0).to(torch.int64)


def neighborhoods_given(csr: DeviceCSR, node_gidx: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    """[N, K+1] int32 global neighbor ids (slot 0 = self) of ``node_gidx``
    [N] for the draws ``r`` [N, K] (positions in each node's neighbor
    list)."""
    g = node_gidx.to(torch.int64)
    deg = csr.degrees[g]
    nbr = csr.gather(csr.offsets[g][:, None] + r.to(torch.int64))
    nbr = torch.where(deg[:, None] > 0, nbr, g[:, None])
    return torch.cat([g[:, None], nbr], dim=1).to(torch.int32)


def sample_neighborhoods(seed: int, csr: DeviceCSR, node_gidx: torch.Tensor,
                         num_neighbors: int) -> torch.Tensor:
    """Sample ``[N, K+1]`` *global* neighbor ids (slot 0 = self), uniform
    with replacement over each node's CSR list; degree-0 nodes are filled
    with themselves."""
    deg = csr.degrees[node_gidx.to(torch.int64)]
    return neighborhoods_given(csr, node_gidx,
                               csr_draws(seed, deg, num_neighbors))


def global_to_local(neigh_global: torch.Tensor, node_gidx: torch.Tensor,
                    total_nodes: int,
                    node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Globally-indexed neighborhoods to int32 batch-local slot indices,
    through a global-to-local table [total_nodes+1]; neighbors of real nodes lie in
    the same graph and hence in the batch.  Padding slots all carry
    ``node_gidx == 0`` and would clobber global node 0's entry, so their
    writes go to a sentinel row."""
    g = node_gidx.to(torch.int64)
    write = g if node_mask is None else torch.where(node_mask > 0, g,
                                                    total_nodes)
    g2l = torch.zeros(total_nodes + 1, dtype=torch.int32, device=g.device)
    g2l[write] = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
    return g2l[neigh_global.to(torch.int64)]


def resample_batch_neighbors(seed: int, csr: DeviceCSR,
                             node_gidx: torch.Tensor, node_mask: torch.Tensor,
                             num_neighbors: int,
                             total_nodes: int) -> torch.Tensor:
    """Fresh ``[N_pad, K+1]`` int32 batch-local neighborhoods for a padded
    batch; padding slots (mask 0) point at themselves."""
    neigh_g = sample_neighborhoods(seed, csr, node_gidx, num_neighbors)
    neigh_l = global_to_local(neigh_g, node_gidx, total_nodes, node_mask)
    self_l = torch.arange(node_gidx.shape[0], dtype=torch.int32,
                          device=neigh_l.device)[:, None]
    return torch.where(node_mask[:, None] > 0, neigh_l, self_l)


def build_padded_neighbor_table(ds: GraphDataset,
                                max_degree: Optional[int] = None) -> np.ndarray:
    """Dense ``[N, max_deg]`` padded neighbor table (self-padded), the first
    ``max_deg`` entries of each list."""
    deg = ds.degrees
    md = int(deg.max()) if max_degree is None else max_degree
    n = ds.num_nodes
    table = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, md))
    for v in range(n):
        s, e = ds.nbr_offsets[v], ds.nbr_offsets[v + 1]
        take = min(md, e - s)
        table[v, :take] = ds.nbr_ids[s: s + take]
    return table
