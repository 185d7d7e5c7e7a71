"""Padded-batch assembly on the device — port of
``graph_transformer_tpu/data/device_batcher.py``.

Graphs are stored as contiguous global-node ranges
(``GraphDataset.graph_offsets``), so a padded batch of ``B`` graph ids is a
ragged gather: cumsum, searchsorted and gathers, all of fixed shape and with
no host round trip.  The on-device CV (``train/cv_ondevice.py``) assembles
every training batch so.

The layout is exactly the host builder's (``BatchBuilder.build``): the
selected graphs' nodes in order, padded to ``n_pad``; padding rows carry
``graph_id == B`` (dropped by pooling), ``node_gidx == 0`` and
``node_mask == 0``.  Neighborhoods are not drawn here: ``neigh`` is each
row's own slot, which a training step replaces with K7's batch slots.  The
edge arrays are one-element stubs: the U2GNN models never read them.
"""

from __future__ import annotations

import dataclasses

import torch

from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.data.tu import GraphDataset


@dataclasses.dataclass
class DeviceDataset:
    """The dataset arrays a batch gather needs, in device memory."""

    x: torch.Tensor  # [N, D] float32 node features
    graph_offsets: torch.Tensor  # [G+1] int64
    labels: torch.Tensor  # [G] int32

    @staticmethod
    def from_dataset(ds: GraphDataset, device="cuda") -> "DeviceDataset":
        return DeviceDataset(
            x=torch.as_tensor(ds.node_feat, dtype=torch.float32,
                              device=device),
            graph_offsets=torch.as_tensor(ds.graph_offsets,
                                          dtype=torch.int64, device=device),
            labels=torch.as_tensor(ds.labels, dtype=torch.int32,
                                   device=device))


def assemble_batch(dd: DeviceDataset, gids: torch.Tensor,
                   n_pad: int) -> GraphBatch:
    """The padded :class:`GraphBatch` of the graphs ``gids`` [B], on
    ``dd``'s device.  ``n_pad`` must bound the node count of any B graphs;
    the host builder's (``BatchBuilder.n_pad``) does."""
    gids = torch.as_tensor(gids, device=dd.x.device).to(torch.int64)
    B = gids.shape[0]
    starts = dd.graph_offsets[gids]
    sizes = dd.graph_offsets[gids + 1] - starts
    cum = torch.cumsum(sizes, 0)
    slot = torch.arange(n_pad, device=gids.device)
    # the graph slot owning each batch row: the first g with cum[g] > slot
    seg = torch.searchsorted(cum, slot, right=True).clamp_max(B - 1)
    real = slot < cum[-1]
    gidx = torch.where(real, starts[seg] + slot - (cum[seg] - sizes[seg]), 0)
    mask = real.to(torch.float32)
    stub = torch.zeros(1, dtype=torch.int32, device=gids.device)
    return GraphBatch(
        x=dd.x[gidx] * mask[:, None],
        neigh=slot.to(torch.int32)[:, None],
        graph_id=torch.where(real, seg, B).to(torch.int32),
        node_gidx=gidx.to(torch.int32),
        node_mask=mask,
        edge_src=stub,
        edge_dst=stub,
        edge_mask=stub.to(torch.float32),
        labels=dd.labels[gids])
