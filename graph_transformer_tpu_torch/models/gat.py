"""GAT encoder baseline — port of ``graph_transformer_tpu/models/gat.py``.

The reference GATConv (``layers.py:74-92``) fills a dense N×N matrix with
-1e20, scatters per-edge leaky-ReLU scores into it and row-softmaxes it;
here, as in JAX, the same function runs over the padded edge list: scores
``e = leaky_relu(h[src]·a_1 + h[dst]·a_2)``, a softmax over each *source*
segment (the reference's row-major ``attention[source, :]``), and messages
``att · h[dst]`` summed into the source (``ops/sparse.py``: deterministic
segment reductions).  The scores take ``h @ a_1`` and ``h @ a_2`` per node
and gather them, the same function as JAX's per-edge products.  The encoder
is the GCN's (``models/gcn.py``) with GAT layers: shared first layer, ReLU,
dropout, mu / sigma heads of latent width 2, and the same three losses.

Dropout (``cfg.dropout``; with a ``seed`` only) from ``ops/random`` streams
``BASELINE_STREAM + 4·layer + site`` of the seed: each layer's input
(site 0), attention (1) and features (2); the first layer's output (site 3
of layer 0).  Parameters as the JAX ``GATParams`` (``gc1``, ``gc2_mu``,
``gc2_sig``, each ``w``, ``a``, ``b``; ``ss``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.models.gcn import (
    LATENT_DIM,
    LayerParams,
    dropout,
    unsup_loss,
)
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    SampledSoftmaxParams,
)
from graph_transformer_tpu_torch.ops.sparse import (
    Segments,
    edge_softmax,
    gather,
    segment_sum,
)
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec

GAIN = 1.414  # xavier_uniform_ gain of the reference (layers.py:68-72)
ALPHA = 0.2  # leaky-ReLU slope (gat_pytorch.py:24)


@dataclasses.dataclass
class GATGraph:
    """A batch's edges grouped by source and by target, and their mask."""

    src: Segments
    dst: Segments
    mask: torch.Tensor

    @classmethod
    def of(cls, batch: GraphBatch) -> "GATGraph":
        n = batch.n_pad
        return cls(Segments.of(batch.edge_src, n),
                   Segments.of(batch.edge_dst, n), batch.edge_mask)


def gat_layer(p: LayerParams, x: torch.Tensor, g: GATGraph,
              alpha: float = ALPHA, rate: float = 0.0,
              seed: Optional[int] = None, layer: int = 0) -> torch.Tensor:
    """One GAT convolution: softmax over each source's outgoing edges,
    messages from the targets summed into the source."""
    site = 4 * layer
    x = dropout(x, rate, seed, site)
    h = x @ p.w  # [N, dout]
    dout = h.shape[-1]
    e = gather(h @ p.a[:dout], g.src) + gather(h @ p.a[dout:], g.dst)
    e = torch.nn.functional.leaky_relu(e, negative_slope=alpha)
    att = edge_softmax(e, g.src, g.mask)
    att = dropout(att, rate, seed, site + 1)
    h = dropout(h, rate, seed, site + 2)
    return segment_sum(att[:, None] * gather(h, g.dst), g.src) + p.b


class GATModel(nn.Module):
    """Sparse GAT encoder with the unsup loss heads."""

    weight = None  # no cross-attention table: evaluation reads ss.weight

    def __init__(self, feature_dim: int, vocab_size: int, cfg: ModelConfig,
                 seed: int = 0, latent_dim: int = LATENT_DIM,
                 alpha: float = ALPHA):
        super().__init__()
        self.cfg, self.vocab_size, self.alpha = cfg, vocab_size, alpha
        H = cfg.ff_hidden_size
        gen = torch.Generator().manual_seed(int(seed))
        self.gc1 = LayerParams(feature_dim, H, gen, GAIN, attention=True)
        self.gc2_mu = LayerParams(H, latent_dim, gen, GAIN, attention=True)
        self.gc2_sig = LayerParams(H, latent_dim, gen, GAIN, attention=True)
        self.ss = SampledSoftmaxParams(vocab_size, latent_dim, gen)

    def spec(self) -> LogUniformSpec:
        return LogUniformSpec.create(self.vocab_size, self.cfg.sampled_num)

    def prepare(self, batch: GraphBatch) -> GATGraph:
        return GATGraph.of(batch)

    def encode(self, batch: GraphBatch, seed: Optional[int] = None,
               graph: Optional[GATGraph] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma): shared first layer, ReLU, dropout, two heads."""
        g = graph if graph is not None else self.prepare(batch)
        dr = self.cfg.dropout
        h = torch.relu(gat_layer(self.gc1, batch.x, g, self.alpha, dr, seed,
                                 0))
        h = dropout(h, dr, seed, 3)
        mu = gat_layer(self.gc2_mu, h, g, self.alpha, dr, seed, 1)
        log_sig = gat_layer(self.gc2_sig, h, g, self.alpha, dr, seed, 2)
        return mu, torch.exp(log_sig)

    def loss(self, batch: GraphBatch, spec: LogUniformSpec,
             seed: Optional[int] = None, candidates: Optional[tuple] = None,
             adj_mask: Optional[torch.Tensor] = None,
             graph: Optional[GATGraph] = None) -> torch.Tensor:
        z, _ = self.encode(batch, seed, graph)
        return unsup_loss(self, z, batch, spec, seed, candidates, adj_mask)

    def node_embeddings(self) -> torch.Tensor:
        """The sampled softmax's output table [V, 2]."""
        return self.ss.weight
