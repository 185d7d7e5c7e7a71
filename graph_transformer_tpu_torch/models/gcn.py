"""GCN encoder baseline — port of ``graph_transformer_tpu/models/gcn.py``.

A VGAE-style GCN encoder (``gcn_pytorch.py`` + ``layers.py:16-49``): a
shared first layer, ReLU, dropout, and mu / sigma heads of latent width 2
(the reference hard-codes it), each layer ``A_hat @ (X W) + b`` with the
symmetric Kipf normalization ``D^-1/2 (A + I) D^-1/2`` over the batch's
padded edge list (``ops/sparse.py``: deterministic segment reductions).
``X W`` is ``torch.matmul``: the JAX package computes it outside any Pallas
kernel.  The three losses of the U2GNN node model: the sampled softmax over
the node vocabulary (``ss``), the contrastive loss and the GAE loss over the
dense adjacency.

Parameters, named as the JAX ``GCNParams`` fields
(``weights.params_from_jax``): ``gc1``, ``gc2_mu``, ``gc2_sig`` (each
``w`` [in, out], ``b``), ``ss.weight``, ``ss.bias``.  Without a ``seed``
the pass is deterministic (no dropout), as the JAX model is with
``rng=None``; with one, the dropout draws from ``ops/random`` stream
``BASELINE_STREAM`` of the seed and the candidates from the seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    SampledSoftmaxParams,
)
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.ops.losses import gae_loss, supcon_loss
from graph_transformer_tpu_torch.ops.random import keep_mask
from graph_transformer_tpu_torch.ops.sparse import (
    Segments,
    gcn_norm_edges,
    spmm,
)
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec

LATENT_DIM = 2  # the reference hard-codes it (gcn_pytorch.py:56)
BASELINE_STREAM = 0x42534C4E


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            site: int) -> torch.Tensor:
    """Inverted dropout of ``x`` at ``rate``, the mask from stream
    ``BASELINE_STREAM + site`` of ``seed``; ``x`` itself without a seed or
    at rate 0."""
    if seed is None or rate <= 0.0:
        return x
    keep = keep_mask(seed, BASELINE_STREAM + site, x.shape, rate, x.device)
    return x * keep / (1.0 - rate)


class LayerParams(nn.Module):
    """``w`` [in, out] (uniform in ±gain·sqrt(6/(in+out))), ``b`` zeros
    and, with ``attention``, the GAT's ``a`` [2·out]."""

    def __init__(self, din: int, dout: int, gen: torch.Generator,
                 gain: float = 1.0, attention: bool = False):
        super().__init__()

        def uniform(shape):
            bound = gain * math.sqrt(6.0 / (shape[0] + shape[1]))
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

        self.w = nn.Parameter(uniform((din, dout)))
        self.a = (nn.Parameter(uniform((2 * dout, 1))[:, 0]) if attention
                  else None)
        self.b = nn.Parameter(torch.zeros(dout))


@dataclasses.dataclass
class GCNGraph:
    """A batch's normalized, self-looped edges grouped by source and by
    target, and their values: built once a batch."""

    src: Segments
    dst: Segments
    val: torch.Tensor

    @classmethod
    def of(cls, batch: GraphBatch) -> "GCNGraph":
        n = batch.n_pad
        src, dst, val = gcn_norm_edges(batch.edge_src, batch.edge_dst,
                                       batch.edge_mask, n)
        return cls(Segments.of(src, n), Segments.of(dst, n), val)


def unsup_loss(model, z: torch.Tensor, batch: GraphBatch,
               spec: LogUniformSpec, seed: Optional[int],
               candidates: Optional[tuple],
               adj_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The GCN's and GAT's loss of embeddings ``z``: the summed sampled
    softmax (candidates drawn from ``seed`` unless given), the contrastive
    loss or the GAE loss over ``adj_mask``."""
    loss_type = model.cfg.loss_type
    if loss_type == "default":
        if candidates is None:
            if seed is None:
                raise ValueError("the sampler's draws need a seed")
            candidates = sampled_softmax.draw_candidates(seed, spec, z.device)
        return sampled_softmax.loss_given(
            model.ss.weight, model.ss.bias, z, batch.node_gidx, *candidates,
            spec, model.cfg.sampled_softmax_mode, batch.node_mask).sum()
    if adj_mask is None:
        raise ValueError(f"{loss_type} loss needs adj_mask")
    if loss_type == "contrastive":
        return supcon_loss(z, mask=adj_mask, valid=batch.node_mask)
    if loss_type == "gae":
        n_real = batch.node_mask.sum()
        n_pos = adj_mask.sum()
        norm = (n_real * n_real) / torch.clamp_min(
            2.0 * (n_real * n_real - n_pos), 1.0)
        return gae_loss([z], adj_mask[:, :, None], norm)
    raise ValueError(f"unknown loss_type {loss_type!r}")


class GCNModel(nn.Module):
    """VGAE-style GCN encoder with the unsup loss heads."""

    weight = None  # no cross-attention table: evaluation reads ss.weight

    def __init__(self, feature_dim: int, vocab_size: int, cfg: ModelConfig,
                 seed: int = 0, latent_dim: int = LATENT_DIM):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        H = cfg.ff_hidden_size
        gen = torch.Generator().manual_seed(int(seed))
        self.gc1 = LayerParams(feature_dim, H, gen)
        self.gc2_mu = LayerParams(H, latent_dim, gen)
        self.gc2_sig = LayerParams(H, latent_dim, gen)
        self.ss = SampledSoftmaxParams(vocab_size, latent_dim, gen)

    def spec(self) -> LogUniformSpec:
        return LogUniformSpec.create(self.vocab_size, self.cfg.sampled_num)

    def prepare(self, batch: GraphBatch) -> GCNGraph:
        return GCNGraph.of(batch)

    def _layer(self, p: LayerParams, x, g: GCNGraph) -> torch.Tensor:
        return spmm(g.src, g.dst, g.val, x @ p.w) + p.b

    def encode(self, batch: GraphBatch, seed: Optional[int] = None,
               graph: Optional[GCNGraph] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma): shared first layer, ReLU, dropout, two heads."""
        g = graph if graph is not None else self.prepare(batch)
        h = torch.relu(self._layer(self.gc1, batch.x, g))
        h = dropout(h, self.cfg.dropout, seed, 0)
        mu = self._layer(self.gc2_mu, h, g)
        return mu, torch.exp(self._layer(self.gc2_sig, h, g))

    def loss(self, batch: GraphBatch, spec: LogUniformSpec,
             seed: Optional[int] = None, candidates: Optional[tuple] = None,
             adj_mask: Optional[torch.Tensor] = None,
             graph: Optional[GCNGraph] = None) -> torch.Tensor:
        z, _ = self.encode(batch, seed, graph)
        return unsup_loss(self, z, batch, spec, seed, candidates, adj_mask)

    def node_embeddings(self) -> torch.Tensor:
        """The sampled softmax's output table [V, 2]."""
        return self.ss.weight
