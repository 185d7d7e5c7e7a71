"""Unsupervised GCN baseline for graph classification — port of
``graph_transformer_tpu/models/gcn_unsup_graphs.py``.

The reference's TF1 baseline (``gcn_baseline/``): k Kipf GCN layers on the
batch's block-diagonal graph with self-loops and the symmetric
normalization (``train_unsup_gcn.py:53-72``, ``gcn_layer.py:106-155``),
dropout on each layer's input, the ReLU outputs **concatenated** into
``[N_pad, k·H]`` (``model_unsup_gcn.py:40-49``) and scored by the sampled
softmax over the node vocabulary, each node's label its own global id; the
loss is the sum over the batch's nodes.  Evaluation reads the output table
``ss.weight`` [V, k·H] (``train_unsup_gcn.py:180-201``).

Built from the node baselines' parts (``models/gcn.py``): ``LayerParams``,
``GCNGraph.of(batch)`` (the segment reductions of ``ops/sparse.py``) and
``dropout``, with the sampled softmax of ``ops/sampled_softmax.py``.  No
kernel: JAX runs this model's products and its SpMM in XLA, outside any
Pallas kernel; ``X W`` is ``torch.matmul``.

Parameters, named as the JAX ``GCNGraphUnsupParams`` fields
(``weights.params_from_jax``): ``layers.<i>.w`` [in, out], ``layers.<i>.b``,
``ss.weight``, ``ss.bias``.  Without a ``seed`` the pass is deterministic (no
dropout), as JAX's is with ``rng=None``; with one, layer i's input dropout
draws from ``models/gcn.dropout``'s stream of site i and the candidates from
the seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.models.gcn import (
    GCNGraph,
    LayerParams,
    dropout,
)
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    SampledSoftmaxParams,
)
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.ops.sparse import spmm
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec


class GCNGraphUnsup(nn.Module):
    """``cfg.num_hidden_layers`` GCN layers of width ``cfg.ff_hidden_size``
    with the sampled-softmax head (the trainer interface of
    ``U2GNNUnsup``)."""

    def __init__(self, feature_dim: int, vocab_size: int, cfg: ModelConfig,
                 seed: int = 0):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        k, h = cfg.num_hidden_layers, cfg.ff_hidden_size
        dims = [feature_dim] + [h] * k
        gen = torch.Generator().manual_seed(int(seed))
        self.layers = nn.ModuleList(
            LayerParams(dims[i], dims[i + 1], gen) for i in range(k))
        self.ss = SampledSoftmaxParams(vocab_size, self.embedding_dim, gen)

    @property
    def embedding_dim(self) -> int:
        return self.cfg.num_hidden_layers * self.cfg.ff_hidden_size

    def spec(self) -> LogUniformSpec:
        return LogUniformSpec.create(self.vocab_size, self.cfg.sampled_num)

    def encode(self, batch: GraphBatch, seed: Optional[int] = None,
               graph: Optional[GCNGraph] = None) -> torch.Tensor:
        """[N_pad, k·H]: the layers' ReLU outputs concatenated."""
        g = graph if graph is not None else GCNGraph.of(batch)
        h, outs = batch.x, []
        for i, layer in enumerate(self.layers):
            h = dropout(h, self.cfg.dropout, seed, i)
            h = torch.relu(spmm(g.src, g.dst, g.val, h @ layer.w) + layer.b)
            outs.append(h)
        return torch.cat(outs, dim=-1)

    def loss(self, batch: GraphBatch, spec: LogUniformSpec,
             seed: Optional[int] = None, candidates: Optional[tuple] = None,
             vocab_perm: Optional[torch.Tensor] = None,
             graph: Optional[GCNGraph] = None) -> torch.Tensor:
        """The summed sampled softmax of the batch's nodes; the candidates
        ``candidates`` = (ids, valid or None), or drawn from ``seed``.
        ``vocab_perm``: node v trains output row ``vocab_perm[v]``."""
        z = self.encode(batch, seed, graph)
        labels = batch.node_gidx.to(torch.int64)
        if vocab_perm is not None:
            labels = vocab_perm[labels]
        if candidates is None:
            if seed is None:
                raise ValueError("the sampler's draws need a seed")
            candidates = sampled_softmax.draw_candidates(seed, spec,
                                                         z.device)
        return sampled_softmax.loss_given(
            self.ss.weight, self.ss.bias, z, labels, *candidates, spec,
            self.cfg.sampled_softmax_mode, batch.node_mask).sum()

    def node_embeddings(self, vocab_perm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """The output table ``ss.weight``, rows in node order under
        ``vocab_perm``."""
        if vocab_perm is not None:
            return self.ss.weight[vocab_perm]
        return self.ss.weight
