"""Supervised U2GNN graph classification — port of ``U2GNNSup``
(``graph_transformer_tpu/models/u2gnn_sup.py``).

Three branches, as in the JAX model:

- **Fused training** (``sampled_inputs`` given; ``u2gnn_sup.py:110-183``),
  one U2GNN layer with codebook features: the sampled encoder samples the
  neighborhoods, builds their features from the codebook and encodes them;
  the self vectors are sum-pooled per graph, dropped out (``cfg.dropout``)
  and scored by a linear head.  The encoder is picked by shape
  (``:138-175``): kernels K1-K3 where the folded gate holds and D <= 32, else
  K5/K6 for D <= 128 and S <= 32 (``ops/stored_encoder.training_encoder``).
- **Two-pass training** (``neigh_feat`` given; ``:184-239``), any number of
  U2GNN layers and any features: the caller samples global neighbor ids
  (kernel K7) and gathers their features; per U2GNN layer the encoder K4t
  with the recompute backward K8/K8s (``ops/u2gnn_train.py``) encodes them,
  ``global_regather`` feeds the next layer, and the per-layer heads' scores
  add up.  Without a ``seed`` it is deterministic (rate 0, no head
  dropout), as the JAX model is with ``rng=None``.
- **Evaluation** (neither): the batch's fixed neighborhoods are gathered and
  encoded by the eval encoder (kernel K4, or the wide K4 past D = 32) at rate
  0, re-gathered batch-locally between U2GNN layers (``:233``).

The encoder dropout is 0.5 whatever ``cfg.dropout`` says, as in the
reference.  Within a training step, U2GNN layer i draws its encoder and head
dropout from ``ops.random.layer_seed(seed, i)``; layer 0 keeps the step's
seed, so that one layer on the two-pass path draws what the fused path
draws.

Ported so far: basic recurrence, one head, neighborhood-axis attention.
Anything else raises ``NotImplementedError`` naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    xavier_uniform,
)
from graph_transformer_tpu_torch.ops.random import (
    HEAD_STREAM,
    keep_mask,
    layer_seed,
)
from graph_transformer_tpu_torch.ops.sparse import (
    global_regather,
    graph_sum_pool,
)
from graph_transformer_tpu_torch.ops.stored_encoder import training_encoder
from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder
from graph_transformer_tpu_torch.ops.u2gnn_train import (
    check_two_pass_shapes,
    u2gnn_train_encoder,
)

ENCODER_DROPOUT = 0.5  # hard-coded in the reference (u2gnn_sup.py:157,207)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    gaps = []
    if cfg.recurrence != "basic":
        gaps.append(f"recurrence {cfg.recurrence!r} (ROADMAP.md Queue A, "
                    "'UT recurrences')")
    if cfg.num_heads != 1:
        gaps.append("num_heads > 1 (ROADMAP.md Queue B, "
                    "the per-layer encoder and FFN kernels)")
    if cfg.attention_axis != "neighborhood":
        gaps.append("attention_axis 'node' (ROADMAP.md Queue A, "
                    "'XLA-path encoder on both axes')")
    if cfg.model != "u2gnn_sup":
        gaps.append(f"model {cfg.model!r} (ROADMAP.md Queue A)")
    if gaps:
        raise NotImplementedError("not ported yet: " + "; ".join(gaps))


class U2GNNSup(nn.Module):
    """Parameters: ``encoders`` (one :class:`EncoderParams` per U2GNN layer),
    ``head_w`` [k, D, C] and ``head_b`` [k, C], named as the JAX
    ``U2GNNSupParams`` fields (see ``weights.params_from_jax``)."""

    def __init__(self, feature_dim: int, num_classes: int, cfg: ModelConfig,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.feature_dim, self.num_classes = feature_dim, num_classes
        k = cfg.num_hidden_layers
        D, C = feature_dim, num_classes
        tied = cfg.share_timestep_weights or cfg.recurrence != "basic"
        stored = 1 if tied else cfg.num_timesteps
        gen = torch.Generator().manual_seed(int(seed))
        self.encoders = nn.ModuleList(
            EncoderParams(stored, D, cfg.ff_hidden_size, gen) for _ in range(k))
        self.head_w = nn.Parameter(
            torch.stack([xavier_uniform((D, C), gen) for _ in range(k)]))
        self.head_b = nn.Parameter(torch.zeros(k, C))

    def forward(self, batch: GraphBatch, sampled_inputs: Optional[tuple] = None,
                seed: Optional[int] = None,
                neigh_feat: Optional[torch.Tensor] = None,
                neigh_global: Optional[torch.Tensor] = None,
                num_total_nodes: Optional[int] = None) -> torch.Tensor:
        """Scores [B, C].  Fused training: ``sampled_inputs`` = (tag_rows
        [N,128], deg [N], self_tag [N], codebook [C,D]) and an int ``seed``
        for the sampler and all dropout.  Two-pass training: ``neigh_feat``
        [N, K+1, D] gathered by the global ids ``neigh_global`` [N, K+1]
        (needed past one U2GNN layer, with ``num_total_nodes``) and a
        ``seed``, or none for a deterministic pass.  Evaluation: none of
        these."""
        if sampled_inputs is not None:
            return self._fused(batch, sampled_inputs, seed)
        if neigh_feat is not None:
            return self._two_pass(batch, neigh_feat, neigh_global,
                                  num_total_nodes, seed)
        return self._eval(batch)

    def _head(self, i: int, out: torch.Tensor, batch: GraphBatch,
              seed: Optional[int]) -> torch.Tensor:
        """Layer i's scores: pool the float32 self vectors of the real rows,
        head dropout (training), linear head."""
        mask = batch.node_mask[:, None]
        pooled = graph_sum_pool(out.to(torch.float32) * mask, batch.graph_id,
                                batch.num_graphs)
        rate = self.cfg.dropout
        if seed is not None and rate > 0.0:
            pooled = pooled * keep_mask(seed, HEAD_STREAM, pooled.shape, rate,
                                        pooled.device) / (1.0 - rate)
        return pooled @ self.head_w[i] + self.head_b[i]

    def _fused(self, batch, sampled_inputs, seed):
        if seed is None:
            raise ValueError("training needs a seed")
        if len(self.encoders) != 1:
            raise ValueError("the fused sampled encoders train one U2GNN "
                             "layer; deeper models take the two-pass path")
        tag_rows, deg, self_tag, codebook = sampled_inputs
        S = batch.neigh.shape[1]
        encoder = training_encoder(S, codebook.shape[1])
        out = encoder(tag_rows, deg, self_tag, codebook,
                      self.encoders[0].stacked(), S, self.cfg.num_timesteps,
                      ENCODER_DROPOUT, seed)
        return self._head(0, out, batch, seed)

    def _two_pass(self, batch, neigh_feat, neigh_global, num_total_nodes,
                  seed):
        cfg = self.cfg
        N, S, D = neigh_feat.shape
        check_two_pass_shapes(S, D)
        k = len(self.encoders)
        if k > 1 and (neigh_global is None or num_total_nodes is None):
            raise ValueError("a deeper two-pass model re-gathers by global id:"
                             " pass neigh_global and num_total_nodes")
        compute = COMPUTE_DTYPES[cfg.compute_dtype]
        rate = 0.0 if seed is None else ENCODER_DROPOUT
        x = neigh_feat.to(compute)
        scores = 0.0
        for i, enc in enumerate(self.encoders):
            s_i = None if seed is None else layer_seed(seed, i)
            out = u2gnn_train_encoder(x.reshape(N * S, D), enc.stacked(), S,
                                      cfg.num_timesteps, rate, s_i)
            out = out.to(compute)
            if i + 1 < k:
                x = global_regather(out, batch.node_gidx, batch.node_mask,
                                    neigh_global, num_total_nodes)
            scores = scores + self._head(i, out, batch, s_i)
        return scores

    def _eval(self, batch):
        compute = COMPUTE_DTYPES[self.cfg.compute_dtype]
        neigh = batch.neigh.to(torch.int64)
        N, S = neigh.shape
        x = batch.x.to(compute)
        scores = 0.0
        for i, enc in enumerate(self.encoders):
            with torch.no_grad():
                out = u2gnn_encoder(x[neigh].reshape(N * S, -1), enc.stacked(),
                                    S, self.cfg.num_timesteps).to(compute)
            x = out
            scores = scores + self._head(i, out, batch, None)
        return scores
