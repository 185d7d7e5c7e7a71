"""Supervised U2GNN graph classification — port of ``U2GNNSup``
(``graph_transformer_tpu/models/u2gnn_sup.py``).

Training (``sampled_inputs`` given) is the JAX model's fused branch
(``u2gnn_sup.py:110-183``): the sampled encoder samples the neighborhoods,
builds their features from the codebook and encodes them; the self vectors
are sum-pooled per graph, dropped out (``cfg.dropout``) and scored by a
linear head.  The encoder is picked by shape, as in the JAX model
(``:138-175``): kernels K1-K3 where the folded gate holds and D <= 32, else
K5/K6 for D <= 128 and S <= 32 (``ops/stored_encoder.training_encoder``).
Evaluation (no ``sampled_inputs``) is the deterministic branch
(``:184-239``): the batch's fixed neighborhoods are gathered and encoded by
the eval encoder (kernel K4, or the wide K4 past D = 32) at rate 0.  The
encoder dropout is 0.5 whatever ``cfg.dropout`` says, as in the reference.

The slice ported so far is the configuration the main path runs: one hidden
U2GNN layer, basic recurrence, one head, neighborhood-axis attention.
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
from graph_transformer_tpu_torch.ops.random import HEAD_STREAM, keep_mask
from graph_transformer_tpu_torch.ops.sparse import graph_sum_pool
from graph_transformer_tpu_torch.ops.stored_encoder import training_encoder
from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder

ENCODER_DROPOUT = 0.5  # hard-coded in the reference (u2gnn_sup.py:157,207)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    gaps = []
    if cfg.num_hidden_layers != 1:
        gaps.append("num_hidden_layers > 1 (ROADMAP.md Queue A, "
                    "'k-layer U2GNNSup with re-gather')")
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
                seed: Optional[int] = None) -> torch.Tensor:
        """Scores [B, C].  Training: ``sampled_inputs`` = (tag_rows [N,128],
        deg [N], self_tag [N], codebook [C,D]) and an int ``seed`` for the
        sampler and all dropout.  Evaluation: neither (deterministic)."""
        cfg = self.cfg
        B = batch.num_graphs
        enc = self.encoders[0]
        S = batch.neigh.shape[1]
        mask = batch.node_mask[:, None]
        if sampled_inputs is not None:
            if seed is None:
                raise ValueError("training needs a seed")
            tag_rows, deg, self_tag, codebook = sampled_inputs
            encoder = training_encoder(S, codebook.shape[1])
            out = encoder(tag_rows, deg, self_tag, codebook, enc.stacked(), S,
                          cfg.num_timesteps, ENCODER_DROPOUT, seed)
            pooled = graph_sum_pool(out * mask, batch.graph_id, B)
            if cfg.dropout > 0.0:
                pooled = pooled * keep_mask(seed, HEAD_STREAM, pooled.shape,
                                            cfg.dropout, pooled.device) \
                    / (1.0 - cfg.dropout)
            return pooled @ self.head_w[0] + self.head_b[0]
        compute = _DTYPES[cfg.compute_dtype]
        x = batch.x.to(compute)
        neigh = x[batch.neigh.to(torch.int64)]  # [N, S, D]
        N, D = neigh.shape[0], neigh.shape[2]
        with torch.no_grad():
            out = u2gnn_encoder(neigh.reshape(N * S, D), enc.stacked(), S,
                                cfg.num_timesteps).to(compute)
        pooled = graph_sum_pool(out.to(torch.float32) * mask, batch.graph_id, B)
        return pooled @ self.head_w[0] + self.head_b[0]
