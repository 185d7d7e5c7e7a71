"""Supervised U2GNN graph classification — port of ``U2GNNSup``
(``graph_transformer_tpu/models/u2gnn_sup.py``).

Three branches, as in the JAX model:

- **Fused training** (``sampled_inputs`` given; ``u2gnn_sup.py:110-183``),
  one U2GNN layer with codebook features, where the trainer's gate holds
  (``use_fused_sampler``, ``use_pallas`` and ``use_pallas_whole_encoder``,
  as in JAX): the sampled encoder samples the neighborhoods, builds their
  features from the codebook and encodes them; the self vectors are
  sum-pooled per graph, dropped out (``cfg.dropout``) and scored by a linear
  head.  The encoder is picked from the flags and the shape as JAX picks it
  (``:138-175``, ``ops/stored_encoder.training_encoder``): ``use_folded``
  where the folded gate holds, kernels K1-K3; ``use_stored_bwd`` or
  ``use_folded`` otherwise, K5/K6; neither, K13 with the recompute backward
  K8s/K8 (``ops/fused_sampled_encoder.py``).  All three compute in bf16,
  whatever ``compute_dtype`` says, as the JAX kernels do.
- **Two-pass training** (``neigh_feat`` given; ``:184-239``), any number of
  U2GNN layers and any features: the caller samples the neighborhoods and
  gives their features; per U2GNN layer an encoder encodes them, the
  layer's output re-gathered feeds the next layer, and the per-layer heads'
  scores add up.  The trainer's sampler (kernel K7) writes the batch slots
  of the neighbors into ``batch.neigh``, and the re-gather is JAX's
  batch-local ``out[batch.neigh]`` (``:233``); a caller that passes the
  global ids ``neigh_global`` instead re-gathers through
  ``global_regather``, JAX's route for them.  Without a ``seed`` it is
  deterministic (rate 0, no head dropout), as the JAX model is with
  ``rng=None``.
- **Host-sampled training** (neither, with a ``seed``; ``:184-186``), the
  trainer's path with ``on_device_sampling`` off: the batch's own
  neighborhoods ``x[batch.neigh]`` (in ``compute_dtype``) are encoded with
  dropout, as on the two-pass path, and re-gathered batch-locally,
  ``out[batch.neigh]``, between U2GNN layers (``:232-233``).
- **Evaluation** (none of these): the batch's fixed neighborhoods are
  gathered and encoded at rate 0, re-gathered batch-locally between U2GNN
  layers (``:233``).

The encoder of the last three is picked as the JAX ``neighborhood_encoder``
picks it (``ops/attention.py:393-433``), in ``compute_dtype``: basic,
single-head, neighborhood-axis encoders take the whole-encoder kernels (K4t
forward with the recompute backward K8/K8s, ``ops/u2gnn_train.py``, in
training, K4tw and K8w/K8ws past D = 32; K4, or the wide K4 past D = 32, at
evaluation; K18-K20 past D = 128 in both); every other configuration —
the Universal-Transformer recurrences (``rec.<i>`` parameters per U2GNN
layer), ``num_heads > 1`` and the reference's node-axis attention — takes the per-layer encoder
(``ops/attention.neighborhood_encoder``: K9/K10, K9w/K10w past D = 32, or
plain attention and K11/K12), in training and at evaluation alike.  With
``return_ponder`` the model also returns the summed ACT ponder cost of its
U2GNN layers (0 for the other recurrences), which the trainer adds to the
loss.

The encoder dropout is 0.5 whatever ``cfg.dropout`` says, as in the
reference.  Within a training step, U2GNN layer i draws its encoder and head
dropout from ``ops.random.layer_seed(seed, i)``; layer 0 keeps the step's
seed, so that one layer on the two-pass path draws what the fused path
draws.

Models other than ``u2gnn_sup`` raise ``NotImplementedError`` naming the
ROADMAP item that will port them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    neighborhood_encoder,
    xavier_uniform,
)
from graph_transformer_tpu_torch.ops.encoder_layer import check_layer_shapes
from graph_transformer_tpu_torch.ops.random import (
    HEAD_STREAM,
    keep_mask,
    layer_seed,
)
from graph_transformer_tpu_torch.ops.sparse import (
    global_regather,
    graph_sum_pool,
)
from graph_transformer_tpu_torch.ops.rows_encoder import check_rows_shapes
from graph_transformer_tpu_torch.ops.stored_encoder import training_encoder
from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.ops.ut_recurrence import (
    init_recurrence_params,
)

ENCODER_DROPOUT = 0.5  # hard-coded in the reference (u2gnn_sup.py:157,207)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    if cfg.model != "u2gnn_sup":
        raise NotImplementedError(
            f"not ported yet: model {cfg.model!r} (ROADMAP.md Queue A)")


def whole_encoder_ok(cfg: ModelConfig) -> bool:
    """Whether the whole-encoder kernels run ``cfg``'s encoder: a basic,
    single-head, neighborhood-axis one (``ops/attention.py:393-399`` of the
    JAX package); the rest takes the per-layer encoder."""
    return (cfg.recurrence == "basic" and cfg.num_heads == 1
            and cfg.attention_axis == "neighborhood")


def check_encoder_shapes(cfg: ModelConfig, S: int, D: int) -> None:
    """Raise, naming ROADMAP item 6, for neighborhoods of S slots that the
    kernels of ``cfg``'s training encoder do not take: K4t/K8, K4tw/K8w and
    past D = 128 K18-K20 (whole encoder), K9/K10, K9w/K10w and K18-K20
    (single-head layers without a mask) take S <= 32 at any D; the plain
    attention with K11/K12, or K18 and K20 past D = 128 (node axis, several
    heads), any S and D."""
    if whole_encoder_ok(cfg):
        check_rows_shapes(S)
    elif cfg.num_heads == 1 and cfg.attention_axis == "neighborhood":
        check_layer_shapes(S, D)


class U2GNNSup(nn.Module):
    """Parameters: ``encoders`` (one :class:`EncoderParams` per U2GNN layer),
    ``head_w`` [k, D, C], ``head_b`` [k, C] and, for a recurrence with
    parameters, ``rec`` (one module per U2GNN layer), named as the JAX
    ``U2GNNSupParams`` fields (see ``weights.params_from_jax``)."""

    def __init__(self, feature_dim: int, num_classes: int, cfg: ModelConfig,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        if feature_dim % cfg.num_heads:
            raise ValueError(f"{cfg.num_heads} heads do not divide "
                             f"feature_dim {feature_dim}")
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
        rec = [init_recurrence_params(cfg.recurrence, D, gen)
               for _ in range(k)]
        self.rec = nn.ModuleList(r for r in rec if r is not None)

    def forward(self, batch: GraphBatch, sampled_inputs: Optional[tuple] = None,
                seed: Optional[int] = None,
                neigh_feat: Optional[torch.Tensor] = None,
                neigh_global: Optional[torch.Tensor] = None,
                num_total_nodes: Optional[int] = None,
                return_ponder: bool = False):
        """Scores [B, C], or ``(scores, ponder)`` with ``return_ponder``.
        Fused training: ``sampled_inputs`` = (tag_rows [N,128], deg [N],
        self_tag [N], codebook [C,D]) and an int ``seed`` for the sampler and
        all dropout.  Two-pass training: ``neigh_feat`` [N, K+1, D], the
        features of the neighborhoods whose batch rows ``batch.neigh``
        holds, or of the global ids ``neigh_global`` [N, K+1] (then with
        ``num_total_nodes``), and a ``seed``, or none for a deterministic
        pass.  Host-sampled training: only a ``seed`` (the
        batch's own neighborhoods).  Evaluation: none of these."""
        if sampled_inputs is not None:
            out = self._fused(batch, sampled_inputs, seed)
        elif neigh_feat is not None and neigh_global is None:
            neigh = batch.neigh.to(torch.int64)
            out = self._two_pass(batch, neigh_feat, lambda o: o[neigh], seed)
        elif neigh_feat is not None:
            if len(self.encoders) > 1 and num_total_nodes is None:
                raise ValueError("re-gathering by global id needs "
                                 "num_total_nodes")
            out = self._two_pass(batch, neigh_feat, lambda o: global_regather(
                o, batch.node_gidx, batch.node_mask, neigh_global,
                num_total_nodes), seed)
        elif seed is not None:
            neigh = batch.neigh.to(torch.int64)
            x = batch.x.to(COMPUTE_DTYPES[self.cfg.compute_dtype])
            out = self._two_pass(batch, x[neigh], lambda o: o[neigh], seed)
        else:
            out = self._eval(batch)
        return out if return_ponder else out[0]

    def _per_layer(self, i: int, x: torch.Tensor, batch: GraphBatch,
                   seed: Optional[int]):
        """U2GNN layer i's per-layer encoder over x [N, K+1, D]: (self
        vectors [N, D], ponder)."""
        cfg = self.cfg
        return neighborhood_encoder(
            self.encoders[i].stacked(), x, cfg.num_heads,
            0.0 if seed is None else ENCODER_DROPOUT, seed,
            cfg.attention_axis, cfg.num_timesteps, batch.node_mask,
            cfg.recurrence, self.rec[i] if len(self.rec) else None,
            return_ponder=True)

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
        encoder = training_encoder(S, codebook.shape[1], self.cfg)
        out = encoder(tag_rows, deg, self_tag, codebook,
                      self.encoders[0].stacked(), S, self.cfg.num_timesteps,
                      ENCODER_DROPOUT, seed)
        return self._head(0, out, batch, seed), out.new_zeros(())

    def _two_pass(self, batch, neigh_feat, regather, seed):
        """Training (or, without a seed, the deterministic pass) over the
        neighborhoods ``neigh_feat`` [N, K+1, D]; ``regather(out)`` gives
        the next U2GNN layer's."""
        cfg = self.cfg
        N, S, D = neigh_feat.shape
        check_encoder_shapes(cfg, S, D)
        whole = whole_encoder_ok(cfg)
        k = len(self.encoders)
        compute = COMPUTE_DTYPES[cfg.compute_dtype]
        rate = 0.0 if seed is None else ENCODER_DROPOUT
        x = neigh_feat.to(compute)
        scores, ponder = 0.0, x.new_zeros((), dtype=torch.float32)
        for i, enc in enumerate(self.encoders):
            s_i = None if seed is None else layer_seed(seed, i)
            if whole:
                out = u2gnn_train_encoder(x.reshape(N * S, D), enc.stacked(),
                                          S, cfg.num_timesteps, rate,
                                          s_i).to(compute)
            else:  # its output's dtype, as the JAX model keeps it
                out, p_i = self._per_layer(i, x, batch, s_i)
                ponder = ponder + p_i
            if i + 1 < k:
                x = regather(out)
            scores = scores + self._head(i, out, batch, s_i)
        return scores, ponder

    def _eval(self, batch):
        compute = COMPUTE_DTYPES[self.cfg.compute_dtype]
        whole = whole_encoder_ok(self.cfg)
        neigh = batch.neigh.to(torch.int64)
        N, S = neigh.shape
        x = batch.x.to(compute)
        scores = 0.0
        ponder = x.new_zeros((), dtype=torch.float32)
        for i, enc in enumerate(self.encoders):
            with torch.no_grad():
                if whole:
                    out = u2gnn_encoder(x[neigh].reshape(N * S, -1),
                                        enc.stacked(), S,
                                        self.cfg.num_timesteps).to(compute)
                else:
                    out, p_i = self._per_layer(i, x[neigh], batch, None)
                    ponder = ponder + p_i
            x = out
            scores = scores + self._head(i, out, batch, None)
        return scores, ponder
