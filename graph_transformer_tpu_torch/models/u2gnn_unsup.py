"""Unsupervised U2GNN: node embeddings by sampled softmax — port of
``U2GNNUnsup`` (``graph_transformer_tpu/models/u2gnn_unsup.py``).

k U2GNN layers, per-layer self vectors in float32 concatenated into
``[N, k·D]`` (the TF implementation's clean path), scored by a log-uniform
sampled softmax over the node vocabulary with each node's own global id as
its label; the output table ``ss.weight`` [V, k·D] is the embedding that
evaluation pools.  The fork's options are JAX's too: ``head=
'cross_attention'`` (the k layer outputs through one multi-head attention,
the last slot times a learned ``weight`` [V, D] row), ``loss_type``
``'default'`` (``sampler_type`` ``'default'`` or ``'neighbor'``),
``'contrastive'`` and ``'gae'``, and ``regather=False`` (the next layer
takes the full sequence output).

Parameters, named as the JAX ``U2GNNUnsupParams`` fields
(``weights.params_from_jax``): ``encoders`` (one :class:`EncoderParams` a
layer, ``1`` stored timestep with ``share_timestep_weights`` else
``num_timesteps``, unlike ``U2GNNSup``), ``ss.weight``, ``ss.bias`` and, for
the fork's head, ``cross_attn`` and ``weight``.

The encoder, as JAX's ``encode`` runs it (``u2gnn_unsup.py:137-257``):

- **Fused** (``sampled_inputs`` given; the trainer's gate): one layer, the
  concat head; ``ops/stored_encoder.training_encoder`` samples and encodes
  (K1-K3, K5/K6 or K13/K13w with K8s/K8 or K8ws/K8w) and its slot-0 output
  is z.
- **Two-pass** (``neigh_feat`` given, the features of K7's neighborhoods;
  or neither, the batch's own ``x[batch.neigh]``): each layer's encoder,
  its output re-gathered by slot (``out[batch.neigh]``) for the next.  JAX
  passes the encoder no ``recurrence`` (``:204-214``), so every recurrence
  trains the basic encoder: the whole-encoder kernels (K4t/K8s/K8, K4tw/
  K8ws/K8w past D = 32) for one head on the neighborhood axis, else the
  per-layer encoder (K9/K10, or plain attention with K11/K12).
  ``regather=False`` runs the per-layer encoder over the full sequence.

Without a ``seed`` the pass is deterministic (rate 0, no head dropout), as
the JAX model is with ``rng=None``.  With one, U2GNN layer i draws its
dropout from ``ops.random.layer_seed(seed, i)``, the cross-layer attention
from ``layer_seed(seed, k)``, the head dropout of z (``cfg.dropout``) from
stream ``HEAD_STREAM`` of the seed, and the candidates from the seed
(``ops/sampled_softmax.draw_candidates``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import GraphBatch
from graph_transformer_tpu_torch.models.u2gnn_sup import (
    COMPUTE_DTYPES,
    ENCODER_DROPOUT,
    check_encoder_shapes,
    whole_encoder_ok,
)
from graph_transformer_tpu_torch.ops import sampled_neighbor, sampled_softmax
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    multihead_attention,
    neighborhood_encoder,
    transformer_encoder,
    xavier_uniform,
)
from graph_transformer_tpu_torch.ops.losses import gae_loss, supcon_loss
from graph_transformer_tpu_torch.ops.random import (
    HEAD_STREAM,
    keep_mask,
    layer_seed,
)
from graph_transformer_tpu_torch.ops.stored_encoder import training_encoder
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec

HEADS = ("concat", "cross_attention")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The configuration the encoder runs: ``cfg`` with the basic
    recurrence, as JAX's ``encode`` passes none."""
    return dataclasses.replace(cfg, recurrence="basic")


class SampledSoftmaxParams(nn.Module):
    """``weight`` [V, D] and ``bias`` [V] of the sampled softmax."""

    def __init__(self, vocab_size: int, nhid: int, gen: torch.Generator):
        super().__init__()
        w, b = sampled_softmax.init_sampled_softmax_params(vocab_size, nhid,
                                                           gen)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)


class MHAParams(nn.Module):
    """The fork's cross-layer attention: ``w_in`` [D, 3D], ``b_in``,
    ``w_out`` [D, D], ``b_out``."""

    def __init__(self, d: int, gen: torch.Generator):
        super().__init__()
        self.w_in = nn.Parameter(xavier_uniform((d, 3 * d), gen))
        self.b_in = nn.Parameter(torch.zeros(3 * d))
        self.w_out = nn.Parameter(xavier_uniform((d, d), gen))
        self.b_out = nn.Parameter(torch.zeros(d))

    def as_dict(self) -> dict:
        return dict(w_in=self.w_in, b_in=self.b_in, w_out=self.w_out,
                    b_out=self.b_out)


class U2GNNUnsup(nn.Module):
    def __init__(self, feature_dim: int, vocab_size: int, cfg: ModelConfig,
                 head: str = "concat", seed: int = 0):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}")
        if feature_dim % cfg.num_heads:
            raise ValueError(f"{cfg.num_heads} heads do not divide "
                             f"feature_dim {feature_dim}")
        self.cfg, self.head = cfg, head
        self.feature_dim, self.vocab_size = feature_dim, vocab_size
        D = feature_dim
        stored = 1 if cfg.share_timestep_weights else cfg.num_timesteps
        gen = torch.Generator().manual_seed(int(seed))
        self.encoders = nn.ModuleList(
            EncoderParams(stored, D, cfg.ff_hidden_size, gen)
            for _ in range(cfg.num_hidden_layers))
        self.ss = SampledSoftmaxParams(vocab_size, self.embedding_dim, gen)
        self.cross_attn = self.weight = None
        if head == "cross_attention":
            self.cross_attn = MHAParams(D, gen)
            stdv = math.sqrt(6.0 / (vocab_size + D))
            self.weight = nn.Parameter(
                (torch.rand((vocab_size, D), generator=gen) * 2.0 - 1.0) * stdv)

    @property
    def embedding_dim(self) -> int:
        if self.head == "concat":
            return self.feature_dim * self.cfg.num_hidden_layers
        return self.feature_dim

    def spec(self) -> LogUniformSpec:
        return LogUniformSpec.create(self.vocab_size, self.cfg.sampled_num)

    # ------------------------------------------------------------ encoder
    def encode(self, batch: GraphBatch, seed: Optional[int] = None,
               regather: bool = True,
               neigh_feat: Optional[torch.Tensor] = None,
               sampled_inputs: Optional[tuple] = None) -> torch.Tensor:
        """Per-node representation: [N, k·D] (concat) or [N, D], float32.
        ``sampled_inputs`` = (tag_rows, deg, self_tag, codebook): the fused
        path (needs a ``seed``).  ``neigh_feat`` [N, K+1, D]: the features of
        the neighborhoods whose batch rows ``batch.neigh`` holds (K7's);
        without it, the batch's own neighborhoods."""
        cfg = self.cfg
        if sampled_inputs is not None:
            return self._fused(batch, sampled_inputs, seed)
        compute = COMPUTE_DTYPES[cfg.compute_dtype]
        neigh = batch.neigh.to(torch.int64)
        x = (batch.x.to(compute)[neigh] if neigh_feat is None
             else neigh_feat.to(compute))
        enc_cfg = encoder_config(cfg)
        N, S, D = x.shape
        if regather:
            check_encoder_shapes(enc_cfg, S, D)
        whole = regather and whole_encoder_ok(enc_cfg)
        rate = 0.0 if seed is None else ENCODER_DROPOUT
        outs = []
        for i, enc in enumerate(self.encoders):
            s_i = None if seed is None else layer_seed(seed, i)
            if regather:
                if whole:
                    out = u2gnn_train_encoder(
                        x.reshape(N * S, D), enc.stacked(), S,
                        cfg.num_timesteps, rate, s_i).to(compute)
                else:
                    out = neighborhood_encoder(
                        enc.stacked(), x, cfg.num_heads, rate, s_i,
                        cfg.attention_axis, cfg.num_timesteps,
                        batch.node_mask)
                if i + 1 < len(self.encoders):
                    x = out[neigh]
            else:  # the fork: the next layer takes the full sequence output
                x = transformer_encoder(enc.stacked(), x, cfg.num_heads, rate,
                                        s_i, cfg.num_timesteps)
                out = x[:, 0]
            outs.append(out.to(torch.float32))
        if self.head == "concat":
            return torch.cat(outs, dim=-1)
        stacked = torch.stack(outs, dim=1)  # [N, k, D]
        s_mha = None if seed is None else layer_seed(seed, len(self.encoders))
        attended = multihead_attention(self.cross_attn.as_dict(), stacked, 1,
                                       0.0 if seed is None else cfg.dropout,
                                       s_mha)
        z = attended[:, -1]  # the last slot (pytorch_U2GNN_UnSup.py:72-73)
        return self.weight[batch.node_gidx.to(torch.int64)] * z

    def _fused(self, batch, sampled_inputs, seed):
        if seed is None:
            raise ValueError("the fused path trains with a seed")
        if len(self.encoders) != 1 or self.head != "concat":
            raise ValueError("the fused sampled encoders train one U2GNN "
                             "layer with the concat head")
        tag_rows, deg, self_tag, codebook = sampled_inputs
        S = batch.neigh.shape[1]
        encoder = training_encoder(S, codebook.shape[1], self.cfg)
        out = encoder(tag_rows, deg, self_tag, codebook,
                      self.encoders[0].stacked(), S, self.cfg.num_timesteps,
                      ENCODER_DROPOUT, seed)
        return out.to(torch.float32)

    # --------------------------------------------------------------- loss
    def loss(self, batch: GraphBatch, spec: LogUniformSpec,
             seed: Optional[int] = None, candidates: Optional[tuple] = None,
             negatives: Optional[torch.Tensor] = None, csr=None,
             adj_mask: Optional[torch.Tensor] = None,
             neigh_feat: Optional[torch.Tensor] = None,
             sampled_inputs: Optional[tuple] = None,
             vocab_perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The scalar training loss, the sum of the per-node losses
        (``train_pytorch_U2GNN_UnSup.py:155-156``).  The log-uniform
        candidates are ``candidates`` = (ids, valid or None), or drawn from
        ``seed``; the neighbor sampler's positions ``negatives`` [N, S], or
        drawn from ``seed``.  ``vocab_perm``: the id-symmetric protocol,
        node v trains output row ``vocab_perm[v]``."""
        cfg = self.cfg
        z = self.encode(batch, seed, neigh_feat=neigh_feat,
                        sampled_inputs=sampled_inputs)
        gidx = batch.node_gidx.to(torch.int64)
        if cfg.loss_type == "default":
            drawn = negatives if cfg.sampler_type == "neighbor" else candidates
            if seed is None and drawn is None:
                raise ValueError("the sampler's draws need a seed")
            if seed is not None and cfg.dropout > 0.0:
                z = z * keep_mask(seed, HEAD_STREAM, z.shape, cfg.dropout,
                                  z.device) / (1.0 - cfg.dropout)
            if cfg.sampler_type == "neighbor":
                if csr is None:
                    raise ValueError("sampler_type='neighbor' needs csr")
                if negatives is None:
                    negatives = sampled_neighbor.draw_neighbor_negatives(
                        seed, csr, gidx, cfg.sampled_num)
                return sampled_neighbor.loss_given(
                    self.ss.weight, z, gidx, csr, negatives,
                    batch.node_mask).sum()
            labels = gidx if vocab_perm is None else vocab_perm[gidx]
            if candidates is None:
                candidates = sampled_softmax.draw_candidates(seed, spec,
                                                             z.device)
            return sampled_softmax.loss_given(
                self.ss.weight, self.ss.bias, z, labels, *candidates, spec,
                cfg.sampled_softmax_mode, batch.node_mask).sum()
        if cfg.loss_type == "contrastive":
            if adj_mask is None:
                raise ValueError("contrastive loss needs adj_mask")
            if self.weight is not None:
                # the fork trains the vocabulary-sized table
                # (pytorch_U2GNN_UnSup.py:86-88); every row is a real node
                V = self.weight.shape[0]
                return supcon_loss(self.weight, mask=adj_mask[:V, :V],
                                   valid=z.new_ones(V))
            return supcon_loss(z, mask=adj_mask, valid=batch.node_mask)
        if cfg.loss_type == "gae":
            if adj_mask is None:
                raise ValueError("gae loss needs adj_mask (target adjacency)")
            emb = z
            if self.weight is not None:
                emb = self.weight
                V = emb.shape[0]
                adj_mask = adj_mask[:V, :V]
                n_real = emb.new_full((), float(V))
            else:
                n_real = batch.node_mask.sum()
            n_pos = adj_mask.sum()
            norm = (n_real * n_real) / torch.clamp_min(
                2.0 * (n_real * n_real - n_pos), 1.0)
            return gae_loss([emb], adj_mask[:, :, None], norm)
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")

    def node_embeddings(self, vocab_perm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """The evaluation table: ``ss.weight`` (rows in node order under
        ``vocab_perm``), or the fork head's ``weight``."""
        if self.weight is not None:
            return self.weight
        if vocab_perm is not None:
            return self.ss.weight[vocab_perm]
        return self.ss.weight
