"""Multilayer (multiplex-graph) siamese/multi U2GNN — port of
``graph_transformer_tpu/models/multilayer.py``.

One U2GNN encoder shared across the S graph views (``siamese``) or one per
view (``multi``); the per-view node embeddings are stacked and mixed by a
cross-view attention, the last slot is kept, optionally projected through a
leaky-ReLU head, and the trainable node-embedding table ``weight`` [N, D]
carries the loss: Σ over views of SupCon(weight·z, adj_view), or the
stacked GAE BCE.

The encoder is picked as ``models/u2gnn_unsup.py`` picks it, with the basic
recurrence (JAX passes none): a single-head neighborhood-axis encoder runs
the whole-encoder kernels (``ops/u2gnn_train.u2gnn_train_encoder``: K4t with
K8s and (T-1)×K8 up to D = 32, K4tw/K8ws/K8w up to 128, K18-K20 past it);
otherwise the per-layer encoder (``ops/attention.neighborhood_encoder``:
K9/K10, or plain attention with K11/K12).  Its dropout rate is 0.5
(``multilayer.py:150,170``).  The cross-view attention is plain torch.

- **Siamese** folds the views into the rows: one encoder call over
  [S·N, K+1, D], each view's neighbor ids shifted by s·N.  On the ``node``
  attention axis the call attends across all S·N folded rows, so the views
  mix (JAX tiles ``node_mask``, ``:154``); mirrored, not fixed.
- **Multi**: one encoder call a view, each with its own encoder.

Random numbers: without a ``seed`` the pass is deterministic (rate 0, no
cross-view dropout), as the JAX model is with ``rng=None``; with one,
encoder call s (0 in siamese) draws from ``ops.random.layer_seed(seed, s)``
and the cross-view attention from ``layer_seed(seed, number of encoders)``.

With ``projection_dim`` > 0 and P ≠ D the loss uses ``weight`` alone and
ignores ``z`` (``:209``), so the encoder gets no gradient; mirrored.
``node_embeddings`` is the ``weight`` table.

Parameters, named as the JAX ``MultilayerParams`` fields
(``weights.params_from_jax``): ``encoders.<i>.<field>``,
``cross_attn.<field>``, ``weight``, ``proj_w``, ``proj_b``.

:func:`build_multiplex_batch` stays on the host with numpy: for a seed its
neighborhoods equal JAX's array for array (the same ``np.random.Generator``
calls in the same order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.models.u2gnn_sup import (
    COMPUTE_DTYPES,
    ENCODER_DROPOUT,
    check_encoder_shapes,
    whole_encoder_ok,
)
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    MHAParams,
    encoder_config,
)
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    multihead_attention,
    neighborhood_encoder,
    xavier_uniform,
)
from graph_transformer_tpu_torch.ops.losses import gae_loss, supcon_loss
from graph_transformer_tpu_torch.ops.random import layer_seed
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder

ML_MODEL_TYPES = ("siamese", "multi")


@dataclasses.dataclass
class MultiplexBatch:
    """A transductive multiplex batch: one node set, S graph views."""

    x: torch.Tensor  # [S, N, D] per-view node features
    neigh: torch.Tensor  # [S, N, K+1] i32 per-view neighborhoods, slot 0 self
    adj: torch.Tensor  # [N, N, S] f32 per-view adjacency (loss mask/target)
    node_mask: torch.Tensor  # [N] f32

    @property
    def num_views(self) -> int:
        return self.neigh.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.x.shape[1]


class MultilayerU2GNN(nn.Module):
    """Siamese/multi U2GNN over multiplex graphs."""

    def __init__(self, feature_dim: int, num_nodes: int, num_views: int,
                 cfg: ModelConfig, seed: int = 0):
        super().__init__()
        if cfg.ml_model_type not in ML_MODEL_TYPES:
            raise ValueError(f"unknown ml_model_type {cfg.ml_model_type!r}")
        if feature_dim % cfg.num_heads:
            raise ValueError(f"{cfg.num_heads} heads do not divide "
                             f"feature_dim {feature_dim}")
        self.cfg = cfg
        self.feature_dim, self.num_nodes = feature_dim, num_nodes
        self.num_views = num_views
        D = feature_dim
        stored = 1 if cfg.share_timestep_weights else cfg.num_timesteps
        n_enc = 1 if self.siamese else num_views
        gen = torch.Generator().manual_seed(int(seed))
        self.encoders = nn.ModuleList(
            EncoderParams(stored, D, cfg.ff_hidden_size, gen)
            for _ in range(n_enc))
        self.cross_attn = MHAParams(D, gen)
        # xavier-normal node embedding (python_multi_layer_siamese_u2gnn.py:45-48)
        std = math.sqrt(2.0 / (num_nodes + D))
        self.weight = nn.Parameter(std * torch.randn((num_nodes, D),
                                                     generator=gen))
        self.proj_w = self.proj_b = None
        if cfg.projection_dim > 0:
            self.proj_w = nn.Parameter(
                xavier_uniform((D, cfg.projection_dim), gen))
            self.proj_b = nn.Parameter(torch.zeros(cfg.projection_dim))

    @property
    def siamese(self) -> bool:
        return self.cfg.ml_model_type == "siamese"

    def _encode_view(self, i: int, feat: torch.Tensor, seed: Optional[int],
                     node_mask: torch.Tensor) -> torch.Tensor:
        """Encoder ``i``'s self vectors [M, D] of neighborhoods ``feat``
        [M, K+1, D]."""
        cfg = self.cfg
        enc_cfg = encoder_config(cfg)
        M, K1, D = feat.shape
        rate = 0.0 if seed is None else ENCODER_DROPOUT
        params = self.encoders[i].stacked()
        if whole_encoder_ok(enc_cfg):
            return u2gnn_train_encoder(feat.reshape(M * K1, D), params, K1,
                                       cfg.num_timesteps, rate, seed)
        return neighborhood_encoder(params, feat, cfg.num_heads, rate, seed,
                                    cfg.attention_axis, cfg.num_timesteps,
                                    node_mask)

    def encode(self, batch: MultiplexBatch,
               seed: Optional[int] = None) -> torch.Tensor:
        """Cross-view node embeddings [N, D] (or [N, P] with the
        projection), float32."""
        cfg = self.cfg
        S, N, K1 = batch.neigh.shape
        compute = COMPUTE_DTYPES[cfg.compute_dtype]
        x = batch.x.to(compute)  # [S, N, D]
        D = x.shape[-1]
        check_encoder_shapes(encoder_config(cfg), K1, D)
        neigh = batch.neigh.to(torch.int64)
        if self.siamese:
            offsets = (torch.arange(S, device=neigh.device) * N)[:, None, None]
            feat = x.reshape(S * N, D)[(neigh + offsets).reshape(S * N, K1)]
            out = self._encode_view(0, feat, seed,
                                    batch.node_mask.repeat(S))
            per_view = out.reshape(S, N, -1)
        else:
            per_view = torch.stack([
                self._encode_view(s, x[s][neigh[s]],
                                  None if seed is None else layer_seed(seed, s),
                                  batch.node_mask)
                for s in range(S)])
        stacked = per_view.transpose(0, 1).to(torch.float32)  # [N, S, D]
        s_mha = (None if seed is None
                 else layer_seed(seed, len(self.encoders)))
        attended = multihead_attention(self.cross_attn.as_dict(), stacked, 1,
                                       0.0 if seed is None else cfg.dropout,
                                       s_mha)
        z = attended[:, -1]  # (python_multi_layer_siamese_u2gnn.py:86-89)
        if self.proj_w is not None:
            z = torch.nn.functional.leaky_relu(z @ self.proj_w + self.proj_b)
        return z

    def loss(self, batch: MultiplexBatch,
             seed: Optional[int] = None) -> torch.Tensor:
        """The training loss over the ``weight`` table, summed over views:
        the cross-view embedding multiplies the table elementwise first,
        where their shapes agree."""
        cfg = self.cfg
        z = self.encode(batch, seed)
        emb = self.weight * z if z.shape == self.weight.shape else self.weight
        if cfg.loss_type == "contrastive":
            total = 0.0
            for s in range(self.num_views):
                total = total + supcon_loss(emb, mask=batch.adj[:, :, s],
                                            valid=batch.node_mask)
            return total
        if cfg.loss_type == "gae":
            n_real = batch.node_mask.sum()
            n_pos = batch.adj.sum() / self.num_views
            norm = (n_real * n_real) / torch.clamp_min(
                2.0 * (n_real * n_real - n_pos), 1.0)
            return gae_loss([emb] * self.num_views, batch.adj, norm)
        raise ValueError("multilayer model supports contrastive|gae, got "
                         f"{cfg.loss_type!r}")

    def node_embeddings(self) -> torch.Tensor:
        """The node-embedding table the trainer evaluates."""
        return self.weight


def neighbor_lists(adj_stack: np.ndarray) -> List[List[np.ndarray]]:
    """Per view, each node's neighbor ids (``np.nonzero`` of its adjacency
    row; empty for an isolated node): what the sampler draws from, built
    once a dataset."""
    N, _, S = adj_stack.shape
    out = []
    for s in range(S):
        a = adj_stack[:, :, s] > 0
        out.append([np.nonzero(a[v])[0] for v in range(N)])
    return out


def sample_multiplex_neighbors(nbrs: List[List[np.ndarray]],
                               num_neighbors: int,
                               rng: np.random.Generator) -> np.ndarray:
    """[S, N, K+1] int32 neighborhoods: self at slot 0, then K draws with
    replacement from each node's neighbors in each view (an isolated node
    takes itself), one ``rng.choice`` a node with neighbors, view by view
    and node by node as the JAX package draws."""
    S, N, K = len(nbrs), len(nbrs[0]), num_neighbors
    neigh = np.zeros((S, N, K + 1), dtype=np.int32)
    for s in range(S):
        neigh[s, :, 0] = np.arange(N)
        for v, nb in enumerate(nbrs[s]):
            if len(nb):
                neigh[s, v, 1:] = rng.choice(nb, size=K, replace=True)
            else:
                neigh[s, v, 1:] = v
    return neigh


def view_major_features(x: np.ndarray, num_views: int) -> np.ndarray:
    """[S, N, D] float32 of shared [N, D] or per-view [N, D, S] features."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        return np.stack([x] * num_views, axis=0)
    return np.ascontiguousarray(np.moveaxis(x, 2, 0))


def build_multiplex_batch(x: np.ndarray, adj_stack: np.ndarray,
                          num_neighbors: int,
                          rng: np.random.Generator) -> MultiplexBatch:
    """Host-side multiplex batch (CPU tensors): per-view fixed-fanout
    sampling with replacement from each view's adjacency, self at slot 0,
    isolated -> self; features ``x`` shared [N, D] or per view [N, D, S]."""
    N, _, S = adj_stack.shape
    neigh = sample_multiplex_neighbors(neighbor_lists(adj_stack),
                                       num_neighbors, rng)
    return MultiplexBatch(
        x=torch.from_numpy(view_major_features(x, S)),
        neigh=torch.from_numpy(neigh),
        adj=torch.from_numpy(np.asarray(adj_stack, np.float32)),
        node_mask=torch.ones(N))


def batch_from_dataset(ds, num_neighbors: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> MultiplexBatch:
    """A transductive batch of a
    :class:`~graph_transformer_tpu_torch.data.multiplex.MultiplexDataset`."""
    rng = rng or np.random.default_rng(0)
    return build_multiplex_batch(ds.x, ds.adj, num_neighbors, rng)
