"""Single-graph node-classification trainer — port of ``NodeTrainer`` and
``train_evaluate_node`` (``graph_transformer_tpu/train/node_trainer.py``).

Transductive training of U2GNN (the fork's cross-attention head,
``U2GNNUnsup(..., head="cross_attention")``, vocabulary = the node count)
over one whole graph: one padded batch of every node
(``data/batching.whole_dataset_batch``), whose neighborhoods are resampled
on the device every step (``sampling/neighbors.resample_batch_neighbors``),
with the sampled-softmax (``sampler_type`` ``default`` or ``neighbor``),
GAE or contrastive loss (the last two over the dense padded adjacency).
An epoch is one step, as in the reference, so the plateau rule decays the
learning rate on every plateau epoch (``PlateauStepLR(1, ...)``).
Evaluation probes the learned embedding table: a logistic regression on the
dataset's train/test masks, a 2-fold logistic regression over all nodes
(folds of ``data/splits``, sklearn's), or k-means clustering metrics
(``utils/metrics``).

The encoder's width is the feature count (Cora 1,433), so it runs the
whole-encoder route past D = 128: kernels K18-K20 (``ops/rows_encoder.py``).
A step at T = 1 (one slot-0 layer) launches K18 18 times (forward 5, q on
slot 0's rows apart from k and v; the recompute 5; backward 3 row products
and 5 weight products; the input's cotangent is not needed), K19 3 times
and K20 5 times.

The baselines ``gcn`` and ``gat`` (``models/gcn.py``, ``models/gat.py``,
JAX ``node_trainer.py:44-63``) train on the same whole-graph batch over its
edge list, grouped by segment once (``model.prepare``), and resample no
neighborhoods; their embedding under the default loss is the sampled
softmax's table ``ss.weight`` [V, 2], else the encoder's mu.

Random numbers as in ``UnsupTrainer``: one 31-bit seed a step from a CPU
``torch.Generator`` (``cfg.train.seed + 1``); the neighbor draws, the
dropout sites, the candidates and the neighbor negatives take disjoint
streams of it.  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from graph_transformer_tpu_torch.config import ExperimentConfig
from graph_transformer_tpu_torch.data.batching import whole_dataset_batch
from graph_transformer_tpu_torch.data.citation import NodeGraphDataset
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.models.gat import GATModel
from graph_transformer_tpu_torch.models.gcn import GCNModel
from graph_transformer_tpu_torch.models.u2gnn_sup import check_encoder_shapes
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    U2GNNUnsup,
    encoder_config,
)
from graph_transformer_tpu_torch.sampling.neighbors import (
    DeviceCSR,
    resample_batch_neighbors,
)
from graph_transformer_tpu_torch.train.evaluate import (
    logistic_regression_probe,
)
from graph_transformer_tpu_torch.train.optim import (
    PlateauStepLR,
    make_optimizer,
    set_lr_scale,
)
from graph_transformer_tpu_torch.train.sup_trainer import resolve_device
from graph_transformer_tpu_torch.utils.metrics import eval_from_embeddings

U2GNN_NAMES = ("u2gnn", "u2gnn_unsup", "u2gnn_sup")
EVAL_MODES = ("masks", "2fold", "kmeans")


def make_node_model(ds: NodeGraphDataset, cfg: ExperimentConfig):
    """The node model of ``cfg.model.model``: U2GNN with the fork's
    cross-layer-attention head, or the GCN / GAT baseline (JAX
    ``node_trainer.py:44-63``)."""
    name = cfg.model.model
    if name in U2GNN_NAMES:
        return U2GNNUnsup(ds.feature_dim, ds.num_nodes, cfg.model,
                          head="cross_attention", seed=cfg.train.seed)
    if name == "gcn":
        return GCNModel(ds.feature_dim, ds.num_nodes, cfg.model,
                        seed=cfg.train.seed)
    if name == "gat":
        return GATModel(ds.feature_dim, ds.num_nodes, cfg.model,
                        seed=cfg.train.seed)
    raise ValueError(f"unknown node model {name!r} (u2gnn | gcn | gat)")


class NodeTrainer:
    def __init__(self, ds: NodeGraphDataset, cfg: ExperimentConfig,
                 device="cuda"):
        self.ds, self.cfg = ds, cfg
        self.device = resolve_device(device)
        g = ds.graph
        self.model = make_node_model(ds, cfg).to(self.device)
        self.u2gnn = cfg.model.model in U2GNN_NAMES
        if self.u2gnn:
            check_encoder_shapes(encoder_config(cfg.model),
                                 cfg.data.num_neighbors + 1, ds.feature_dim)
        self.spec = self.model.spec()
        self.opt = make_optimizer(self.model.parameters(),
                                  cfg.train.learning_rate,
                                  cfg.train.grad_clip_norm)
        self.csr = DeviceCSR.from_dataset(g, self.device)
        self._seeds = torch.Generator().manual_seed(cfg.train.seed + 1)
        self.epoch_losses: List[float] = []
        self.lr_scale = 1.0
        self.sched = PlateauStepLR(1, cfg.train.lr_decay_gamma,
                                   cfg.train.plateau_window)
        self.batch = whole_dataset_batch(
            g, cfg.data.num_neighbors, pad_multiple=cfg.data.pad_multiple,
            seed=cfg.data.seed).to(self.device)
        self.adj_mask = None
        if cfg.model.loss_type in ("gae", "contrastive"):
            self.adj_mask = torch.from_numpy(
                ds.dense_adj(self.batch.n_pad)).to(self.device)
        self.graph = None if self.u2gnn else self.model.prepare(self.batch)

    def next_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self._seeds))

    def loss(self, seed: int) -> torch.Tensor:
        """The loss of the step seeded ``seed``: fresh neighborhoods of
        every node, then the model's loss (the baselines' on the batch's
        edges)."""
        b = self.batch
        if not self.u2gnn:
            return self.model.loss(b, self.spec, seed,
                                   adj_mask=self.adj_mask, graph=self.graph)
        neigh = resample_batch_neighbors(
            seed, self.csr, b.node_gidx, b.node_mask,
            self.cfg.data.num_neighbors, self.ds.num_nodes)
        csr = self.csr if self.cfg.model.sampler_type == "neighbor" else None
        return self.model.loss(dataclasses.replace(b, neigh=neigh), self.spec,
                               seed, csr=csr, adj_mask=self.adj_mask)

    def train_step(self, seed: int) -> torch.Tensor:
        """One step seeded ``seed``; the loss on the device."""
        loss = self.loss(seed)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_epoch(self) -> float:
        """One whole-graph step with fresh neighborhoods, then the plateau
        rule."""
        loss = float(self.train_step(self.next_seed()))
        self.epoch_losses.append(loss)
        new_scale = self.sched.update(self.epoch_losses)
        if new_scale != self.lr_scale:
            self.lr_scale = new_scale
            set_lr_scale(self.opt, self.lr_scale)
        return loss

    # ---------------------------------------------------------------- embed
    def node_embeddings(self) -> np.ndarray:
        """[N, D] evaluation embeddings on the host: the learned table (the
        fork head's ``weight``, else the sampled softmax's output rows) for
        the sampled-softmax loss and wherever the model has ``weight``; the
        deterministic encoder output (the baselines' mu) otherwise."""
        n = self.ds.num_nodes
        with torch.no_grad():
            if (self.cfg.model.loss_type == "default"
                    or self.model.weight is not None):
                emb = self.model.node_embeddings()
            elif self.u2gnn:
                emb = self.model.encode(self.batch, None)
            else:  # the baselines' mu
                emb = self.model.encode(self.batch, None, self.graph)[0]
        return emb.detach().float().cpu().numpy()[:n]

    # ----------------------------------------------------------------- eval
    def evaluate_masks(self) -> float:
        """Logistic probe fit on the train mask, scored on the test mask."""
        emb = self.node_embeddings()
        return logistic_regression_probe(
            emb, self.ds.node_labels, np.where(self.ds.train_mask)[0],
            np.where(self.ds.test_mask)[0], device=self.device)

    def evaluate_2fold(self, seed: int = 0) -> float:
        """Mean accuracy of a 2-fold logistic probe over all nodes."""
        emb = self.node_embeddings()
        y = self.ds.node_labels
        return float(np.mean([
            logistic_regression_probe(emb, y, tr, te, device=self.device)
            for tr, te in stratified_kfold_indices(y, 2, seed)]))

    def evaluate_kmeans(self) -> Dict[str, float]:
        """Clustering metrics of k-means on the embeddings."""
        return eval_from_embeddings(self.node_embeddings(),
                                    self.ds.node_labels, self.ds.num_classes)

    def evaluate(self, eval_mode: str) -> float:
        if eval_mode == "masks":
            return self.evaluate_masks()
        if eval_mode == "2fold":
            return self.evaluate_2fold()
        if eval_mode == "kmeans":
            return self.evaluate_kmeans()["accuracy"]
        raise ValueError(f"unknown eval_mode {eval_mode!r} ({EVAL_MODES})")


def train_evaluate_node(ds: NodeGraphDataset, cfg: ExperimentConfig,
                        eval_mode: str = "masks", log_fn=print,
                        device="cuda") -> Dict[str, object]:
    """``cfg.train.num_epochs`` steps, evaluating every ``eval_every``;
    the history, the best metric and the trainer."""
    if eval_mode not in EVAL_MODES:
        raise ValueError(f"unknown eval_mode {eval_mode!r} ({EVAL_MODES})")
    trainer = NodeTrainer(ds, cfg, device=device)
    history = []
    best = -1.0
    for epoch in range(1, cfg.train.num_epochs + 1):
        t0 = time.time()
        loss = trainer.train_epoch()
        metric = float("nan")
        if epoch % cfg.train.eval_every == 0:
            metric = trainer.evaluate(eval_mode)
            best = max(best, metric)
        dt = time.time() - t0
        history.append({"epoch": epoch, "loss": loss, "metric": metric,
                        "sec": dt})
        log_fn(f"epoch {epoch:03d} | loss {loss:12.4f} | {eval_mode} "
               f"{metric:.4f} | {dt:.2f}s")
    return {"history": history, "best_metric": best, "trainer": trainer}
