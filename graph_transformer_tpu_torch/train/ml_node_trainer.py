"""Node-embedding trainer for multiplex graphs — port of
``graph_transformer_tpu/train/ml_node_trainer.py``.

Transductive training of the siamese/multi U2GNN
(``models/multilayer.py``) over a whole multiplex graph: an epoch is one
full-graph step with fresh per-view neighborhoods drawn on the host
(``models/multilayer.sample_multiplex_neighbors``, the JAX package's
``np.random.Generator`` calls from ``cfg.data.seed``), the contrastive or
GAE loss over the node-embedding table, ``ClippedAdam`` and the plateau rule
``PlateauStepLR(1, gamma, window)`` (one step an epoch).  The features and
the dense [N, N, S] adjacency, the loss mask, stay on the device; a step
uploads only its [S, N, K+1] neighborhoods.  Step seeds come from a CPU
``torch.Generator`` (``cfg.train.seed + 1``), as in ``NodeTrainer``.

Evaluation reads the ``weight`` table: a logistic probe on the dataset's
train/test masks (``train/evaluate.py``, LBFGS on the trainer's device) or
k-means clustering metrics (``utils/metrics.py``).  The spectral baselines
are the arithmetic-mean and the Karcher geometric-mean Laplacian
(``utils/laplacian.py``, the latter on the trainer's device), each
clustered spectrally.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from graph_transformer_tpu_torch.config import ExperimentConfig
from graph_transformer_tpu_torch.data.multiplex import MultiplexDataset
from graph_transformer_tpu_torch.models.multilayer import (
    MultilayerU2GNN,
    MultiplexBatch,
    neighbor_lists,
    sample_multiplex_neighbors,
    view_major_features,
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
from graph_transformer_tpu_torch.utils.laplacian import (
    arithmetic_mean_laplacian,
    geometric_mean_laplacian,
)
from graph_transformer_tpu_torch.utils.metrics import (
    eval_from_embeddings,
    spectral_eval_from_laplacian,
)

EVAL_MODES = ("logistic", "kmeans")


class MultiplexNodeTrainer:
    def __init__(self, ds: MultiplexDataset, cfg: ExperimentConfig,
                 device="cuda"):
        self.ds, self.cfg = ds, cfg
        self.device = resolve_device(device)
        self.model = MultilayerU2GNN(ds.feature_dim, ds.num_nodes,
                                     ds.num_views, cfg.model,
                                     seed=cfg.train.seed).to(self.device)
        self.opt = make_optimizer(self.model.parameters(),
                                  cfg.train.learning_rate,
                                  cfg.train.grad_clip_norm)
        self._np_rng = np.random.default_rng(cfg.data.seed)
        self._nbrs = neighbor_lists(ds.adj)
        self._seeds = torch.Generator().manual_seed(cfg.train.seed + 1)
        self.epoch_losses: List[float] = []
        self.lr_scale = 1.0
        self.sched = PlateauStepLR(1, cfg.train.lr_decay_gamma,
                                   cfg.train.plateau_window)
        dev = self.device
        self.x = torch.from_numpy(view_major_features(ds.x, ds.num_views)
                                  ).to(dev)
        self.adj = torch.from_numpy(np.asarray(ds.adj, np.float32)).to(dev)
        self.node_mask = torch.ones(ds.num_nodes, device=dev)
        self.batch_ms: List[float] = []

    def next_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self._seeds))

    def next_batch(self) -> MultiplexBatch:
        """The batch with fresh neighborhoods of every node in every view,
        drawn on the host (its milliseconds kept in ``batch_ms``)."""
        t0 = time.perf_counter()
        neigh = sample_multiplex_neighbors(self._nbrs,
                                           self.cfg.data.num_neighbors,
                                           self._np_rng)
        self.batch_ms.append((time.perf_counter() - t0) * 1e3)
        return MultiplexBatch(self.x, torch.from_numpy(neigh).to(self.device),
                              self.adj, self.node_mask)

    def train_step(self, batch: MultiplexBatch, seed: int) -> torch.Tensor:
        """One step on ``batch`` seeded ``seed``; the loss on the device."""
        loss = self.model.loss(batch, seed)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_epoch(self) -> float:
        """One full-graph step with fresh neighborhoods, then the plateau
        rule."""
        loss = float(self.train_step(self.next_batch(), self.next_seed()))
        self.epoch_losses.append(loss)
        new_scale = self.sched.update(self.epoch_losses)
        if new_scale != self.lr_scale:
            self.lr_scale = new_scale
            set_lr_scale(self.opt, self.lr_scale)
        return loss

    def node_embeddings(self) -> np.ndarray:
        return self.model.node_embeddings().detach().float().cpu().numpy()

    # ------------------------------------------------------------------ eval
    def evaluate_logistic(self) -> float:
        """Logistic probe fit on the train mask, scored on the test mask."""
        return logistic_regression_probe(
            self.node_embeddings(), self.ds.labels,
            np.where(self.ds.train_mask)[0], np.where(self.ds.test_mask)[0],
            device=self.device)

    def evaluate_kmeans(self) -> Dict[str, float]:
        """Clustering metrics of k-means on the embeddings."""
        return eval_from_embeddings(self.node_embeddings(), self.ds.labels,
                                    self.ds.num_classes)

    def spectral_baselines(self) -> Dict[str, Dict[str, float]]:
        """Spectral clustering metrics of the arithmetic-mean and the
        geometric-mean Laplacian (the latter on the trainer's device)."""
        am = arithmetic_mean_laplacian(self.ds.lap)
        gm = geometric_mean_laplacian(self.ds.lap, device=self.device)
        k = self.ds.num_classes
        return {"arithmetic_mean": spectral_eval_from_laplacian(
                    am, self.ds.labels, k),
                "geometric_mean": spectral_eval_from_laplacian(
                    gm, self.ds.labels, k)}


def train_evaluate_multiplex(ds: MultiplexDataset, cfg: ExperimentConfig,
                             eval_mode: str = "logistic", log_fn=print,
                             device="cuda") -> Dict[str, object]:
    """``cfg.train.num_epochs`` steps, evaluating every ``eval_every``; the
    history, the best metric and the trainer."""
    if eval_mode not in EVAL_MODES:
        raise ValueError(f"unknown eval_mode {eval_mode!r} ({EVAL_MODES})")
    trainer = MultiplexNodeTrainer(ds, cfg, device=device)
    history = []
    best = -1.0
    for epoch in range(1, cfg.train.num_epochs + 1):
        t0 = time.time()
        loss = trainer.train_epoch()
        metric = float("nan")
        if epoch % cfg.train.eval_every == 0:
            if eval_mode == "logistic":
                metric = trainer.evaluate_logistic()
            else:
                metric = trainer.evaluate_kmeans()["accuracy"]
            best = max(best, metric)
        dt = time.time() - t0
        history.append({"epoch": epoch, "loss": loss, "metric": metric,
                        "sec": dt})
        log_fn(f"epoch {epoch:03d} | loss {loss:10.4f} | {eval_mode} "
               f"{metric:.4f} | {dt:.2f}s")
    return {"history": history, "best_metric": best, "trainer": trainer}
