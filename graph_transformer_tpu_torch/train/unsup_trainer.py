"""Unsupervised (node-embedding) trainer — port of ``UnsupTrainer`` and
``train_evaluate_unsup`` (``graph_transformer_tpu/train/unsup_trainer.py``).

Transductive training over all graphs (``README.md:53`` of the reference):
each step a random subset of ``batch_size`` graphs, whose nodes are
sampled-softmax examples labelled with their own global ids; the objective
is the summed per-node loss; evaluation sum-pools the learned output table
to graph level and fits 10-fold logistic regression
(``train/evaluate.py``).

Paths, as the JAX trainer picks them (``unsup_trainer.py:80-101``):

- **fused**, where the supervised gate holds (``train/sup_trainer.
  fused_gate_ok``), ``loss_type == "default"`` and ``sampler_type !=
  "neighbor"``, over codebook features: the sampled encoder samples and
  encodes in one kernel (K13/K13w with K8s/K8 or K8ws/K8w by default);
- **two-pass** otherwise: K7 draws the batch's neighborhoods, their feature
  rows and batch slots from the dataset's tables (one launch a step), and
  the model encodes them (K4t/K8s/K8, or K4tw/K8ws/K8w past D = 32, for one
  head on the neighborhood axis).  JAX takes its fast sampler on the TPU
  only (``:82``) and the CSR sampler elsewhere; the port takes K7 on every
  device, as its ``SupTrainer`` and the CV runners do;
- with ``on_device_sampling`` off (``--host_sampling``) no table is built
  and the batch's own neighborhoods are encoded;
- ``model == "gcn_unsup"``: the GCN baseline (``models/gcn_unsup_graphs``)
  on the batch's edges, with neither the fused path nor a neighbor table,
  as in JAX (``:58-63``, ``:79-81``); no kernel.

The dataset's tables come from ``train/sup_trainer.device_tables`` (one
build); the CSR is built only for ``sampler_type == "neighbor"``.  The
id-symmetric protocol's permutation is ``np.random.default_rng(seed +
7).permutation(V)`` (``:122-129``).  The plateau rule is ``PlateauStepLR``,
and :meth:`UnsupTrainer.train_epoch_stacked` trains the same eager loop as
:meth:`UnsupTrainer.train_epoch` (PyTorch has no one-dispatch epoch).

Random numbers as in ``SupTrainer``: one 31-bit seed a step from a CPU
``torch.Generator`` (``cfg.train.seed + 1``); the sampler, the dropout
sites, the candidates and the neighbor negatives take disjoint streams of
it, so no device generator and no host-device sync are needed a step.
The Adam update is dense over the [V, k·D] output table, as optax's is.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from graph_transformer_tpu_torch.config import ExperimentConfig
from graph_transformer_tpu_torch.data.batching import BatchBuilder, GraphBatch
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.models.gcn_unsup_graphs import GCNGraphUnsup
from graph_transformer_tpu_torch.models.u2gnn_sup import check_encoder_shapes
from graph_transformer_tpu_torch.models.u2gnn_unsup import (
    U2GNNUnsup,
    encoder_config,
)
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    sample_neighborhoods,
)
from graph_transformer_tpu_torch.sampling.neighbors import DeviceCSR
from graph_transformer_tpu_torch.train.evaluate import (
    pool_node_embeddings,
    tenfold_logistic_accuracy,
)
from graph_transformer_tpu_torch.train.optim import (
    PlateauStepLR,
    make_optimizer,
    set_lr_scale,
)
from graph_transformer_tpu_torch.train.sup_trainer import (
    device_tables,
    fused_gate_ok,
    resolve_device,
)


def unsup_fused_ok(cfg: ExperimentConfig) -> bool:
    """The configuration part of the unsupervised fused path's gate
    (``unsup_trainer.py:99-101``)."""
    m = cfg.model
    return (fused_gate_ok(m) and m.loss_type == "default"
            and m.sampler_type != "neighbor")


class UnsupTrainer:
    def __init__(self, ds: GraphDataset, cfg: ExperimentConfig,
                 device="cuda"):
        self.ds, self.cfg = ds, cfg
        self.device = resolve_device(device)
        self.builder = BatchBuilder(
            ds, batch_size=cfg.data.batch_size,
            num_neighbors=cfg.data.num_neighbors,
            pad_multiple=cfg.data.pad_multiple, seed=cfg.data.seed)
        self.gcn = cfg.model.model == "gcn_unsup"
        model_cls = GCNGraphUnsup if self.gcn else U2GNNUnsup
        self.model = model_cls(ds.feature_dim, ds.num_nodes, cfg.model,
                               seed=cfg.train.seed).to(self.device)
        self.spec = self.model.spec()
        self.opt = make_optimizer(self.model.parameters(),
                                  cfg.train.learning_rate,
                                  cfg.train.grad_clip_norm)
        self.host_sampling = not cfg.train.on_device_sampling
        table_cfg = cfg if unsup_fused_ok(cfg) else cfg.replace(
            model=dataclasses.replace(cfg.model, use_fused_sampler=False))
        # the GCN aggregates over the batch's edges: no neighborhoods
        tables = {} if self.gcn else device_tables(ds, table_cfg,
                                                   self.device)
        self.fused = "tag_table" in tables
        if not (self.fused or self.gcn):
            check_encoder_shapes(encoder_config(cfg.model),
                                 cfg.data.num_neighbors + 1, ds.feature_dim)
        for name, t in tables.items():
            setattr(self, f"_{name}", t)
        self.csr = (DeviceCSR.from_dataset(ds, self.device)
                    if cfg.model.sampler_type == "neighbor" and not self.gcn
                    else None)
        self.vocab_perm = None
        if cfg.model.id_symmetric:
            self.vocab_perm = torch.from_numpy(
                np.random.default_rng(cfg.train.seed + 7).permutation(
                    ds.num_nodes)).to(self.device)
        self._seeds = torch.Generator().manual_seed(cfg.train.seed + 1)
        self.epoch_losses: List[float] = []
        self.lr_scale = 1.0
        self.num_batches_per_epoch = max(
            1, (ds.num_graphs + cfg.data.batch_size - 1)
            // cfg.data.batch_size)
        self.sched = PlateauStepLR(self.num_batches_per_epoch,
                                   cfg.train.lr_decay_gamma,
                                   cfg.train.plateau_window)

    # ----------------------------------------------------------- one step
    def loss(self, batch: GraphBatch, seed: int) -> torch.Tensor:
        """The training loss of ``batch`` (on the device) for the step
        seeded ``seed``, on this trainer's path."""
        if self.gcn:
            return self.model.loss(batch, self.spec, seed,
                                   vocab_perm=self.vocab_perm)
        kw = dict(csr=self.csr, vocab_perm=self.vocab_perm)
        if self.host_sampling:
            return self.model.loss(batch, self.spec, seed, **kw)
        if self.fused:
            gidx = batch.node_gidx.to(torch.int64)
            si = (self._tag_table[gidx], self._deg[gidx], self._tags[gidx],
                  self._codebook)
            return self.model.loss(batch, self.spec, seed, sampled_inputs=si,
                                   **kw)
        feat, slots, _ = sample_neighborhoods(
            seed, self._nbr_table, self._deg, self._x_global,
            batch.node_gidx, batch.node_mask, self.cfg.data.num_neighbors)
        return self.model.loss(dataclasses.replace(batch, neigh=slots),
                               self.spec, seed, neigh_feat=feat, **kw)

    def train_step(self, batch: GraphBatch, seed: int) -> torch.Tensor:
        """One step on ``batch`` (on the device) seeded ``seed``; returns
        the loss on the device."""
        loss = self.loss(batch, seed)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def next_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self._seeds))

    # ---------------------------------------------------------------- loops
    def train_batches(self, n: int) -> torch.Tensor:
        """``n`` steps, each on a new random batch; their summed loss, a
        device scalar (no host sync)."""
        losses = [self.train_step(self.builder.sample().to(self.device),
                                  self.next_seed()) for _ in range(n)]
        return torch.stack(losses).sum()

    def train_epoch(self) -> float:
        """One epoch; returns the summed batch loss."""
        total = float(self.train_batches(self.num_batches_per_epoch))
        self.epoch_losses.append(total)
        new_scale = self.sched.update(self.epoch_losses)
        if new_scale != self.lr_scale:
            self.lr_scale = new_scale
            set_lr_scale(self.opt, self.lr_scale)
        return total

    # PyTorch runs eagerly: the stacked epoch is the same loop
    train_epoch_stacked = train_epoch

    def graph_embeddings(self) -> np.ndarray:
        """[G, embedding_dim] sum-pooled output rows, on the host."""
        emb = self.model.node_embeddings(self.vocab_perm).detach()
        return pool_node_embeddings(emb.float().cpu().numpy(),
                                    self.ds.graph_offsets)

    def evaluate(self) -> Tuple[float, float]:
        """(mean, std) 10-fold logistic accuracy of the pooled graph
        embeddings (the probe runs on the trainer's device)."""
        return tenfold_logistic_accuracy(self.graph_embeddings(),
                                         self.ds.labels, device=self.device)

    def rng_state(self) -> dict:
        """The host generators' states, JSON-able."""
        return {"builder": self.builder.rng.bit_generator.state,
                "seeds": self._seeds.get_state().tolist()}

    def set_rng_state(self, state: dict) -> None:
        self.builder.rng.bit_generator.state = state["builder"]
        self._seeds.set_state(torch.tensor(state["seeds"], dtype=torch.uint8))


def train_evaluate_unsup(ds: GraphDataset, cfg: ExperimentConfig,
                         log_fn=print, device="cuda",
                         trainer: Optional[UnsupTrainer] = None,
                         start_epoch: int = 1,
                         best: Tuple[float, float] = (0.0, 0.0),
                         on_epoch: Optional[Callable] = None
                         ) -> Dict[str, object]:
    """Train epochs ``start_epoch..cfg.train.num_epochs`` of ``trainer`` (a
    new one by default), probing every ``eval_every`` epochs from the best
    (mean, std) ``best``; ``on_epoch(trainer, row, best)`` runs after each
    epoch's line.  Returns the history and the best mean with its std."""
    trainer = trainer or UnsupTrainer(ds, cfg, device=device)
    history = []
    best_mean, best_std = best
    for epoch in range(start_epoch, cfg.train.num_epochs + 1):
        t0 = time.time()
        loss = trainer.train_epoch()
        if epoch % cfg.train.eval_every == 0:
            mean, std = trainer.evaluate()
        else:
            mean, std = float("nan"), float("nan")
        if mean == mean and mean > best_mean:
            best_mean, best_std = mean, std
        dt = time.time() - t0
        row = {"epoch": epoch, "loss": loss, "acc_mean": mean,
               "acc_std": std, "sec": dt}
        history.append(row)
        log_fn(f"epoch {epoch:03d} | loss {loss:12.2f} | "
               f"10-fold acc {mean:.5f} ± {std:.5f} | {dt:.2f}s")
        if on_epoch is not None:
            on_epoch(trainer, row, (best_mean, best_std))
    return {"history": history, "best_mean": best_mean,
            "best_std": best_std, "trainer": trainer}
