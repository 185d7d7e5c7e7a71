"""Supervised graph-classification trainer — port of ``SupTrainer`` and
``train_evaluate_sup`` (``graph_transformer_tpu/train/sup_trainer.py``).

Each training step: the host picks ``batch_size`` random graphs and builds the
padded batch (numpy); on the device every node's neighborhood is resampled,
the model scores the graphs, the label-smoothed soft cross entropy is
back-propagated and the clipped Adam step updates the parameters in place.
Two paths, chosen as the JAX trainer chooses (``sup_trainer.py:80-104``):

- **fused**, where :func:`fused_gate_ok` holds (``use_fused_sampler``,
  ``use_pallas`` and ``use_pallas_whole_encoder`` set; one U2GNN layer,
  basic recurrence, one head, neighborhood axis) over features that factor
  through a <=128-row codebook: the sampled encoder samples and encodes in
  one kernel and trains in bf16, picked by the model's flags (K1 with K3/K2
  under ``use_folded``, K5 with K6 under ``use_stored_bwd``, else K13 with
  the recompute backward K8s/K8);
- **two-pass**, otherwise (the default configuration, as the JAX CLI
  cannot set ``use_fused_sampler``; ``num_hidden_layers > 1``, continuous
  node attributes, the Universal-Transformer recurrences, several heads,
  the node axis): one launch of K7 draws every batch row's neighbors from
  the dataset's neighbor table, writes their feature rows from the dataset's
  feature table on the device (``x_global``, in ``cfg.model.compute_dtype``,
  float32 by default) and their batch slots, which replace the batch's
  ``neigh`` so that deeper U2GNN layers re-gather by slot; each U2GNN layer
  runs the encoder the model picks: K4t forward and K8s then K8 per earlier layer backward
  (``ops/u2gnn_train.py``; K4tw and K8ws/K8w past D = 32) for basic
  single-head neighborhood-axis encoders, else the per-layer encoder
  (K9/K10 or K9w/K10w, or plain attention with K11/K12).  With
  ``recurrence="act"`` the loss adds ``act_loss_weight`` times the model's
  ponder cost (``sup_trainer.py:124-125, 193``).

With ``cfg.train.on_device_sampling`` off (the CLI's ``--host_sampling``)
the trainer builds no neighbor table and no fused tables and launches no
sampler, as the JAX trainer (``sup_trainer.py:71, 80-81, 157-158``): each
step trains the two-pass encoders on the host batch's own neighborhoods
``batch.neigh`` (the model's host-sampled branch), which ``train_steps``
keeps fixed and ``train_epoch`` draws anew with every batch.

:meth:`train_steps` runs n steps on one fixed batch — the counterpart of the
JAX ``_train_scan`` (``sup_trainer.py:204-242``) that the benchmark drives.
An epoch sums its step losses on the device and reads the sum once.
Evaluation runs the deterministic model (K4, or the wide K4 past D = 32,
for the whole-encoder configurations; the per-layer encoder at rate 0 for
the others); the test fold's eval batches are built at the first
:meth:`evaluate` and cached, as in JAX, so the builder's draws come in
JAX's order.  The CV runners (``train/tenfold_vmap.py``,
``train/cv_ondevice.py``) hold a trainer a fold and share one
:func:`device_tables` among them.

Random numbers: the host draws one 31-bit seed per step from a CPU
``torch.Generator`` (seeded by ``cfg.train.seed + 1``; :meth:`train_step`
takes the seed from its caller instead); the sampler, the encoder dropout
and the head dropout take disjoint streams of that seed
(``ops/random.py``), so no device generator and no host-device sync are
needed per step.  :meth:`rng_state` holds the host generators for a
checkpoint.  Nothing on the path adds with float atomics, so a step
repeats bit for bit on the card.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from graph_transformer_tpu_torch.config import ExperimentConfig, ModelConfig
from graph_transformer_tpu_torch.data.batching import BatchBuilder, GraphBatch
from graph_transformer_tpu_torch.data.splits import separate_data_idx
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.models.u2gnn_sup import (
    COMPUTE_DTYPES,
    U2GNNSup,
    check_encoder_shapes,
    whole_encoder_ok,
)
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    sample_neighborhoods,
    setup_fused_tables,
)
from graph_transformer_tpu_torch.train.optim import (
    PlateauStepLR,
    make_optimizer,
    set_lr_scale,
)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available (pass device='cpu' to run the plain "
                           "versions)")
    return device


def fused_gate_ok(cfg_model: ModelConfig) -> bool:
    """The configuration part of the fused path's gate, JAX's
    (``graph_transformer_tpu/ops/pallas_sampled_encoder.py:115-126``; the
    dataset part, a codebook of at most 128 rows, is
    ``setup_fused_tables``)."""
    return (cfg_model.use_fused_sampler and cfg_model.use_pallas
            and cfg_model.use_pallas_whole_encoder
            and cfg_model.num_hidden_layers == 1
            and whole_encoder_ok(cfg_model))


def device_tables(ds: GraphDataset, cfg: ExperimentConfig, device) -> dict:
    """The dataset's tables on ``device`` that training steps read, built
    once: with device sampling, ``deg`` and, on the two-pass path, the
    neighbor table ``nbr_table`` and the feature table ``x_global`` (in
    ``compute_dtype``), or on the fused path ``tag_table``, ``tags`` and
    ``codebook``; none with host sampling.  The CV runners build them once
    for all folds."""
    dev = resolve_device(device)
    if not cfg.train.on_device_sampling:
        return {}
    table = build_neighbor_table(ds, hub_seed=cfg.train.seed)
    fused = (setup_fused_tables(ds.node_feat, table)
             if fused_gate_ok(cfg.model) else None)
    out = {"deg": torch.from_numpy(ds.degrees.astype(np.int32)).to(dev)}
    if fused is None:
        out["nbr_table"] = torch.from_numpy(table).to(dev)
        out["x_global"] = torch.from_numpy(np.ascontiguousarray(
            ds.node_feat, np.float32)).to(
                dev, COMPUTE_DTYPES[cfg.model.compute_dtype])
    else:
        for name, a in zip(("tag_table", "tags", "codebook"), fused):
            out[name] = torch.from_numpy(a).to(dev)
    return out


class SupTrainer:
    """Supervised U2GNN trainer for one CV fold.  ``tables``: the
    :func:`device_tables` of ``ds`` and ``cfg`` on ``device``, where a
    caller shares them among folds."""

    def __init__(self, ds: GraphDataset, cfg: ExperimentConfig,
                 train_idx: Optional[np.ndarray] = None,
                 test_idx: Optional[np.ndarray] = None,
                 device="cuda", tables: Optional[dict] = None):
        self.ds, self.cfg = ds, cfg
        self.device = resolve_device(device)
        if train_idx is None or test_idx is None:
            train_idx, test_idx = separate_data_idx(ds.labels, cfg.data.fold_idx)
        self.train_idx, self.test_idx = train_idx, test_idx
        self.builder = BatchBuilder(
            ds, batch_size=cfg.data.batch_size,
            num_neighbors=cfg.data.num_neighbors,
            pad_multiple=cfg.data.pad_multiple, seed=cfg.data.seed,
            indices=train_idx)
        self.model = U2GNNSup(ds.feature_dim, ds.num_classes, cfg.model,
                              seed=cfg.train.seed).to(self.device)
        self.opt = make_optimizer(self.model.parameters(),
                                  cfg.train.learning_rate,
                                  cfg.train.grad_clip_norm)
        self.host_sampling = not cfg.train.on_device_sampling
        if tables is None:
            tables = device_tables(ds, cfg, self.device)
        self.two_pass = "tag_table" not in tables
        if self.two_pass:
            check_encoder_shapes(cfg.model, cfg.data.num_neighbors + 1,
                                 ds.feature_dim)
        for name, t in tables.items():
            setattr(self, f"_{name}", t)
        self._seeds = torch.Generator().manual_seed(cfg.train.seed + 1)
        self.act_weight = (cfg.model.act_loss_weight
                           if cfg.model.recurrence == "act" else 0.0)
        self.epoch_losses: List[float] = []
        self.lr_scale = 1.0
        self.num_batches_per_epoch = max(
            1, (len(train_idx) + cfg.data.batch_size - 1) // cfg.data.batch_size)
        self.sched = PlateauStepLR(self.num_batches_per_epoch,
                                   cfg.train.lr_decay_gamma,
                                   cfg.train.plateau_window)
        self._eval_stack = self._eval_rng = None

    # ----------------------------------------------------------- one step
    def sampled_inputs(self, batch: GraphBatch) -> tuple:
        """(tag_rows, deg, self_tag, codebook) of the batch's node slots, the
        fused path's inputs."""
        gidx = batch.node_gidx.to(torch.int64)
        return (self._tag_table[gidx], self._deg[gidx], self._tags[gidx],
                self._codebook)

    def two_pass_inputs(self, batch: GraphBatch) -> tuple:
        """(node_gidx [N] int32, node_mask [N] float32) of the batch, what
        the two-pass path's sampler reads beside the dataset's tables; the
        batch holds them so, and nothing is gathered."""
        return batch.node_gidx, batch.node_mask

    def step_inputs(self, batch: GraphBatch) -> tuple:
        """What a training step of this trainer's path reads of the batch
        beside the device tables, once per batch: the fused path's table
        rows, the two-pass path's node ids and mask (none when sampling on
        the host)."""
        if self.host_sampling:
            return ()
        return (self.two_pass_inputs(batch) if self.two_pass
                else self.sampled_inputs(batch))

    def _scores(self, batch: GraphBatch, si: tuple, seed: int):
        """(scores, ponder) of one training step."""
        if self.host_sampling:
            return self.model(batch, seed=seed, return_ponder=True)
        if not self.two_pass:
            return self.model(batch, sampled_inputs=si, seed=seed,
                              return_ponder=True)
        feat, slots, _ = sample_neighborhoods(
            seed, self._nbr_table, self._deg, self._x_global, *si,
            self.cfg.data.num_neighbors)
        return self.model(dataclasses.replace(batch, neigh=slots), seed=seed,
                          neigh_feat=feat, return_ponder=True)

    def loss(self, batch: GraphBatch, scores, ponder) -> torch.Tensor:
        """The label-smoothed soft cross entropy, plus the ACT ponder cost
        times ``act_loss_weight`` for ``recurrence="act"`` (t2t's
        ``act_loss``)."""
        targets = label_smoothing(batch.labels, self.ds.num_classes,
                                  self.cfg.model.label_smoothing)
        return soft_cross_entropy(scores, targets) + self.act_weight * ponder

    def train_step(self, batch: GraphBatch, si: tuple,
                   seed: int) -> torch.Tensor:
        """One step on ``batch`` (with its :meth:`step_inputs` ``si``),
        drawing the sampler's and the dropout's bits from ``seed``; returns
        the loss on the device."""
        loss = self.loss(batch, *self._scores(batch, si, seed))
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def _step(self, batch: GraphBatch, si: tuple) -> torch.Tensor:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self._seeds))
        return self.train_step(batch, si, seed)

    def train_steps(self, batch: GraphBatch, n_steps: int) -> torch.Tensor:
        """``n_steps`` steps on one fixed batch (neighborhoods resample every
        step on the device; with host sampling every step reuses the batch's
        ``neigh``); returns the [n_steps] losses on the device,
        unsynchronised."""
        batch = batch.to(self.device)
        si = self.step_inputs(batch)
        return torch.stack([self._step(batch, si) for _ in range(n_steps)])

    # ---------------------------------------------------------------- loops
    def train_batches(self, n: int) -> torch.Tensor:
        """``n`` steps, each on a new random batch; returns their summed
        loss, a float32 device scalar (no host sync)."""
        losses = []
        for _ in range(n):
            batch = self.builder.sample().to(self.device)
            losses.append(self._step(batch, self.step_inputs(batch)))
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

    def eval_stack(self, indices) -> list:
        """The device batches covering ``indices`` in order, with each
        batch's count of real graphs (its neighborhoods drawn now from the
        builder's generator)."""
        return [(b.to(self.device), n)
                for b, n in self.builder.eval_batches(indices)]

    @torch.no_grad()
    def stack_correct(self, stack: list) -> torch.Tensor:
        """Correct argmax predictions over an :meth:`eval_stack`, an int64
        device scalar (deterministic forward)."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for batch, n_real in stack:
            pred = self.model(batch)[:n_real].argmax(dim=1)
            correct += (pred == batch.labels[:n_real].to(torch.int64)).sum()
        return correct

    def test_stack(self) -> list:
        """The test fold's :meth:`eval_stack`, built at the first call and
        cached, as JAX's trainer caches it (the builder's state it was drawn
        from is kept for :meth:`rng_state`)."""
        if self._eval_stack is None:
            self._eval_rng = self.builder.rng.bit_generator.state
            self._eval_stack = self.eval_stack(self.test_idx)
        return self._eval_stack

    def evaluate(self, indices: Optional[np.ndarray] = None) -> float:
        """Argmax accuracy over ``indices`` (default: the test fold's cached
        :meth:`test_stack`), deterministic forward."""
        if indices is None:
            return int(self.stack_correct(self.test_stack())) / len(self.test_idx)
        idx = np.asarray(indices)
        return int(self.stack_correct(self.eval_stack(idx))) / len(idx)

    def rng_state(self) -> dict:
        """The host generators' states, JSON-able: the batch builder's, the
        per-step seeds' and, once the test fold's eval batches are cached,
        the builder's state they were drawn from."""
        return {"builder": self.builder.rng.bit_generator.state,
                "seeds": self._seeds.get_state().tolist(),
                "eval": self._eval_rng}

    def set_rng_state(self, state: dict) -> None:
        """Restore :meth:`rng_state`, redrawing the cached eval batches."""
        if state.get("eval") is not None:
            self.builder.rng.bit_generator.state = state["eval"]
            self._eval_stack = None
            self.test_stack()
        self.builder.rng.bit_generator.state = state["builder"]
        self._seeds.set_state(torch.tensor(state["seeds"], dtype=torch.uint8))


def train_evaluate_sup(ds: GraphDataset, cfg: ExperimentConfig,
                       log_fn=print, device="cuda") -> Dict[str, object]:
    """Full train/eval loop for one fold; returns history + best accuracy.
    (``cfg.train.scan_epochs`` trains the same per-step loop: PyTorch runs
    eagerly, so there is no one-dispatch epoch to choose.)"""
    trainer = SupTrainer(ds, cfg, device=device)
    history = []
    best_acc = 0.0
    for epoch in range(1, cfg.train.num_epochs + 1):
        t0 = time.time()
        loss = trainer.train_epoch()
        acc = (trainer.evaluate() if epoch % cfg.train.eval_every == 0
               else float("nan"))
        best_acc = max(best_acc, acc if acc == acc else 0.0)
        dt = time.time() - t0
        history.append({"epoch": epoch, "loss": loss, "test_acc": acc,
                        "sec": dt})
        log_fn(f"epoch {epoch:03d} | loss {loss:10.2f} | acc {acc:.4f} | "
               f"{dt:.2f}s")
    return {"history": history, "best_acc": best_acc, "trainer": trainer}
