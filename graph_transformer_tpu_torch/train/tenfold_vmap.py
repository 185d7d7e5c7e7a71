"""Fold-looped k-fold cross-validation — port of ``TenfoldVmapRunner``
(``graph_transformer_tpu/train/tenfold_vmap.py``).

The JAX runner trains all folds as one ``vmap``ped device program per epoch.
The port keeps the math and leaves the vmap: on one card the folds' epochs
run one after another inside each epoch (launching folds together is later
speed work).  The semantics are JAX's (``tenfold_vmap.py:14-31``):

- every fold starts from the same initial weights (the model's seed is
  ``cfg.train.seed``, or ``init_state`` for all folds);
- each fold's ``BatchBuilder`` is seeded with ``cfg.data.seed`` and drawn in
  JAX's order: each epoch's training batches, and the test fold's eval
  batches once, at the first :meth:`evaluate`, then cached;
- every fold trains ``steps_per_epoch`` steps an epoch, the largest fold's
  count, and its per-step seeds come from a generator seeded with
  ``cfg.train.seed + 1``, so that every fold draws the same seeds, as F
  sequential trainers seeded alike would;
- each fold has its own plateau schedule (``self.scheds``), counted in its
  own batches an epoch.

So a fold whose batch count equals ``steps_per_epoch`` trains bit for bit as
a sequential :class:`SupTrainer` on it (``cli/tenfold.py``'s default loop).
Each fold is a :class:`SupTrainer` sharing the dataset's device tables.

``shard_folds`` N > 1 shards the folds over N ranks (``parallel/``; JAX's
``mesh`` fold axis, ``tenfold_vmap.py:76-81, 135-145``): rank r of the
``data`` axis trains folds r, r + N, … and nothing crosses ranks while they
train; each epoch's losses and each evaluation are gathered, so every rank
returns every fold's numbers, in fold order.  A fold trains as it does
unsharded (its seeds are its own, and ``steps_per_epoch`` is the largest
batch count over all folds), so the sharded run equals the unsharded one
fold for fold.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from graph_transformer_tpu_torch.config import ExperimentConfig
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
)
from graph_transformer_tpu_torch.train.optim import PlateauStepLR, set_lr_scale
from graph_transformer_tpu_torch.train.sup_trainer import (
    SupTrainer,
    device_tables,
    resolve_device,
)


def fold_mesh(num_folds: int, shard_folds: int, mesh: Optional[Mesh] = None,
              device=None) -> Optional[Mesh]:
    """The mesh whose ``data`` axis the folds shard over, or None for
    ``shard_folds`` <= 1.  JAX's divisibility check first; without a
    ``mesh``, the whole initialised group on ``device``, which must have
    ``shard_folds`` ranks."""
    if shard_folds <= 1:
        return None
    if num_folds % shard_folds:
        raise ValueError(f"fold count {num_folds} must divide evenly over "
                         f"{shard_folds} devices")
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != shard_folds:
            raise RuntimeError(
                f"shard_folds={shard_folds} needs an initialised process "
                f"group of {shard_folds} ranks (parallel/bootstrap."
                f"initialize_from_env, or parallel/launch.py); found "
                f"{world or 'none'}")
        mesh = make_mesh(device=device)
    if mesh.axis_size("data") != shard_folds:
        raise ValueError(f"the mesh's data axis has {mesh.axis_size('data')}"
                         f" ranks, not shard_folds={shard_folds}")
    return mesh


def carve_validation(ds: GraphDataset, folds, val_fraction: float,
                     seed: int):
    """(folds with the validation graphs taken out of each train split,
    validation sets): a stratified ``val_fraction`` of each class of each
    train split, drawn as JAX draws it (``tenfold_vmap.py:86-105``)."""
    rng = np.random.default_rng(seed + 7919)
    new_folds, vals = [], []
    for tr, te in folds:
        tr = np.asarray(tr)
        val_idx = []
        for c in np.unique(ds.labels[tr]):
            m = tr[ds.labels[tr] == c]
            m = m[rng.permutation(len(m))]
            k = max(1, int(round(val_fraction * len(m))))
            val_idx.append(m[:k])
        val = np.concatenate(val_idx)
        new_folds.append((np.setdiff1d(tr, val), te))
        vals.append(val)
    return new_folds, vals


class TenfoldVmapRunner:
    """Train and evaluate all CV folds of ``ds`` on one card, or sharded
    over ranks.

    :meth:`run` returns the per-fold best-epoch test accuracies, the number
    the reference protocol reports."""

    def __init__(self, ds: GraphDataset, cfg: ExperimentConfig,
                 num_folds: int = 10,
                 folds: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
                 shard_folds: int = 1, val_fraction: float = 0.0,
                 init_state: Optional[dict] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        """``shard_folds`` N > 1 trains the folds over the N ranks of
        ``mesh``'s ``data`` axis (default: the whole initialised group,
        which must have N ranks; :func:`fold_mesh`).  ``val_fraction`` > 0
        carves a stratified validation set out of each fold's train split
        (:meth:`evaluate_val`).  ``init_state``: a state dict every fold
        starts from (e.g. ``weights.params_from_jax``)."""
        self.ds, self.cfg = ds, cfg
        self.device = resolve_device(device)
        self.folds = (stratified_kfold_indices(ds.labels, num_folds, seed=0)
                      if folds is None else folds)
        self.mesh = fold_mesh(len(self.folds), shard_folds, mesh,
                              self.device)
        self.val_sets: Optional[List[np.ndarray]] = None
        if val_fraction > 0.0:
            self.folds, self.val_sets = carve_validation(
                ds, self.folds, val_fraction, cfg.train.seed)
        self.num_folds = F = len(self.folds)
        W, r = ((1, 0) if self.mesh is None else
                (self.mesh.axis_size("data"), self.mesh.axis_index("data")))
        self.own = list(range(r, F, W))  # the folds this rank trains
        tables = device_tables(ds, cfg, self.device)
        self.trainers = [SupTrainer(ds, cfg, *self.folds[f], self.device,
                                    tables) for f in self.own]
        if init_state is not None:
            for t in self.trainers:
                t.model.load_state_dict(init_state)
        B = cfg.data.batch_size
        self.steps_per_epoch = max(max(1, -(-len(tr) // B))
                                   for tr, _ in self.folds)
        self.epoch_losses: List[List[float]] = [[] for _ in range(F)]
        self.lr_scales = np.ones(len(self.own))
        self.scheds = [PlateauStepLR(t.num_batches_per_epoch,
                                     cfg.train.lr_decay_gamma,
                                     cfg.train.plateau_window)
                       for t in self.trainers]
        self._val_stack = None

    def _gather(self, local: torch.Tensor) -> np.ndarray:
        """[F, ...] in fold order from this rank's [len(own), ...]."""
        if self.mesh is None:
            return local.cpu().numpy()
        parts = all_gather(local.to(self.mesh.device), self.mesh, "data")
        return parts.transpose(0, 1).reshape(
            self.num_folds, *local.shape[1:]).cpu().numpy()

    # ---------------------------------------------------------------- epochs
    def train_epoch(self) -> np.ndarray:
        """One epoch of every fold, one fold after another; returns the
        per-fold summed epoch loss [F]."""
        sums = [t.train_batches(self.steps_per_epoch) for t in self.trainers]
        losses = self._gather(torch.stack(sums))
        for f in range(self.num_folds):
            self.epoch_losses[f].append(float(losses[f]))
        for i, (f, t) in enumerate(zip(self.own, self.trainers)):
            scale = self.scheds[i].update(self.epoch_losses[f])
            if scale != self.lr_scales[i]:
                self.lr_scales[i] = scale
                set_lr_scale(t.opt, scale)
        return losses

    def _stack_correct(self, stacks) -> np.ndarray:
        return self._gather(torch.stack([t.stack_correct(s) for t, s in
                                         zip(self.trainers, stacks)]))

    def _test_stacks(self) -> list:
        return [t.test_stack() for t in self.trainers]

    def _eval_batches(self) -> int:
        """The most test batches of any fold (every fold's stack is padded
        to it)."""
        B = self.cfg.data.batch_size
        return max(-(-len(te) // B) for _, te in self.folds)

    def evaluate(self) -> np.ndarray:
        """Per-fold test accuracy [F] (eval batches built at the first call,
        then cached)."""
        counts = np.array([len(te) for _, te in self.folds])
        return self._stack_correct(self._test_stacks()) / counts

    def evaluate_val(self) -> np.ndarray:
        """Per-fold accuracy on the carved validation sets (needs
        ``val_fraction > 0``)."""
        if self.val_sets is None:
            raise ValueError("construct with val_fraction > 0")
        if self._val_stack is None:
            self._val_stack = [t.eval_stack(self.val_sets[f]) for f, t in
                               zip(self.own, self.trainers)]
        counts = np.array([len(v) for v in self.val_sets])
        return self._stack_correct(self._val_stack) / counts

    @torch.no_grad()
    def evaluate_scores(self) -> Tuple[np.ndarray, np.ndarray]:
        """(per-fold test accuracy [F], raw test scores [F, nb, B, C]); a
        fold with fewer eval batches than the most repeats its last batch's
        scores, as JAX pads its stack by repeating the last batch."""
        nb = self._eval_batches()
        scores = []
        for t, stack in zip(self.trainers, self._test_stacks()):
            s = [t.model(b) for b, _ in stack]
            s += [s[-1]] * (nb - len(s))
            scores.append(torch.stack(s))
        return self.evaluate(), self._gather(torch.stack(scores).float())

    def test_label_mask(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(labels [F, nb, B], mask [F, nb, B], counts [F]) of the test
        stack, padded as :meth:`evaluate_scores` pads it (zero mask)."""
        nb = self._eval_batches()
        B = self.cfg.data.batch_size
        labels = torch.zeros((len(self.own), nb, B), dtype=torch.int32)
        mask = torch.zeros((len(self.own), nb, B))
        for j, stack in enumerate(self._test_stacks()):
            for i in range(nb):
                b, n = stack[min(i, len(stack) - 1)]
                labels[j, i] = b.labels.cpu()
                mask[j, i, :n] = 1.0 if i < len(stack) else 0.0
        counts = np.array([len(te) for _, te in self.folds])
        return self._gather(labels), self._gather(mask), counts

    def run(self, log_fn=print) -> Tuple[np.ndarray, float, float]:
        """Full CV: (per-fold best accuracies, mean, std)."""
        best = np.zeros(self.num_folds)
        for epoch in range(1, self.cfg.train.num_epochs + 1):
            losses = self.train_epoch()
            if epoch % self.cfg.train.eval_every == 0:
                best = np.maximum(best, self.evaluate())
            if log_fn is not None:
                log_fn(f"epoch {epoch:03d} | mean loss {losses.mean():10.2f} "
                       f"| mean best acc {best.mean():.4f}")
        return best, float(best.mean()), float(best.std())
