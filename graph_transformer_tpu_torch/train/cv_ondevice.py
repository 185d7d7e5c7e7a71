"""The whole k-fold cross-validation on the device — port of
``run_cv_on_device`` (``graph_transformer_tpu/train/cv_ondevice.py``).

JAX runs the CV as one device program a chunk of epochs: folds vmapped,
epochs and steps scanned.  The port keeps its protocol and its carry, with
the folds one after another inside each epoch.  Each training step, on the
card and with no host round trip:

- select the batch's graphs from the fold's train split without
  replacement (``ops/random.select_without_replacement``: the ``B`` smallest
  counter-hash keys, drawn for a whole epoch at once);
- assemble the padded batch (``data/device_batcher.assemble_batch``);
- draw the neighborhoods and their feature rows (K7,
  ``sampling/neighbor_table.sample_neighborhoods``), run the forward, the
  backward and Adam (``SupTrainer.train_step``, the two-pass path), on
  JAX's CV loss: the label-smoothed cross entropy, with no ACT ponder cost
  for ``recurrence="act"`` (``cv_ondevice.py:227-233``).

Each epoch, still on the device: the test fold's accuracy on eval batches
built once on the host (each fold's ``BatchBuilder`` seeded with
``cfg.data.seed``, as in JAX), the best accuracy, and the plateau rule
(:func:`plateau_step`) with the learning-rate scale as a device scalar.
The host reads back only at chunk boundaries, as JAX's dispatches do.

Every seed derives from absolute indices: step ``i`` of epoch ``e`` draws
from ``ops/random.step_seed(cfg.train.seed + 1, e, i)``, shared across folds
as JAX's key is, so a resumed run needs no generator state.  With a
``checkpoint_dir`` the whole carry (per-fold model and Adam states,
``best_f``, ``hist_f``, ``npl_f``, the epoch losses and accuracies so far,
``chunk``) is saved at every chunk boundary but the last, and a run that
finds a snapshot resumes from it bit for bit (``train/elastic.py``).

Where JAX samples with its CSR sampler off the TPU, the port runs K7 on
every device, as its ``SupTrainer`` does.  The selection and the hash are
the port's own, so a run matches JAX's statistically, not bit for bit, as
JAX's own on-device CV matches its host-sampled runners.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from graph_transformer_tpu_torch.config import ExperimentConfig
from graph_transformer_tpu_torch.data.device_batcher import (
    DeviceDataset,
    assemble_batch,
)
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.ops.random import (
    select_without_replacement,
    step_seed,
)
from graph_transformer_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graph_transformer_tpu_torch.train.sup_trainer import (
    SupTrainer,
    device_tables,
    fused_gate_ok,
    resolve_device,
)

HIST_FILL = 3.0e38  # plateau-history fill: never fires


def epochs_per_chunk(num_epochs: int, steps: int, batch_size: int,
                     epochs_per_dispatch: Optional[int] = None) -> int:
    """JAX's chunk length (``cv_ondevice.py:182-194``): by default about
    4,800 graph-steps a chunk, at most ``num_epochs``, cut to the largest
    divisor of ``num_epochs`` within it."""
    if epochs_per_dispatch is None:
        epochs_per_dispatch = max(1, 4800 // max(1, steps * batch_size))
    epochs_per_dispatch = min(epochs_per_dispatch, num_epochs)
    return max(d for d in range(1, epochs_per_dispatch + 1)
               if num_epochs % d == 0)


def plateau_step(loss: torch.Tensor, epoch: int, hist: torch.Tensor,
                 n_plateau: torch.Tensor, steps: int, gamma: torch.Tensor):
    """One epoch of the plateau-gated StepLR on the device
    (``cv_ondevice.py:251-260``): a plateau epoch (``epoch`` >= the window
    ``W = len(hist)`` and ``loss`` above the mean of the last ``W`` epoch
    losses ``hist``) is one scheduler step, and the scale decays by
    ``gamma`` once per ``steps`` of them.  Returns ``(lr_scale, hist,
    n_plateau)``, the history rolled to end at ``loss``; no host sync."""
    fired = (epoch >= hist.shape[0]) & (loss > hist.mean())
    n_plateau = n_plateau + fired.to(n_plateau.dtype)
    scale = torch.pow(gamma, (n_plateau // steps).to(torch.float32))
    return scale, torch.cat([hist[1:], loss[None]]), n_plateau


def run_cv_on_device(
    ds: GraphDataset,
    cfg: ExperimentConfig,
    num_folds: int = 10,
    folds: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    return_history: bool = False,
    epochs_per_dispatch: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
):
    """Full CV on the device; returns ``(best_accs [F], mean, std)``, plus
    the histories ``(epoch_losses, epoch_accs)`` [epochs, F] with
    ``return_history``.  ``epochs_per_dispatch`` bounds a chunk (the epochs
    between host reads and snapshots); ``checkpoint_dir`` (default
    ``cfg.train.checkpoint_dir``) snapshots and resumes as the module
    says."""
    if not cfg.train.on_device_sampling:
        raise ValueError("run_cv_on_device requires on_device_sampling")
    if fused_gate_ok(cfg.model):  # JAX's CV trains the two-pass path
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, use_fused_sampler=False))
    dev = resolve_device(device)
    if folds is None:
        folds = stratified_kfold_indices(ds.labels, num_folds, seed=0)
    F = len(folds)
    B = cfg.data.batch_size
    W = cfg.train.plateau_window

    # ---- host prep, once: fold id tables, eval stacks, dataset upload
    tables = device_tables(ds, cfg, dev)
    trainers = [SupTrainer(ds, cfg, tr, te, dev, tables) for tr, te in folds]
    for t in trainers:  # JAX's CV loss has no ACT ponder cost (:227-233)
        t.act_weight = 0.0
    n_pad = trainers[0].builder.n_pad
    steps = max(t.num_batches_per_epoch for t in trainers)
    counts = [len(tr) for tr, _ in folds]
    train_ids = torch.zeros(F, max(counts), dtype=torch.int64)
    for f, (tr, _) in enumerate(folds):
        train_ids[f, : len(tr)] = torch.as_tensor(np.asarray(tr))
    train_ids = train_ids.to(dev)
    eval_stacks = [t.test_stack() for t in trainers]
    n_test = torch.tensor([len(te) for _, te in folds], dtype=torch.float32,
                          device=dev)
    dd = DeviceDataset.from_dataset(ds, dev)
    gamma = torch.tensor(cfg.train.lr_decay_gamma, dtype=torch.float32,
                         device=dev)
    base = cfg.train.seed + 1

    num_epochs = cfg.train.num_epochs
    per_chunk = epochs_per_chunk(num_epochs, steps, B, epochs_per_dispatch)
    n_chunks = num_epochs // per_chunk

    best_f = torch.zeros(F, dtype=torch.float32, device=dev)
    hist_f = torch.full((F, W), HIST_FILL, dtype=torch.float32, device=dev)
    npl_f = torch.zeros(F, dtype=torch.int64, device=dev)
    elosses: List[np.ndarray] = []
    eaccs: List[np.ndarray] = []
    chunk0 = 0
    ckpt_dir = checkpoint_dir or cfg.train.checkpoint_dir
    path = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if path is not None:
        params, opt_states, extra = restore_checkpoint(
            path, [t.model.state_dict() for t in trainers],
            [t.opt.state_dict() for t in trainers])
        for t, p, s in zip(trainers, params, opt_states):
            t.model.load_state_dict(p)
            t.opt.load_state_dict(s)
        chunk0 = int(extra["chunk"])
        best_f = torch.tensor(extra["best_f"], dtype=torch.float32, device=dev)
        hist_f = torch.tensor(extra["hist_f"], dtype=torch.float32, device=dev)
        npl_f = torch.tensor(extra["npl_f"], dtype=torch.int64, device=dev)
        elosses = [np.asarray(a, np.float32) for a in extra["elosses"]]
        eaccs = [np.asarray(a, np.float32) for a in extra["eaccs"]]

    for c in range(chunk0, n_chunks):
        c_loss, c_acc = [], []
        for e in range(c * per_chunk, (c + 1) * per_chunk):
            sel = select_without_replacement(base, e, counts, B, steps,
                                             train_ids.shape[1], dev)
            seeds = [step_seed(base, e, i) for i in range(steps)]
            e_loss, e_acc = [], []
            for f, t in enumerate(trainers):
                gids = train_ids[f][sel[f]]  # [steps, B]
                losses = []
                for i in range(steps):
                    b = assemble_batch(dd, gids[i], n_pad)
                    losses.append(t.train_step(b, t.step_inputs(b), seeds[i]))
                loss = torch.stack(losses).sum()
                t.opt.lr_scale, hist_f[f], npl_f[f] = plateau_step(
                    loss, e, hist_f[f], npl_f[f], steps, gamma)
                acc = t.stack_correct(eval_stacks[f]).to(torch.float32) \
                    / n_test[f]
                best_f[f] = torch.maximum(best_f[f], acc)
                e_loss.append(loss)
                e_acc.append(acc)
            c_loss.append(torch.stack(e_loss))
            c_acc.append(torch.stack(e_acc))
        # the chunk's summaries: the only read back, a completion barrier
        elosses.append(torch.stack(c_loss, 1).cpu().numpy())
        eaccs.append(torch.stack(c_acc, 1).cpu().numpy())
        if ckpt_dir and c < n_chunks - 1:
            save_checkpoint(
                ckpt_dir, c + 1, [t.model.state_dict() for t in trainers],
                [t.opt.state_dict() for t in trainers],
                extra={"chunk": c + 1,
                       "best_f": best_f.cpu().numpy(),
                       "hist_f": hist_f.cpu().numpy(),
                       "npl_f": npl_f.cpu().numpy(),
                       "elosses": [a.tolist() for a in elosses],
                       "eaccs": [a.tolist() for a in eaccs]})
    best = best_f.cpu().numpy()
    eloss = np.concatenate(elosses, axis=1)[:, :num_epochs]
    eacc = np.concatenate(eaccs, axis=1)[:, :num_epochs]
    if return_history:
        return best, float(best.mean()), float(best.std()), eloss.T, eacc.T
    return best, float(best.mean()), float(best.std())
