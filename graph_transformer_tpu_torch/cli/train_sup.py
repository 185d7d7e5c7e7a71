"""Supervised U2GNN graph classification CLI — port of
``graph_transformer_tpu/cli/train_sup.py``.

    python -m graph_transformer_tpu_torch.cli.train_sup --dataset IMDBBINARY \
        --batch_size 4 --ff_hidden_size 1024 --num_neighbors 8 \
        --num_epochs 50 --num_timesteps 4 --learning_rate 0.0005 --device cuda

Writes per-epoch accuracy lines to ``<run_folder>/<model_name>/model_acc.txt``
in the reference's format.  ``--scan_epochs`` trains each epoch through
``SupTrainer.train_epoch_stacked`` (one replay of the captured step a
batch; ``train/step_graph.py``).  With ``--checkpoint_every N`` it saves,
every N epochs, the model, the Adam state, the epoch, the loss history, the best
accuracy and the host generators' states (``train/checkpoint.py``; into
``--checkpoint_dir``, default ``<run_folder>/<model_name>/checkpoints``);
``--resume`` restores the latest one, replays the plateau rule over the
losses to rebuild the learning-rate scale, and trains on from the next
epoch.  With the generators restored, a resumed run takes the steps the
uninterrupted run would have taken.
"""

from __future__ import annotations

import os
import time

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.tu import load_tu_dataset
from graph_transformer_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graph_transformer_tpu_torch.train.optim import set_lr_scale
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer


def resume(trainer: SupTrainer, path: str) -> tuple:
    """Load the checkpoint at ``path`` into ``trainer``; returns (first epoch
    to train, best accuracy so far)."""
    params, opt_state, extra = restore_checkpoint(
        path, trainer.model.state_dict(), trainer.opt.state_dict())
    trainer.model.load_state_dict(params)
    trainer.opt.load_state_dict(opt_state)
    extra = extra or {}
    trainer.epoch_losses = [float(v) for v in extra.get("losses", [])]
    # the plateau rule's step count from the loss history, so that the
    # StepLR gating goes on where it left off
    for i in range(len(trainer.epoch_losses)):
        trainer.lr_scale = trainer.sched.update(trainer.epoch_losses[: i + 1])
    set_lr_scale(trainer.opt, trainer.lr_scale)
    if "rng" in extra:
        trainer.set_rng_state(extra["rng"])
    return int(extra.get("epoch", 0)) + 1, float(extra.get("best_acc", 0.0))


def main(argv=None):
    args = base_parser(
        "U2GNN supervised graph classification (PyTorch/CUDA port)"
    ).parse_args(argv)
    cfg = config_from_args(args)
    model_name = args.model_name or f"{args.dataset}_sup_fold{args.fold_idx}"
    out_dir = os.path.join(args.run_folder, model_name)
    os.makedirs(out_dir, exist_ok=True)
    acc_path = os.path.join(out_dir, "model_acc.txt")

    ds = load_tu_dataset(
        cfg.data.dataset, cfg.data.degree_as_tag, cfg.data.data_dir,
        use_node_attributes=cfg.data.use_node_attributes,
    )
    print(f"# data: {ds.num_graphs} graphs, {ds.num_nodes} nodes, "
          f"{ds.num_classes} classes, feature dim {ds.feature_dim}")
    trainer = SupTrainer(ds, cfg, device=args.device)

    start_epoch, best_acc = 1, 0.0
    ckpt_dir = cfg.train.checkpoint_dir or os.path.join(out_dir, "checkpoints")
    if args.resume:
        path = latest_checkpoint(ckpt_dir)
        if path:
            start_epoch, best_acc = resume(trainer, path)
            print(f"# resumed from {path} at epoch {start_epoch}")
    for epoch in range(start_epoch, cfg.train.num_epochs + 1):
        t0 = time.time()
        loss = (trainer.train_epoch_stacked() if cfg.train.scan_epochs
                else trainer.train_epoch())
        acc = (trainer.evaluate() if epoch % cfg.train.eval_every == 0
               else float("nan"))
        best_acc = max(best_acc, acc if acc == acc else 0.0)
        dt = time.time() - t0
        print(f"epoch {epoch:03d} | loss {loss:10.2f} | test acc {acc:.5f} | "
              f"{dt:.2f}s")
        with open(acc_path, "a") as f:
            f.write(f"epoch {epoch} fold {args.fold_idx} acc {acc * 100}%\n")
        if cfg.train.checkpoint_every and epoch % cfg.train.checkpoint_every == 0:
            save_checkpoint(
                ckpt_dir, epoch, trainer.model.state_dict(),
                trainer.opt.state_dict(),
                {"epoch": epoch, "losses": trainer.epoch_losses,
                 "best_acc": best_acc, "rng": trainer.rng_state()})
    print(f"best test accuracy: {best_acc:.5f}")
    return best_acc


if __name__ == "__main__":
    main()
