"""Unsupervised U2GNN node-embedding CLI — port of
``graph_transformer_tpu/cli/train_unsup.py``.

    python -m graph_transformer_tpu_torch.cli.train_unsup --dataset IMDBBINARY \
        --batch_size 2 --ff_hidden_size 1024 --num_neighbors 8 \
        --num_sampled 512 --num_epochs 50 --num_timesteps 1 \
        --learning_rate 0.0001 --device cuda

Transductive training over all graphs, a 10-fold logistic-regression probe
of the pooled embeddings every ``--eval_every`` epochs, and per-epoch lines
``epoch <e> mean: <mean × 100> std: <std × 100>`` in
``<run_folder>/<model_name>/model_acc.txt`` (the reference's format,
``train_pytorch_U2GNN_UnSup.py:213``).  The flags are the JAX CLI's
(``cli/common.py`` plus ``--sampled_softmax_mode``, ``--permute_graphs``,
``--id_symmetric``, the default unless ``--reference_parity``, which
excludes both) and ``--device``.  With ``--checkpoint_every N`` it saves the
model, the Adam state, the epoch, the losses, the best mean and the host
generators every N epochs (``train/checkpoint.py``); ``--resume`` restores
the latest, replays the plateau rule over the losses and trains on from the
next epoch, so a resumed run takes the straight run's steps.
"""

from __future__ import annotations

import dataclasses
import os

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.tu import load_tu_dataset, permute_graphs
from graph_transformer_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graph_transformer_tpu_torch.train.optim import set_lr_scale
from graph_transformer_tpu_torch.train.unsup_trainer import (
    UnsupTrainer,
    train_evaluate_unsup,
)


def parser():
    p = base_parser("U2GNN unsupervised node embeddings (PyTorch/CUDA port)")
    p.add_argument(
        "--sampled_softmax_mode", default="tf", choices=["tf", "reference"],
        help="'tf' = tf.nn.sampled_softmax_loss semantics; 'reference' = the "
             "PyTorch fork's NCE variant")
    p.add_argument(
        "--permute_graphs", type=int, default=None, metavar="SEED",
        help="shuffle the dataset's graph order with this seed before "
             "training (the TU files are class-sorted, so file order leaks "
             "the label into node ids); omit for file order")
    p.add_argument(
        "--id_symmetric", action="store_true", default=None,
        help="train node v's output row at a per-run random permuted index "
             "(the default unless --reference_parity is given)")
    p.add_argument(
        "--reference_parity", action="store_true",
        help="the reference protocol exactly, its file-order leak included")
    return p


def parse_config(argv=None):
    """(args, config) of the command line, as the JAX CLI resolves them."""
    p = parser()
    args = p.parse_args(argv)
    if args.id_symmetric is None:
        args.id_symmetric = not args.reference_parity
    if args.reference_parity and (args.id_symmetric
                                  or args.permute_graphs is not None):
        p.error("--reference_parity excludes --id_symmetric/"
                "--permute_graphs")
    cfg = config_from_args(args)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, sampled_softmax_mode=args.sampled_softmax_mode,
        id_symmetric=args.id_symmetric))
    return args, cfg


def resume(trainer: UnsupTrainer, path: str) -> tuple:
    """Load the checkpoint at ``path`` into ``trainer``; returns (first epoch
    to train, best mean, its std)."""
    params, opt_state, extra = restore_checkpoint(
        path, trainer.model.state_dict(), trainer.opt.state_dict())
    trainer.model.load_state_dict(params)
    trainer.opt.load_state_dict(opt_state)
    extra = extra or {}
    trainer.epoch_losses = [float(v) for v in extra.get("losses", [])]
    for i in range(len(trainer.epoch_losses)):
        trainer.lr_scale = trainer.sched.update(trainer.epoch_losses[: i + 1])
    set_lr_scale(trainer.opt, trainer.lr_scale)
    if "rng" in extra:
        trainer.set_rng_state(extra["rng"])
    return (int(extra.get("epoch", 0)) + 1, float(extra.get("best_mean", 0.0)),
            float(extra.get("best_std", 0.0)))


def main(argv=None):
    args, cfg = parse_config(argv)
    model_name = args.model_name or f"{args.dataset}_unsup"
    out_dir = os.path.join(args.run_folder, model_name)
    os.makedirs(out_dir, exist_ok=True)
    acc_path = os.path.join(out_dir, "model_acc.txt")

    ds = load_tu_dataset(
        cfg.data.dataset, cfg.data.degree_as_tag, cfg.data.data_dir,
        use_node_attributes=cfg.data.use_node_attributes,
    )
    if args.permute_graphs is not None:
        ds = permute_graphs(ds, seed=args.permute_graphs)
        print(f"# leak-free protocol: graph order permuted (seed "
              f"{args.permute_graphs})")
    proto = ("reference-parity (FILE-ORDER LEAK ACTIVE)"
             if args.reference_parity else
             "leak-free (id-symmetric candidate indexing)"
             if args.id_symmetric else "leak-free (permuted graph order)")
    print(f"# protocol: {proto}")
    print(f"# data: {ds.num_graphs} graphs, {ds.num_nodes} nodes (vocab), "
          f"{ds.num_classes} classes")
    trainer = UnsupTrainer(ds, cfg, device=args.device)

    start_epoch, best_mean, best_std = 1, 0.0, 0.0
    ckpt_dir = cfg.train.checkpoint_dir or os.path.join(out_dir, "checkpoints")
    if args.resume:
        path = latest_checkpoint(ckpt_dir)
        if path:
            start_epoch, best_mean, best_std = resume(trainer, path)
            print(f"# resumed from {path} at epoch {start_epoch}")

    def on_epoch(trainer, row, best):
        epoch, mean, std = row["epoch"], row["acc_mean"], row["acc_std"]
        with open(acc_path, "a") as f:
            f.write(f"epoch {epoch} mean: {mean * 100} std: {std * 100}\n")
        if cfg.train.checkpoint_every and epoch % cfg.train.checkpoint_every == 0:
            save_checkpoint(
                ckpt_dir, epoch, trainer.model.state_dict(),
                trainer.opt.state_dict(),
                {"epoch": epoch, "losses": trainer.epoch_losses,
                 "best_mean": best[0], "best_std": best[1],
                 "rng": trainer.rng_state()})

    out = train_evaluate_unsup(ds, cfg, trainer=trainer,
                               start_epoch=start_epoch,
                               best=(best_mean, best_std), on_epoch=on_epoch)
    best_mean, best_std = out["best_mean"], out["best_std"]
    print(f"best: {best_mean:.5f} ± {best_std:.5f}")
    return best_mean, best_std


if __name__ == "__main__":
    main()
