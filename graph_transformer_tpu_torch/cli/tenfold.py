"""10-fold cross-validation CLI — port of
``graph_transformer_tpu/cli/tenfold.py``: the paper's protocol, every fold's
best test accuracy over the epochs, then mean ± std.

    python -m graph_transformer_tpu_torch.cli.tenfold --dataset PTC \
        --batch_size 4 --ff_hidden_size 1024 --num_neighbors 16 \
        --num_epochs 50 --num_timesteps 3 --learning_rate 0.0005

By default the folds train one after another, a ``SupTrainer`` each, over
``stratified_kfold_indices(labels, 10, seed=0)``; with ``--scan_epochs``
each epoch is ``SupTrainer.train_epoch_stacked``, one replay of the
captured step a batch, as JAX's loop takes ``train_epoch_stacked``
(``--vmap_folds``, ``--cv_on_device`` and ``--shard_folds`` keep their
eager runners).  ``--vmap_folds`` trains
every fold each epoch (``train/tenfold_vmap.py``; a fold whose batch count
is the largest trains bit for bit as in the default loop), and
``--cv_on_device`` runs the whole CV with on-device batching, selection,
evaluation and plateau rule (``train/cv_ondevice.py``; its own random
streams).  ``--shard_folds N`` with ``--vmap_folds`` shards the folds over
N ranks, rank r training folds r, r + N, … (``parallel/``): launch N
processes with the ``GT_*`` variables set (``python -m
graph_transformer_tpu_torch.parallel.launch --ranks N --backend nccl --
graph_transformer_tpu_torch.cli.tenfold ... --vmap_folds --shard_folds N
--backend nccl``); each joins the group with ``--backend`` on
``cuda:{rank % device_count}``, every rank gathers every fold's
result and the first prints them.  Without a
group of N ranks it raises.  Runs on ``--device cuda`` unless given
``--device cpu``.
"""

from __future__ import annotations

import os

import numpy as np

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import load_tu_dataset
from graph_transformer_tpu_torch.parallel import bootstrap
from graph_transformer_tpu_torch.train.sup_trainer import (
    SupTrainer,
    device_tables,
)


def summary(accs) -> tuple:
    """Prints and returns the folds' mean and std."""
    mean, std = float(np.mean(accs)), float(np.std(accs))
    print(f"10-fold accuracy: {mean:.4f} ± {std:.4f}")
    return mean, std


def report(accs) -> tuple:
    for i, a in enumerate(accs):
        print(f"fold {i}: best acc {a:.4f}")
    return summary(accs)


def main(argv=None):
    parser = base_parser("10-fold CV supervised U2GNN (PyTorch/CUDA port)")
    parser.add_argument(
        "--vmap_folds", action="store_true",
        help="train every fold each epoch (TenfoldVmapRunner; on one card "
             "the folds run one after another)")
    parser.add_argument(
        "--shard_folds", default=0, type=int,
        help="with --vmap_folds: shard the folds over this many ranks "
             "(must divide 10; needs a group of that many ranks, from the "
             "GT_* variables)")
    parser.add_argument(
        "--backend", default="nccl", choices=("nccl", "gloo"),
        help="with --shard_folds: the process group's backend")
    parser.add_argument(
        "--cv_on_device", action="store_true",
        help="the whole CV with on-device graph selection, batch gather, "
             "sampling, evaluation and plateau rule (train/cv_ondevice.py); "
             "its random streams differ from the host-sampled runners'")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    ds = load_tu_dataset(cfg.data.dataset, cfg.data.degree_as_tag,
                         cfg.data.data_dir,
                         use_node_attributes=cfg.data.use_node_attributes)
    if args.cv_on_device:
        from graph_transformer_tpu_torch.train.cv_ondevice import (
            run_cv_on_device)

        accs, _, _ = run_cv_on_device(ds, cfg, device=args.device)
        return report(accs)
    if args.vmap_folds:
        from graph_transformer_tpu_torch.train.tenfold_vmap import (
            TenfoldVmapRunner)

        device = args.device
        if args.shard_folds > 1 and os.environ.get(bootstrap.ENV_PROCESS_ID):
            device = bootstrap.device_for(
                int(os.environ[bootstrap.ENV_PROCESS_ID]), args.device)
            bootstrap.initialize_from_env(args.backend, device)
        runner = TenfoldVmapRunner(ds, cfg, shard_folds=args.shard_folds,
                                   device=device)
        # every rank holds every fold's numbers; the first one prints them
        lead = runner.mesh is None or runner.mesh.rank == runner.mesh.ranks[0]
        accs, mean, std = runner.run(log_fn=print if lead else None)
        bootstrap.destroy()
        return report(accs) if lead else (mean, std)
    accs = []
    tables = device_tables(ds, cfg, args.device)
    for i, (tr, te) in enumerate(stratified_kfold_indices(ds.labels, 10,
                                                          seed=0)):
        trainer = SupTrainer(ds, cfg, tr, te, args.device, tables)
        best = 0.0
        epoch = (trainer.train_epoch_stacked if cfg.train.scan_epochs
                 else trainer.train_epoch)
        for _ in range(cfg.train.num_epochs):
            epoch()
            best = max(best, trainer.evaluate())
        accs.append(best)
        print(f"fold {i}: best acc {best:.4f}")
    return summary(accs)


if __name__ == "__main__":
    main()
