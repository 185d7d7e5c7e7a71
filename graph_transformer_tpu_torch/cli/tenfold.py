"""10-fold cross-validation CLI — port of
``graph_transformer_tpu/cli/tenfold.py``: the paper's protocol, every fold's
best test accuracy over the epochs, then mean ± std.

    python -m graph_transformer_tpu_torch.cli.tenfold --dataset PTC \
        --batch_size 4 --ff_hidden_size 1024 --num_neighbors 16 \
        --num_epochs 50 --num_timesteps 3 --learning_rate 0.0005

By default the folds train one after another, a ``SupTrainer`` each, over
``stratified_kfold_indices(labels, 10, seed=0)``.  ``--vmap_folds`` trains
every fold each epoch (``train/tenfold_vmap.py``; a fold whose batch count
is the largest trains bit for bit as in the default loop), and
``--cv_on_device`` runs the whole CV with on-device batching, selection,
evaluation and plateau rule (``train/cv_ondevice.py``; its own random
streams).  ``--shard_folds`` above 1 raises: the parallel layer is not
ported.  Runs on ``--device cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import numpy as np

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import load_tu_dataset
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
        help="with --vmap_folds: shard the folds over this many devices "
             "(must divide 10; not ported yet, so above 1 it raises)")
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

        runner = TenfoldVmapRunner(ds, cfg, shard_folds=args.shard_folds,
                                   device=args.device)
        accs, _, _ = runner.run()
        return report(accs)
    accs = []
    tables = device_tables(ds, cfg, args.device)
    for i, (tr, te) in enumerate(stratified_kfold_indices(ds.labels, 10,
                                                          seed=0)):
        trainer = SupTrainer(ds, cfg, tr, te, args.device, tables)
        best = 0.0
        for _ in range(cfg.train.num_epochs):
            trainer.train_epoch()
            best = max(best, trainer.evaluate())
        accs.append(best)
        print(f"fold {i}: best acc {best:.4f}")
    return summary(accs)


if __name__ == "__main__":
    main()
