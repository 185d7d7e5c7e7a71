"""Multiplex node classification / clustering CLI — port of
``graph_transformer_tpu/cli/node_classification.py``.

    python -m graph_transformer_tpu_torch.cli.node_classification \
        --ml_dataset uci_mfeat --ml_data_path <mfeat dir> \
        --loss_type contrastive --ml_model_type siamese --eval_mode kmeans \
        --spectral_baselines --num_epochs 20 --eval_every 5 --device cuda

Trains the siamese/multi U2GNN on a multiplex dataset
(``data/multiplex.MULTIPLEX_LOADERS``), evaluates by k-means clustering or a
logistic probe, optionally runs the arithmetic- and geometric-mean
Laplacian spectral baselines, and saves the embeddings as ``.npy``.  The
flags are the JAX CLI's (``cli/common.py`` and the multiplex flags) and
``--device`` (default ``cuda``); the printout is the JAX CLI's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.multiplex import (
    MULTIPLEX_LOADERS,
    load_multiplex,
)
from graph_transformer_tpu_torch.train.ml_node_trainer import (
    train_evaluate_multiplex,
)


def parser():
    p = base_parser("U2GNN multiplex node classification (PyTorch/CUDA "
                    "port)")
    p.add_argument("--ml_dataset", default="gaussian",
                   help=f"one of {sorted(MULTIPLEX_LOADERS)}")
    p.add_argument("--ml_data_path", default=None,
                   help="file/folder for file-based multiplex loaders")
    p.add_argument("--loss_type", default="contrastive",
                   choices=["contrastive", "gae"])
    p.add_argument("--ml_model_type", default="siamese",
                   choices=["siamese", "multi"])
    p.add_argument("--projection_dim", default=-1, type=int)
    p.add_argument("--eval_mode", default="kmeans",
                   choices=["kmeans", "logistic"])
    p.add_argument("--size_x", default=8, type=int,
                   help="feature dimension for the multiplex loaders")
    p.add_argument("--spectral_baselines", action="store_true")
    p.add_argument("--save_embeddings", default=None, help=".npy path")
    return p


def loader_kwargs(args) -> dict:
    """The loader's keyword arguments that the flags name."""
    if args.ml_dataset == "gaussian":
        return {"size_x": args.size_x, "seed": 100}
    if not args.ml_data_path:
        return {}
    if args.ml_dataset in ("leskovec_ng_mat", "uci_mfeat"):
        key = "data_folder"
    elif args.ml_dataset == "vickers_chan":
        key = "edges_path"
    elif args.ml_dataset == "mat_multiview":
        key = "mat_path"
    else:
        key = "data_path"
    return {key: args.ml_data_path, "size_x": args.size_x}


def experiment_config(args):
    """The run's configuration: the common flags' and the multiplex
    model's."""
    cfg = config_from_args(args)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, loss_type=args.loss_type,
        ml_model_type=args.ml_model_type,
        projection_dim=args.projection_dim))


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = experiment_config(args)
    ds = load_multiplex(args.ml_dataset, **loader_kwargs(args))
    print(f"# multiplex data: {ds.num_nodes} nodes, {ds.num_views} views, "
          f"{ds.num_classes} classes, feature dim {ds.feature_dim}")
    out = train_evaluate_multiplex(ds, cfg, eval_mode=args.eval_mode,
                                   device=args.device)
    print(f"best {args.eval_mode} metric: {out['best_metric']:.4f}")
    if args.spectral_baselines:
        for name, metrics in out["trainer"].spectral_baselines().items():
            print(f"spectral[{name}]: " + ", ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
    if args.save_embeddings:
        emb = out["trainer"].node_embeddings()
        os.makedirs(os.path.dirname(os.path.abspath(args.save_embeddings)),
                    exist_ok=True)
        np.save(args.save_embeddings, emb)
        print(f"saved embeddings to {args.save_embeddings}")
    return out["best_metric"]


if __name__ == "__main__":
    main()
