"""Single-graph node-classification CLI — port of
``graph_transformer_tpu/cli/train_node.py``.

    python -m graph_transformer_tpu_torch.cli.train_node \
        --node_dataset cora --citation_dir <Planetoid dir> \
        --num_epochs 20 --eval_every 5 --device cuda

Trains U2GNN (the fork's cross-attention head), or the GCN / GAT baseline
(``--node_model gcn|gat``), transductively over one graph (karate, the
synthetic SBM, a Planetoid citation graph, PPI, or ``npz:<path>``) with the
sampled-softmax, GAE or contrastive loss, and evaluates the node embeddings
by a train/test-mask logistic probe, a 2-fold logistic probe or k-means
clustering metrics.  The flags are the JAX CLI's (``cli/common.py`` plus the
node flags) and ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.citation import (
    NODE_DATASETS,
    load_node_dataset,
    load_npz,
)
from graph_transformer_tpu_torch.train.node_trainer import train_evaluate_node


def parser():
    p = base_parser("U2GNN single-graph node classification (PyTorch/CUDA "
                    "port)")
    p.add_argument("--node_dataset", default="karate",
                   help=f"one of {sorted(NODE_DATASETS)}, or npz:<path>")
    p.add_argument("--citation_dir", default=None,
                   help="directory with Planetoid ind.<name>.* files")
    p.add_argument("--node_model", default="u2gnn",
                   choices=["u2gnn", "gcn", "gat"])
    p.add_argument("--loss_type", default="default",
                   choices=["default", "gae", "contrastive"])
    p.add_argument("--sampler_type", default="default",
                   choices=["default", "neighbor"])
    p.add_argument("--eval_mode", default="masks",
                   choices=["masks", "2fold", "kmeans"])
    p.add_argument("--save_embeddings", default=None, help=".npy path")
    return p


def load(args):
    """The dataset the node flags name."""
    if args.node_dataset.startswith("npz:"):
        return load_npz(args.node_dataset[4:])
    kw = {}
    if (args.node_dataset in ("cora", "citeseer", "pubmed")
            and args.citation_dir):
        kw["data_dir"] = args.citation_dir
    return load_node_dataset(args.node_dataset, **kw)


def experiment_config(args):
    """The run's configuration: the common flags' and the node model's."""
    cfg = config_from_args(args)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, model=args.node_model, loss_type=args.loss_type,
        sampler_type=args.sampler_type))


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = experiment_config(args)
    ds = load(args)
    print(f"# node data: {ds.name}, {ds.num_nodes} nodes, "
          f"{ds.graph.num_directed_edges} directed edges, "
          f"{ds.num_classes} classes, feature dim {ds.feature_dim}")
    out = train_evaluate_node(ds, cfg, eval_mode=args.eval_mode,
                              device=args.device)
    print(f"best {args.eval_mode} metric: {out['best_metric']:.4f}")
    if args.save_embeddings:
        emb = out["trainer"].node_embeddings()
        os.makedirs(os.path.dirname(os.path.abspath(args.save_embeddings)),
                    exist_ok=True)
        np.save(args.save_embeddings, emb)
        print(f"saved embeddings to {args.save_embeddings}")
    return out["best_metric"]


if __name__ == "__main__":
    main()
