"""HPO CLI: tune U2GNN hyperparameters — port of
``graph_transformer_tpu/cli/hpo.py``.

    python -m graph_transformer_tpu_torch.cli.hpo --dataset IMDBBINARY \
        --total_trials 20 --device cuda
    python -m graph_transformer_tpu_torch.cli.hpo --pipeline node \
        --node_dataset cora --device cuda

Two pipelines, mirroring the reference's two Ax notebooks, with JAX's flags
and search space (``cli/hpo.py:26-115``) and ``--device`` (default
``cuda``):

- ``--pipeline unsup`` (default): unsupervised graph embeddings on a TU
  dataset (``find_best_hyperparams_for_dataset.ipynb`` cell 7:
  num_timesteps, num_hidden_layers, sampled_num, log-scale learning_rate);
  each trial trains an ``UnsupTrainer`` for ``--trial_epochs`` epochs and
  scores the best 10-fold logistic accuracy of its embeddings.
- ``--pipeline node``: the single-graph node-embedding pipeline
  (``node_embedding_HPO.ipynb``) on ``NodeTrainer`` (``--node_model
  u2gnn|gcn|gat``), ``sampled_num`` clamped to half the node count; the
  objective is the best mask probe (``--node_eval masks``) or 2-fold probe.
  Planetoid files are read from ``$GT_TPU_CITATION``, as JAX's loader does.

The search is ``exp/hpo.optimize`` (GP-EI after scrambled-Halton trials);
``--results_json`` writes the best arm and every trial.
"""

from __future__ import annotations

import dataclasses
import json
import os

from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args
from graph_transformer_tpu_torch.data.tu import load_tu_dataset
from graph_transformer_tpu_torch.exp.hpo import best_arm, optimize
from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

SPACE = [
    {"name": "num_timesteps", "type": "range", "bounds": [1, 6]},
    {"name": "num_hidden_layers", "type": "range", "bounds": [1, 3]},
    {"name": "sampled_num", "type": "choice", "values": [128, 256, 512]},
    {"name": "learning_rate", "type": "range", "bounds": [1e-5, 1e-2],
     "log_scale": True},
]


def parser():
    p = base_parser("HPO for U2GNN embeddings (unsup TU / node pipeline; "
                    "PyTorch/CUDA port)")
    p.add_argument("--total_trials", default=15, type=int)
    p.add_argument("--trial_epochs", default=5, type=int,
                   help="epochs per HPO trial")
    p.add_argument("--results_json", default=None)
    p.add_argument("--pipeline", default="unsup", choices=["unsup", "node"])
    p.add_argument("--node_dataset", default="cora",
                   help="node pipeline: dataset name (data/citation.py)")
    p.add_argument("--node_model", default="u2gnn",
                   choices=["u2gnn", "gcn", "gat"])
    p.add_argument("--node_eval", default="masks",
                   choices=["masks", "2fold"])
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    base_cfg = config_from_args(args)

    def trial_cfg(cfg, params):
        return cfg.replace(
            model=dataclasses.replace(
                cfg.model,
                num_timesteps=int(params["num_timesteps"]),
                num_hidden_layers=int(params["num_hidden_layers"]),
                sampled_num=int(params["sampled_num"]),
            ),
            train=dataclasses.replace(
                cfg.train,
                learning_rate=float(params["learning_rate"]),
                num_epochs=args.trial_epochs,
            ),
        )

    if args.pipeline == "node":
        from graph_transformer_tpu_torch.data.citation import load_node_dataset
        from graph_transformer_tpu_torch.train.node_trainer import NodeTrainer

        node_ds = load_node_dataset(args.node_dataset)
        node_cfg = base_cfg.replace(
            model=dataclasses.replace(base_cfg.model, model=args.node_model))

        def evaluate(params):
            # vocab = node count on a single graph; clamp the candidate count
            params = dict(params, sampled_num=min(
                int(params["sampled_num"]), node_ds.num_nodes // 2))
            trainer = NodeTrainer(node_ds, trial_cfg(node_cfg, params),
                                  device=args.device)
            best = 0.0
            for _ in range(args.trial_epochs):
                trainer.train_epoch()
                metric = (trainer.evaluate_masks()
                          if args.node_eval == "masks"
                          else trainer.evaluate_2fold())
                best = max(best, metric)
            return best

    else:
        data = base_cfg.data
        ds = load_tu_dataset(data.dataset, data.degree_as_tag, data.data_dir)

        def evaluate(params):
            trainer = UnsupTrainer(ds, trial_cfg(base_cfg, params),
                                   device=args.device)
            best = 0.0
            for _ in range(args.trial_epochs):
                trainer.train_epoch()
                mean, _ = trainer.evaluate()
                best = max(best, mean)
            return best

    best_params, best_value, trials = optimize(
        SPACE, evaluate, total_trials=args.total_trials,
        objective_name="accuracy", seed=base_cfg.train.seed,
    )
    print(f"best accuracy {best_value:.5f} with {best_params}")
    if args.results_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.results_json)),
                    exist_ok=True)
        with open(args.results_json, "w") as f:
            json.dump({"best": best_arm(trials, "accuracy"),
                       "trials": trials}, f, indent=2)
    return best_params, best_value


if __name__ == "__main__":
    main()
