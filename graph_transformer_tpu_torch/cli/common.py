"""Shared CLI argument surface — port of
``graph_transformer_tpu/cli/common.py``.

Every flag of the JAX CLI (``cli/common.py:26-77``), with its name, default
and config field, plus ``--device`` (default ``cuda``).  As in JAX,
``--use_pallas`` and ``--whole_encoder`` only set their fields: the fused
path's gate also needs ``use_fused_sampler``, which no CLI sets, so every CLI
run trains on the two-pass path (``train/sup_trainer.fused_gate_ok``).
``--sampled_num`` sets the unsupervised models' candidate count
(``cli/train_unsup.py``), and ``--scan_epochs`` trains each epoch as JAX's
one-dispatch epoch: ``train_epoch_stacked``, one replay of a captured CUDA
graph a step on the card (``train/step_graph.py``), the same step run
eagerly over the same buffers on the CPU.
"""

from __future__ import annotations

import argparse

from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--run_folder", default="runs", help="output root")
    p.add_argument("--dataset", default="PTC", help="TU dataset name")
    p.add_argument("--learning_rate", default=0.0005, type=float)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--num_epochs", default=50, type=int)
    p.add_argument("--model_name", default=None, help="run name (default: auto)")
    p.add_argument("--sampled_num", "--num_sampled", dest="sampled_num",
                   default=512, type=int,
                   help="sampled-softmax candidates (unsupervised models)")
    p.add_argument("--dropout", default=0.5, type=float,
                   help="head dropout (the encoder's is 0.5, as in the "
                        "reference)")
    p.add_argument("--num_hidden_layers", default=1, type=int,
                   help="k: stacked U2GNN layers")
    p.add_argument("--num_timesteps", default=1, type=int,
                   help="T: self-attention layers per U2GNN layer")
    p.add_argument("--ff_hidden_size", default=1024, type=int)
    p.add_argument("--num_neighbors", default=4, type=int)
    p.add_argument("--fold_idx", default=0, type=int, help="0-9")
    p.add_argument("--degree_as_tag", action="store_true",
                   help="node degrees as the one-hot tags")
    p.add_argument("--use_node_attributes", action="store_true",
                   help="use <dataset>_node_attributes.txt sidecar features")
    p.add_argument("--data_dir", default=None, help="TU dataset root")
    p.add_argument("--seed", default=123, type=int)
    p.add_argument("--attention_axis", default="neighborhood",
                   choices=["neighborhood", "node"],
                   help="'node' reproduces the PyTorch reference's axis quirk")
    p.add_argument("--share_timestep_weights", action="store_true",
                   help="Universal-Transformer weight tying across timesteps")
    p.add_argument("--recurrence", default="basic",
                   choices=["basic", "skip", "highway", "gru", "lstm", "dwa",
                            "act"],
                   help="UT transition function between timesteps "
                        "(non-basic implies weight tying)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas", action="store_true",
                   help="sets ModelConfig.use_pallas (the fused path also "
                        "needs use_fused_sampler, which no CLI sets)")
    p.add_argument("--whole_encoder", action="store_true",
                   help="sets ModelConfig.use_pallas_whole_encoder")
    p.add_argument("--scan_epochs", action="store_true",
                   help="train each epoch's batches, built first and "
                        "stacked on the device, by replaying one captured "
                        "CUDA graph a step (eagerly on the CPU)")
    p.add_argument("--host_sampling", action="store_true",
                   help="sample neighborhoods on host instead of on device")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", default=0, type=int,
                   help="epochs between checkpoints (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in checkpoint_dir")
    p.add_argument("--eval_every", default=1, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels) or cpu (plain versions)")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(
            dataset=args.dataset,
            data_dir=args.data_dir,
            degree_as_tag=args.degree_as_tag or None,
            use_node_attributes=args.use_node_attributes,
            fold_idx=args.fold_idx,
            batch_size=args.batch_size,
            num_neighbors=args.num_neighbors,
            seed=args.seed,
        ),
        model=ModelConfig(
            ff_hidden_size=args.ff_hidden_size,
            num_timesteps=args.num_timesteps,
            num_hidden_layers=args.num_hidden_layers,
            dropout=args.dropout,
            sampled_num=args.sampled_num,
            attention_axis=args.attention_axis,
            share_timestep_weights=args.share_timestep_weights,
            recurrence=args.recurrence,
            compute_dtype=args.compute_dtype,
            use_pallas=args.use_pallas,
            use_pallas_whole_encoder=args.whole_encoder,
        ),
        train=TrainConfig(
            learning_rate=args.learning_rate,
            num_epochs=args.num_epochs,
            eval_every=args.eval_every,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            seed=args.seed,
            on_device_sampling=not args.host_sampling,
            scan_epochs=args.scan_epochs,
        ),
        parallel=ParallelConfig(),
    )
