#!/usr/bin/env python3
"""Does each main path of the PyTorch port repeat bit for bit on the card?

    python3 scripts/torch_determinism_probe.py

For each main path of ``chip_smoke.py`` (the bench workload on K1-K3 and on
K13, the README quickstart two-pass and on K5/K6, the MUTAG HPO arm, ACT,
the node axis, the README's 10-fold command), three training steps and an
evaluation run twice from the same seeds, and the parameters and losses are
compared bit for bit; then again under
``torch.use_deterministic_algorithms(True, warn_only=True)``, printing every
determinism warning.  Last, the 10-fold path with the pooling swapped for
``index_add_`` (the port's pooling up to slice 13), five steps twice, three
tries, with the largest difference per parameter.  Builds the kernels it
needs first (``ops/_build.build_all``); needs one card.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def two_runs(ds, cfg, steps: int):
    """(equal bit for bit, max |difference| per parameter) of two runs of
    ``steps`` training steps and an evaluation."""
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    runs = []
    for _ in range(2):
        t = SupTrainer(ds, cfg, device="cuda")
        losses = t.train_steps(t.builder.sample(), steps)
        t.evaluate()
        runs.append([p.detach().clone() for p in t.model.parameters()]
                    + [losses.float()])
    torch.cuda.synchronize()
    diff = [float((a - b).abs().max()) for a, b in zip(*runs)]
    return all(torch.equal(a, b) for a, b in zip(*runs)), diff[:-1]


def probe(label, ds, cfg, deterministic: bool, steps: int = 3) -> bool:
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            equal, diff = two_runs(ds, cfg, steps)
    finally:
        torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).splitlines()[0][:200] for w in caught
                   if "determinis" in str(w.message).lower()})
    print(f"# {label} (deterministic mode {deterministic}): two runs of "
          f"{steps} steps equal bit for bit {equal}; max |diff| per "
          f"parameter {[f'{d:.2e}' for d in diff] if not equal else 0}; "
          f"{len(msgs)} determinism warnings", flush=True)
    for m in msgs:
        print(f"#   WARN {m}", flush=True)
    return equal


def pool_index_add(node_vec, graph_id, num_graphs):
    pooled = torch.zeros(num_graphs + 1, node_vec.shape[1],
                         dtype=node_vec.dtype, device=node_vec.device)
    pooled.index_add_(0, graph_id.to(torch.int64), node_vec)
    return pooled[:num_graphs]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from graph_transformer_tpu_torch.cli.common import (
        base_parser, config_from_args)
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import (
        load_tu_dataset, synthetic_powerlaw_dataset)
    from graph_transformer_tpu_torch.models import u2gnn_sup
    from graph_transformer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    print(f"# build: {_build.build_all():.1f} s", flush=True)
    data = os.path.join(ROOT, "build", "determinism", "data")
    cs.write_imdb_like_tu(data)
    cs.write_mutag_like_tu(data)
    cs.write_ptc_like_tu(data)
    imdb = load_tu_dataset("IMDBBINARY", data_dir=data)
    mutag = load_tu_dataset("MUTAG", data_dir=data, degree_as_tag=True)
    mutag_tags = load_tu_dataset("MUTAG", data_dir=data)
    ptc = load_tu_dataset("PTC", data_dir=data)
    bench = synthetic_powerlaw_dataset("REDDITMULTI5K-like", num_graphs=64,
                                       mean_nodes=509, seed=0)

    def cli(flags, **kw):
        cfg = config_from_args(base_parser("p").parse_args(flags))
        return cfg.replace(model=dataclasses.replace(cfg.model, **kw))

    def bench_cfg(**kw):
        return ExperimentConfig(
            data=DataConfig(batch_size=cs.BATCH, num_neighbors=cs.K),
            model=ModelConfig(num_timesteps=cs.T, ff_hidden_size=cs.FF,
                              compute_dtype="bfloat16", **cs.FUSED_FLAGS,
                              **kw),
            train=TrainConfig(num_epochs=1))

    paths = [
        ("bench K1-K3", bench, bench_cfg(use_folded=True)),
        ("bench K13", bench, bench_cfg()),
        ("quickstart two-pass", imdb, cli(cs.QUICKSTART_FLAGS)),
        ("quickstart K5/K6", imdb, cli(cs.QUICKSTART_FLAGS,
                                       use_stored_bwd=True,
                                       **cs.FUSED_FLAGS)),
        ("HPO arm", mutag, cli(cs.TWO_PASS_FLAGS["MUTAG"])),
        ("ACT", mutag_tags, cli(cs.PER_LAYER_FLAGS["act"])),
        ("node axis", imdb, cli(cs.PER_LAYER_FLAGS["node"])),
        ("10-fold", ptc, cs.cv_config(1)),
    ]
    ok = True
    for label, ds, cfg in paths:
        for det in (False, True):
            ok &= probe(label, ds, cfg, det)
    u2gnn_sup.graph_sum_pool = pool_index_add
    for i in range(3):
        probe(f"10-fold with index_add_ pooling, try {i}", ptc,
              cs.cv_config(1), False, steps=5)
    probe("10-fold with index_add_ pooling", ptc, cs.cv_config(1), True,
          steps=5)
    print(f"# every main path repeats: {ok}; "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
