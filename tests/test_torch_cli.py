"""The port's supervised CLI (``graph_transformer_tpu_torch/cli/train_sup.py``)
on the CPU: the README quickstart's flags parse into the config, and runs on
small TU-format datasets train, evaluate and write their accuracy file, on
the two-pass path, which every CLI command takes as in the JAX CLI (one-hot
tags, wide degree tags, two U2GNN layers, continuous node attributes, the
per-layer flags)."""

import numpy as np
import pytest

from graph_transformer_tpu_torch.cli import train_sup
from graph_transformer_tpu_torch.cli.common import base_parser, config_from_args

README_FLAGS = ["--dataset", "IMDBBINARY", "--batch_size", "4",
                "--ff_hidden_size", "1024", "--num_neighbors", "8",
                "--num_epochs", "50", "--num_timesteps", "4",
                "--learning_rate", "0.0005", "--scan_epochs"]


def test_readme_flags_parse():
    args = base_parser("t").parse_args(README_FLAGS)
    cfg = config_from_args(args)
    assert args.device == "cuda"
    assert (cfg.data.dataset, cfg.data.batch_size, cfg.data.num_neighbors) \
        == ("IMDBBINARY", 4, 8)
    assert (cfg.model.ff_hidden_size, cfg.model.num_timesteps) == (1024, 4)
    assert (cfg.train.num_epochs, cfg.train.learning_rate,
            cfg.train.scan_epochs) == (50, 0.0005, True)


def test_two_pass_flags_parse():
    args = base_parser("t").parse_args(
        ["--num_hidden_layers", "2", "--degree_as_tag",
         "--use_node_attributes"])
    cfg = config_from_args(args)
    assert cfg.model.num_hidden_layers == 2
    assert cfg.data.degree_as_tag is True and cfg.data.use_node_attributes
    # without the flag the dataset decides (degree tags for COLLAB/IMDB*)
    assert config_from_args(base_parser("t").parse_args([])) \
        .data.degree_as_tag is None


def test_per_layer_flags_parse():
    """The JAX CLI's choices and defaults (``cli/common.py:49-57``)."""
    cfg = config_from_args(base_parser("t").parse_args([]))
    assert (cfg.model.recurrence, cfg.model.attention_axis,
            cfg.model.share_timestep_weights) == ("basic", "neighborhood",
                                                  False)
    cfg = config_from_args(base_parser("t").parse_args(
        ["--recurrence", "dwa", "--attention_axis", "node",
         "--share_timestep_weights"]))
    assert (cfg.model.recurrence, cfg.model.attention_axis,
            cfg.model.share_timestep_weights) == ("dwa", "node", True)
    for bad in (["--recurrence", "rnn"], ["--attention_axis", "edge"],
                ["--num_heads", "2"]):
        with pytest.raises(SystemExit):
            base_parser("t").parse_args(bad)


@pytest.mark.parametrize("flag", [["--use_pallas"], ["--host_sampling"],
                                  ["--whole_encoder"]])
def test_flags_of_unported_paths_are_refused(flag):
    """These three flags parse into their config fields, as the JAX CLI
    sets them (``cli/common.py:109-113``): ``--use_pallas`` into
    ``use_pallas``, ``--whole_encoder`` into ``use_pallas_whole_encoder``,
    ``--host_sampling`` into ``on_device_sampling=False``; without them the
    fields keep their defaults.  (Until slice 14 the first two were refused;
    the name is kept.)  Neither of the first two changes a CLI run's path:
    the fused gate also needs ``use_fused_sampler``, which no CLI sets."""
    from graph_transformer_tpu_torch.train.sup_trainer import fused_gate_ok

    cfg = config_from_args(base_parser("t").parse_args(README_FLAGS + flag))
    plain = config_from_args(base_parser("t").parse_args(README_FLAGS))
    field = {"--use_pallas": ("model", "use_pallas", True),
             "--whole_encoder": ("model", "use_pallas_whole_encoder", True),
             "--host_sampling": ("train", "on_device_sampling", False)}
    part, name, value = field[flag[0]]
    assert getattr(getattr(cfg, part), name) is value
    assert getattr(getattr(plain, part), name) is (not value)
    assert not fused_gate_ok(cfg.model)


JAX_FLAG_CASES = [[], README_FLAGS, ["--sampled_num", "64"],
                  ["--num_sampled", "32"], ["--dropout", "0.3"],
                  ["--compute_dtype", "bfloat16"], ["--use_pallas"],
                  ["--whole_encoder"], ["--checkpoint_dir", "ckpt"],
                  ["--checkpoint_every", "3"], ["--resume"],
                  ["--eval_every", "2"]]


@pytest.mark.parametrize("argv", JAX_FLAG_CASES,
                         ids=lambda a: "-".join(a[:1]) or "defaults")
def test_flags_match_jax_config(argv):
    """Each flag the port took over from the JAX CLI (and the README's
    command line, and no flag): the port's parse and config equal JAX's
    ``config_from_args`` on the same argv, field by field; the port's
    namespace has JAX's keys and ``device``."""
    import dataclasses

    from graph_transformer_tpu.cli.common import base_parser as jax_parser
    from graph_transformer_tpu.cli.common import (
        config_from_args as jax_config)

    args, jargs = base_parser("t").parse_args(argv), \
        jax_parser("t").parse_args(argv)
    assert set(vars(args)) == set(vars(jargs)) | {"device"}
    assert {k: v for k, v in vars(args).items() if k != "device"} == \
        vars(jargs)
    cfg, jcfg = config_from_args(args), jax_config(jargs)
    for part in ("data", "model", "train", "parallel"):
        assert dataclasses.asdict(getattr(cfg, part)) == \
            dataclasses.asdict(getattr(jcfg, part)), part


def test_every_jax_flag_parses():
    """The port's parser knows every option string of JAX's."""
    from graph_transformer_tpu.cli.common import base_parser as jax_parser

    port = set(base_parser("t")._option_string_actions)
    assert set(jax_parser("t")._option_string_actions) <= port


def _write_tu(root, name, num_graphs=20, seed=0):
    """A TU text file: per graph ``n label``, then per node
    ``tag degree neighbors...``."""
    rng = np.random.default_rng(seed)
    lines = [str(num_graphs)]
    for g in range(num_graphs):
        n = int(rng.integers(5, 10))
        adj = [set() for _ in range(n)]
        for j in range(1, n):  # a random tree plus one chord
            k = int(rng.integers(0, j))
            adj[j].add(k)
            adj[k].add(j)
        adj[0].add(n - 1)
        adj[n - 1].add(0)
        lines.append(f"{n} {g % 2}")
        for j in range(n):
            nb = sorted(adj[j])
            lines.append(" ".join(map(str, [int(rng.integers(0, 3)), len(nb),
                                            *nb])))
    d = root / name
    d.mkdir()
    (d / f"{name}.txt").write_text("\n".join(lines) + "\n")


def test_train_sup_cli_runs_on_cpu(tmp_path):
    _write_tu(tmp_path, "TINY")
    acc = train_sup.main([
        "--dataset", "TINY", "--data_dir", str(tmp_path), "--batch_size", "4",
        "--ff_hidden_size", "16", "--num_neighbors", "3", "--num_epochs", "2",
        "--num_timesteps", "2", "--learning_rate", "0.005",
        "--run_folder", str(tmp_path / "runs"), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    lines = (tmp_path / "runs" / "TINY_sup_fold0" / "model_acc.txt") \
        .read_text().splitlines()
    assert [ln.split()[:4] for ln in lines] == [
        ["epoch", "1", "fold", "0"], ["epoch", "2", "fold", "0"]]


def test_train_sup_cli_takes_the_wide_path_on_imdb_like_data(tmp_path,
                                                              monkeypatch):
    """The README quickstart's dataset name forces degree tags, so an
    IMDBBINARY-like file gives one-hot rows past D=32.  The CLI, like the
    JAX CLI, cannot set ``use_fused_sampler``, so training takes the wide
    two-pass path (plain K7, K4tw and K8w/K8ws here) on float32 rows, once a
    step, and never a fused kernel."""
    import sys
    from pathlib import Path

    import torch

    from graph_transformer_tpu_torch.data.tu import load_tu_dataset
    from graph_transformer_tpu_torch.models import u2gnn_sup

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.write_imdb_like_tu(tmp_path, num_graphs=100)
    ds = load_tu_dataset("IMDBBINARY", data_dir=str(tmp_path))
    assert ds.feature_dim > 32
    calls = _spy_paths(monkeypatch)
    dtypes = set()
    encode = u2gnn_sup.u2gnn_train_encoder

    def spy(x2d, *a, **k):
        dtypes.add((x2d.dtype, x2d.shape[1]))
        return encode(x2d, *a, **k)

    monkeypatch.setattr(u2gnn_sup, "u2gnn_train_encoder", spy)
    acc = train_sup.main([
        "--dataset", "IMDBBINARY", "--data_dir", str(tmp_path),
        "--batch_size", "4", "--ff_hidden_size", "16", "--num_neighbors",
        "8", "--num_epochs", "1", "--num_timesteps", "2",
        "--learning_rate", "0.0005", "--scan_epochs",
        "--run_folder", str(tmp_path / "runs"), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    assert calls["fused"] == 0 and calls["sample"] == 23
    assert dtypes == {(torch.float32, ds.feature_dim)}


def _spy_paths(monkeypatch):
    """Count the calls of the two-pass path's sampler and encoder and of the
    fused paths' forwards."""
    from graph_transformer_tpu_torch.models import u2gnn_sup
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.train import sup_trainer

    calls = {"sample": 0, "two_pass": 0, "fused": 0}

    def spy(name, mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)

    spy("sample", sup_trainer, "sample_neighborhoods")
    spy("two_pass", u2gnn_sup, "u2gnn_train_encoder")
    spy("fused", se, "sampled_forward")
    spy("fused", st, "stored_forward")
    spy("fused", fs, "fused_sampled_forward")
    return calls


@pytest.mark.parametrize("case", ["num_hidden_layers", "node_attributes"])
def test_train_sup_cli_takes_the_two_pass_path(tmp_path, monkeypatch, capsys,
                                               case):
    """Two U2GNN layers with degree tags (the MUTAG HPO arm's flags, cut to
    CPU size), or continuous node attributes from a sidecar file: training
    goes through the sampler and the two-pass encoder, once per U2GNN layer
    a step, never through the fused kernels; the epoch losses are finite."""
    import re
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    if case == "num_hidden_layers":
        _write_tu(tmp_path, "TINY")
        flags, k = ["--dataset", "TINY", "--num_hidden_layers", "2",
                    "--degree_as_tag"], 2
    else:
        chip_smoke.write_tu_like(tmp_path, "ATTR", 30, 8, 9, 3, 2,
                                 attr_dim=3)
        flags, k = ["--dataset", "ATTR", "--use_node_attributes"], 1
    calls = _spy_paths(monkeypatch)
    acc = train_sup.main(flags + [
        "--data_dir", str(tmp_path), "--batch_size", "4",
        "--ff_hidden_size", "16", "--num_neighbors", "3",
        "--num_epochs", "2", "--num_timesteps", "2",
        "--run_folder", str(tmp_path / "runs"), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    losses = [float(v) for v in
              re.findall(r"\| loss\s+(\S+) \|", capsys.readouterr().out)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert calls["fused"] == 0 and calls["sample"] > 0
    assert calls["two_pass"] == k * calls["sample"]


@pytest.mark.parametrize("flags,per_layer", [
    (["--recurrence", "act"], True),
    (["--attention_axis", "node"], True),
    (["--share_timestep_weights"], False)],
    ids=["act", "node", "tied"])
def test_train_sup_cli_per_layer_flags(tmp_path, monkeypatch, capsys, flags,
                                       per_layer):
    """Each new flag trains on a tiny TU file on the CPU: ACT and the node
    axis through the sampler and the per-layer encoder (never the fused or
    the whole-encoder kernels), tied timesteps through the sampler and the
    two-pass whole encoder with one stored layer (the CLI never takes the
    fused path); finite epoch losses."""
    import re

    from graph_transformer_tpu_torch.models import u2gnn_sup

    _write_tu(tmp_path, "TINY")
    calls = _spy_paths(monkeypatch)
    calls["per_layer"] = 0
    fn = u2gnn_sup.neighborhood_encoder

    def spy(*a, **k):
        calls["per_layer"] += 1
        return fn(*a, **k)

    monkeypatch.setattr(u2gnn_sup, "neighborhood_encoder", spy)
    acc = train_sup.main(flags + [
        "--dataset", "TINY", "--data_dir", str(tmp_path), "--batch_size",
        "4", "--ff_hidden_size", "16", "--num_neighbors", "3",
        "--num_epochs", "2", "--num_timesteps", "2",
        "--run_folder", str(tmp_path / "runs"), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    losses = [float(v) for v in
              re.findall(r"\| loss\s+(\S+) \|", capsys.readouterr().out)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if per_layer:
        assert calls["fused"] == calls["two_pass"] == 0
        assert calls["sample"] > 0 and calls["per_layer"] > calls["sample"]
    else:
        assert calls["fused"] == calls["per_layer"] == 0
        assert calls["sample"] == calls["two_pass"] > 0
