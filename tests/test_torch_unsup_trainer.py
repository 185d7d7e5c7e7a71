"""The port's unsupervised trainer, probe and CLI on the CPU
(``train/unsup_trainer.py``, ``train/evaluate.py``,
``cli/train_unsup.py``): training lowers the loss, the probe against
sklearn's on the same embeddings, the CLI's flags against the JAX CLI's
config, its accuracy file, ``--resume`` against a straight run, and both
CLIs' best means on a file with learnable labels."""

import dataclasses
import functools
import json
import re
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_transformer_tpu.native.batcher as jax_native
from graph_transformer_tpu.cli import train_unsup as jax_cli
from graph_transformer_tpu.train import evaluate as jax_eval
from graph_transformer_tpu_torch.cli import train_unsup
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data import batching as tbatching
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.train import evaluate, unsup_trainer
from graph_transformer_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
)
from graph_transformer_tpu_torch.train.unsup_trainer import (
    UnsupTrainer,
    train_evaluate_unsup,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while these tests train on the CPU: the steps'
    small parallel kernels (Adam over the output table) wait on every
    thread of the pool, and under the parallel workers of a whole test run
    that made the CLI runs 20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(**model):
    return ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=3),
        model=ModelConfig(num_timesteps=1, ff_hidden_size=16, sampled_num=32,
                          **model),
        train=TrainConfig(num_epochs=4, learning_rate=5e-3))


def small_ds():
    return synthetic_powerlaw_dataset("S", num_graphs=24, num_classes=2,
                                      mean_nodes=10, seed=2,
                                      reddit_like=False)


@pytest.mark.parametrize("model", [
    {}, dict(num_hidden_layers=2, sampled_softmax_mode="reference"),
    dict(id_symmetric=True), dict(sampler_type="neighbor")])
def test_trainer_loss_falls(model, numpy_builders):
    """Finite epoch losses, the last below the first; a probe in [0, 1].
    On the numpy builders' draws, as the test was set: an epoch's loss sums
    six random subsets of graphs of unequal sizes, and on the C++
    assembler's draws JAX's own trainer reads a last epoch above the first
    in each of the first three models (e.g. 858.9, 692.0, 747.1, 887.5)."""
    out = train_evaluate_unsup(small_ds(), small_cfg(**model),
                               log_fn=lambda s: None, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert 0.0 <= out["best_mean"] <= 1.0
    t = out["trainer"]
    assert not t.fused and (t.csr is not None) == bool(model.get(
        "sampler_type"))
    mean, std = t.evaluate()
    assert 0.0 <= mean <= 1.0 and std >= 0.0


def test_trainer_paths_and_refusals():
    ds = small_ds()
    host = UnsupTrainer(ds, small_cfg().replace(train=TrainConfig(
        on_device_sampling=False)), device="cpu")
    assert host.host_sampling and not hasattr(host, "_nbr_table")
    assert np.isfinite(host.train_epoch())
    gcn = UnsupTrainer(ds, small_cfg(model="gcn_unsup"), device="cpu")
    assert gcn.gcn and not hasattr(gcn, "_nbr_table") and gcn.csr is None
    assert np.isfinite(gcn.train_epoch())
    t = UnsupTrainer(ds, small_cfg(id_symmetric=True), device="cpu")
    want = np.random.default_rng(123 + 7).permutation(ds.num_nodes)
    np.testing.assert_array_equal(t.vocab_perm.numpy(), want)
    # the stacked epoch (one replay of the captured step a batch on the
    # card, the same step eagerly here) trains what the eager epoch trains
    twin = UnsupTrainer(ds, small_cfg(id_symmetric=True), device="cpu")
    assert twin.train_epoch_stacked() == t.train_epoch()
    for a, b in zip(twin.model.parameters(), t.model.parameters()):
        assert torch.equal(a, b)
    # the fused gate needs the default loss and sampler
    flags = dict(use_fused_sampler=True, use_pallas=True,
                 use_pallas_whole_encoder=True)
    assert not UnsupTrainer(ds, small_cfg(sampler_type="neighbor", **flags),
                            device="cpu").fused


def test_probe_against_sklearn():
    """On pooled embeddings of a trained model, each fold of the port's
    probe within one test example of sklearn's and its objective at most
    sklearn's (up to 1e-9 relative), on the repaired folds; and the
    10-fold means within 1 / (smallest fold)."""
    out = train_evaluate_unsup(small_ds(), small_cfg(),
                               log_fn=lambda s: None, device="cpu")
    t = out["trainer"]
    x, y = t.graph_embeddings(), t.ds.labels
    folds = stratified_kfold_indices(y, 10, seed=0)
    for tr, te in folds:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            acc_s = jax_eval.logistic_regression_probe(x, y, tr, te)
            from sklearn.linear_model import LogisticRegression
            clf = LogisticRegression(solver="lbfgs", tol=0.001,
                                     max_iter=200).fit(x[tr], y[tr])
        acc = evaluate.logistic_regression_probe(x, y, tr, te)
        assert abs(acc - acc_s) * len(te) <= 1.0 + 1e-9
        coef, b, classes = evaluate.fit_logistic(x[tr], y[tr])
        xt = torch.tensor(x[tr], dtype=torch.float64)
        yt = torch.tensor(np.searchsorted(classes, y[tr]), dtype=torch.float64)
        ours = float(evaluate.logistic_objective(xt, yt, coef, b))
        theirs = float(evaluate.logistic_objective(
            xt, yt, torch.tensor(clf.coef_, dtype=torch.float64),
            torch.tensor(clf.intercept_, dtype=torch.float64)))
        assert ours <= theirs * (1 + 1e-9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ms, _ = jax_eval.tenfold_logistic_accuracy(x, y)
    m, s = evaluate.tenfold_logistic_accuracy(x, y)
    assert abs(m - ms) <= 1.0 / min(len(te) for _, te in folds) + 1e-9
    assert 0.0 <= s


def test_probe_multiclass_against_sklearn():
    """Three classes: the multinomial objective at most sklearn's and the
    same predictions on separable data."""
    r = np.random.default_rng(5)
    y = r.integers(0, 3, 90)
    x = (r.standard_normal((90, 6)) + 3.0 * np.eye(3, 6)[y]).astype(
        np.float32)
    from sklearn.linear_model import LogisticRegression
    clf = LogisticRegression(solver="lbfgs", tol=0.001, max_iter=200).fit(x, y)
    coef, b, classes = evaluate.fit_logistic(x, y)
    assert coef.shape == (3, 6)
    xt = torch.tensor(x, dtype=torch.float64)
    yt = torch.tensor(y)
    ours = float(evaluate.logistic_objective(xt, yt, coef, b))
    theirs = float(evaluate.logistic_objective(
        xt, yt, torch.tensor(clf.coef_, dtype=torch.float64),
        torch.tensor(clf.intercept_, dtype=torch.float64)))
    assert ours <= theirs * (1 + 1e-9)
    np.testing.assert_array_equal(
        evaluate.predict_logistic(x, coef, b, classes), clf.predict(x))


def test_pool_matches_jax():
    r = np.random.default_rng(0)
    emb = r.standard_normal((30, 4)).astype(np.float32)
    off = np.array([0, 4, 4, 11, 30])
    np.testing.assert_array_equal(evaluate.pool_node_embeddings(emb, off),
                                  jax_eval.pool_node_embeddings(emb, off))


README_UNSUP = ["--dataset", "IMDBBINARY", "--batch_size", "2",
                "--ff_hidden_size", "1024", "--num_neighbors", "8",
                "--num_sampled", "512", "--num_epochs", "50",
                "--num_timesteps", "1", "--learning_rate", "0.0001"]


class Stop(Exception):
    pass


def jax_config(argv, tmp_path, monkeypatch):
    """The config JAX's ``train_unsup.main`` builds from ``argv`` (its
    dataset loader and trainer replaced, so nothing loads or trains)."""
    seen = {}

    def trainer(ds, cfg):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(jax_cli, "load_tu_dataset", lambda *a, **kw:
                        __import__("graph_transformer_tpu.data.tu",
                                   fromlist=["x"]).synthetic_powerlaw_dataset(
                                       "S", num_graphs=4, mean_nodes=5,
                                       reddit_like=False))
    monkeypatch.setattr(jax_cli, "UnsupTrainer", trainer)
    with pytest.raises(Stop):
        jax_cli.main(argv + ["--run_folder", str(tmp_path)])
    return seen["cfg"]


@pytest.mark.parametrize("extra", [
    [], ["--reference_parity"], ["--sampled_softmax_mode", "reference"],
    ["--permute_graphs", "3"], ["--id_symmetric"],
    ["--num_hidden_layers", "2", "--host_sampling", "--use_pallas",
     "--whole_encoder", "--compute_dtype", "bfloat16"]],
    ids=lambda a: "-".join(a[:1]) or "readme")
def test_flags_match_jax_config(extra, tmp_path, monkeypatch):
    argv = README_UNSUP + extra
    jcfg = jax_config(argv, tmp_path, monkeypatch)
    args, cfg = train_unsup.parse_config(argv)
    assert args.device == "cuda"
    for part in ("data", "model", "train", "parallel"):
        assert dataclasses.asdict(getattr(cfg, part)) == \
            dataclasses.asdict(getattr(jcfg, part)), part
    assert cfg.model.id_symmetric == ("--reference_parity" not in extra)


@pytest.mark.parametrize("bad", [["--id_symmetric"],
                                 ["--permute_graphs", "1"]])
def test_reference_parity_excludes(bad):
    with pytest.raises(SystemExit):
        train_unsup.parse_config(README_UNSUP + ["--reference_parity"] + bad)


def write_small(tmp_path):
    return chip_smoke.write_ptc_like_tu(str(tmp_path / "data"), num_graphs=30,
                                        seed=6)


SMALL = ["--dataset", "PTC", "--batch_size", "4", "--ff_hidden_size", "16",
         "--num_neighbors", "3", "--num_sampled", "32", "--num_timesteps", "1",
         "--learning_rate", "0.005", "--device", "cpu"]


def test_cli_writes_reference_lines(tmp_path, capsys):
    data = write_small(tmp_path)
    runs = tmp_path / "runs"
    mean, std = train_unsup.main(SMALL + [
        "--data_dir", data, "--num_epochs", "3", "--eval_every", "2",
        "--run_folder", str(runs), "--permute_graphs", "4"])
    out = capsys.readouterr().out
    assert "# leak-free protocol: graph order permuted (seed 4)" in out
    assert 0.0 <= mean <= 1.0
    lines = (runs / "PTC_unsup" / "model_acc.txt").read_text().splitlines()
    assert len(lines) == 3
    pat = re.compile(r"^epoch (\d+) mean: (\S+) std: (\S+)$")
    got = [pat.match(ln).groups() for ln in lines]
    assert [g[0] for g in got] == ["1", "2", "3"]
    assert got[0][1] == "nan" and got[2][1] == "nan"
    assert float(got[1][1]) == pytest.approx(mean * 100)
    assert re.search(r"^best: \d\.\d{5} ± \d\.\d{5}$", out, re.M)


def test_resume_equals_straight_run(tmp_path, capsys):
    """``--checkpoint_every 1`` for 1 epoch, then ``--resume`` to 3: starts
    at epoch 2 and its last checkpoint (parameters, Adam state, losses,
    generators) equals that of 3 straight epochs bit for bit, as do the
    probe's lines."""
    data = write_small(tmp_path)
    base = SMALL + ["--data_dir", data, "--checkpoint_every", "1"]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    train_unsup.main(base + ["--num_epochs", "3", "--checkpoint_dir",
                             straight, "--run_folder", str(tmp_path / "a")])
    train_unsup.main(base + ["--num_epochs", "1", "--checkpoint_dir", cut,
                             "--run_folder", str(tmp_path / "b")])
    capsys.readouterr()
    train_unsup.main(base + ["--num_epochs", "3", "--checkpoint_dir", cut,
                             "--resume", "--run_folder", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert re.search(r"# resumed from .*step_00000001 at epoch 2", out)
    assert re.findall(r"^epoch (\d+)", out, re.M) == ["002", "003"]
    a = restore_checkpoint(latest_checkpoint(straight))
    b = restore_checkpoint(latest_checkpoint(cut))
    assert a[2] == b[2] and a[2]["epoch"] == 3 and len(a[2]["losses"]) == 3
    for k in a[0]:
        torch.testing.assert_close(a[0][k], b[0][k], rtol=0, atol=0)
    for x, y in zip(a[1]["mu"] + a[1]["nu"], b[1]["mu"] + b[1]["nu"]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    la = (tmp_path / "a" / "PTC_unsup" / "model_acc.txt").read_text()
    lb = (tmp_path / "b" / "PTC_unsup" / "model_acc.txt").read_text()
    assert la == lb
    with open(latest_checkpoint(cut) + ".extra.json") as f:
        assert json.load(f)["rng"]["builder"]["bit_generator"] == "PCG64"


@pytest.fixture
def numpy_builders(monkeypatch):
    """Both packages' ``BatchBuilder`` on its numpy path: JAX's finds no
    C++ assembler, the port's trainers ask for ``backend="numpy"``."""
    def refuse(ds):
        raise RuntimeError("the C++ assembler is off in this test")

    monkeypatch.setattr(jax_native, "NativeBatchAssembler", refuse)
    monkeypatch.setattr(unsup_trainer, "BatchBuilder", functools.partial(
        tbatching.BatchBuilder, backend="numpy"))


# the flags of chip_smoke's unsup accuracy phase, on its PTC-like file
STAT_FLAGS = chip_smoke.UNSUP_ACC_FLAGS
STAT_BAR = 0.04  # RESULTS.md's fold noise, as tests/test_torch_tenfold.py


def test_cli_means_on_learnable_labels(tmp_path, numpy_builders, capsys):
    """Both CLIs on the PTC-like file of ``chip_smoke.cv_data`` (344
    graphs whose labels come from class-dependent tag distributions) with
    the flags of chip_smoke's unsup accuracy phase (id-symmetric protocol,
    10 epochs): both best means at least ``chip_smoke.UNSUP_MIN_MEAN`` (a
    label-blind probe reads about 0.5) and within ``STAT_BAR`` of each
    other (each package draws its own candidates and neighborhoods; both
    runs are deterministic)."""
    data = chip_smoke.write_ptc_like_tu(str(tmp_path))
    flags = ["--dataset", "PTC", "--data_dir", data] + STAT_FLAGS
    jax_mean, _ = jax_cli.main(flags + ["--run_folder", str(tmp_path / "j")])
    mean, _ = train_unsup.main(flags + ["--run_folder", str(tmp_path / "t"),
                                        "--device", "cpu"])
    with capsys.disabled():
        print(f"\n# unsup best means on learnable labels: JAX {jax_mean:.4f}"
              f", port {mean:.4f}")
    assert jax_mean >= chip_smoke.UNSUP_MIN_MEAN
    assert mean >= chip_smoke.UNSUP_MIN_MEAN
    assert abs(mean - jax_mean) <= STAT_BAR
