"""The port's HPO harness (``exp/hpo.py``) and CLI (``cli/hpo.py``) against
the JAX package's:

1. ``optimize`` on numpy objectives (a known optimum, branin, a discrete
   space), in both strategies: the same trials, values and ``best_arm`` as
   JAX's, and ``_GP`` / ``expected_improvement`` equal on one pool.
2. The CLI's unsup pipeline on a small PTC-like file (2 trials, 1 epoch,
   ``--device cpu``): JAX's CLI with its trainer replaced by a constant
   objective proposes the same arms; both write the same JSON keys; the
   port's trial values are probe accuracies in [0, 1], and a second run
   writes the same JSON.
3. The node pipeline on karate (``sampled_num`` clamped to 17) with
   ``--node_model u2gnn`` and ``gcn``.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_transformer_tpu.cli import hpo as jax_cli
from graph_transformer_tpu.exp import hpo as jhpo
from graph_transformer_tpu_torch.cli import hpo
from graph_transformer_tpu_torch.exp import best_arm, optimize
from graph_transformer_tpu_torch.exp import hpo as thpo
from graph_transformer_tpu_torch.train import node_trainer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread: under the test run's parallel workers
    the default pool is many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(*_):
    pass


def known(p):
    return -((p["x"] - 2.0) ** 2) + p["k"]


def branin(p):
    x, y = p["x"], p["y"]
    b, c = 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
    t = 1.0 / (8 * math.pi)
    return -((y - b * x * x + c * x - 6.0) ** 2
             + 10.0 * (1 - t) * math.cos(x) + 10.0)


SPACES = {
    "known": ([{"name": "x", "type": "range", "bounds": [-5.0, 5.0]},
               {"name": "k", "type": "choice", "values": [1, 2, 3]},
               {"name": "c", "type": "fixed", "value": 10}], known),
    "branin": ([{"name": "x", "type": "range", "bounds": [-5.0, 10.0]},
                {"name": "y", "type": "range", "bounds": [0.0, 15.0]}],
               branin),
    "ints": ([{"name": "n", "type": "range", "bounds": [1, 6]},
              {"name": "lr", "type": "range", "bounds": [1e-5, 1e-2],
               "log_scale": True},
              {"name": "s", "type": "choice", "values": [128, 256, 512]}],
             lambda p: -abs(p["n"] - 4) - abs(math.log10(p["lr"]) + 3)
             + p["s"] / 512),
}


@pytest.mark.parametrize("strategy", ["gp", "halton"])
@pytest.mark.parametrize("name", sorted(SPACES))
@pytest.mark.parametrize("minimize", [False, True])
def test_optimize_gives_jax_trials(name, strategy, minimize):
    space, f = SPACES[name]
    kw = dict(total_trials=14, seed=3, strategy=strategy, minimize=minimize,
              log_fn=quiet)
    bt, vt, tt = optimize(space, f, **kw)
    bj, vj, tj = jhpo.optimize(space, f, **kw)
    assert tt == tj and bt == bj and vt == vj
    assert best_arm(tt, minimize=minimize) == jhpo.best_arm(
        tj, minimize=minimize)
    if strategy == "gp":  # past the scrambled-Halton trials
        assert len({repr(t["params"]) for t in tt}) > 3


def test_gp_and_expected_improvement_equal_jax():
    rng = np.random.default_rng(0)
    X, y = rng.random((9, 3)), rng.normal(size=9)
    pool = rng.random((50, 3))
    gt, gj = thpo._GP(X, y), jhpo._GP(X, y)
    assert (gt.ell, gt.noise) == (gj.ell, gj.noise)
    (mt, st), (mj, sj) = gt.posterior(pool), gj.posterior(pool)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(
        thpo.expected_improvement(mt, st, 0.3),
        jhpo.expected_improvement(mj, sj, 0.3))


@pytest.fixture(scope="module")
def ptc_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpo")
    chip_smoke.write_ptc_like_tu(str(root), num_graphs=40, seed=5)
    return str(root)


FLAGS = ["--dataset", "PTC", "--total_trials", "2", "--trial_epochs", "1",
         "--ff_hidden_size", "16", "--batch_size", "8", "--num_neighbors",
         "3"]


def jax_arms(monkeypatch, flags, json_path):
    """JAX's CLI with ``flags``, its objective a constant (no JAX trainer
    runs): the trials it proposes."""
    real = jax_cli.optimize

    def constant(space, evaluate, **kw):
        return real(space, lambda p: 0.5, **dict(kw, log_fn=quiet))

    monkeypatch.setattr(jax_cli, "optimize", constant)
    jax_cli.main(flags + ["--results_json", json_path])
    with open(json_path) as f:
        return json.load(f)


def test_unsup_cli_proposes_jax_arms(ptc_file, tmp_path, monkeypatch,
                                     capsys):
    flags = FLAGS + ["--data_dir", ptc_file]
    out = []
    for run in ("a", "b"):
        path = str(tmp_path / run / "hpo.json")
        best, value = hpo.main(flags + ["--device", "cpu", "--results_json",
                                        path])
        with open(path) as f:
            out.append(json.load(f))
    text = capsys.readouterr().out
    assert out[0] == out[1]
    got = out[0]
    want = jax_arms(monkeypatch, flags, str(tmp_path / "j.json"))
    assert set(got) == set(want) == {"best", "trials"}
    assert [set(t) for t in got["trials"]] == [set(t) for t in
                                               want["trials"]]
    assert [t["params"] for t in got["trials"]] == [
        t["params"] for t in want["trials"]]
    values = [t["accuracy"] for t in got["trials"]]
    assert all(0.0 <= v <= 1.0 for v in values)
    assert got["best"] == best_arm(got["trials"], "accuracy")
    assert value == max(values) and best == got["best"]["params"]
    assert text.count("trial 00") == 4 and "best accuracy" in text


@pytest.mark.parametrize("node_model", ["u2gnn", "gcn"])
def test_node_cli_on_karate(node_model, tmp_path, monkeypatch):
    flags = ["--pipeline", "node", "--node_dataset", "karate",
             "--node_model", node_model, "--total_trials", "2",
             "--trial_epochs", "1", "--ff_hidden_size", "16",
             "--num_neighbors", "4"]
    path = str(tmp_path / "t.json")
    seen = []

    class Recording(node_trainer.NodeTrainer):
        def __init__(self, ds, cfg, device):
            seen.append((cfg.model.model, cfg.model.sampled_num, device))
            super().__init__(ds, cfg, device=device)

    monkeypatch.setattr(node_trainer, "NodeTrainer", Recording)
    hpo.main(flags + ["--device", "cpu", "--results_json", path])
    with open(path) as f:
        got = json.load(f)
    want = jax_arms(monkeypatch, flags, str(tmp_path / "j.json"))
    assert [t["params"] for t in got["trials"]] == [
        t["params"] for t in want["trials"]]
    assert all(0.0 <= t["accuracy"] <= 1.0 for t in got["trials"])
    assert seen == [(node_model, 17, "cpu")] * 2
