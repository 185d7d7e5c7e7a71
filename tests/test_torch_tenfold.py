"""The port's 10-fold protocol on the CPU (``train/tenfold_vmap.py``,
``cli/tenfold.py``), on generated TU data (JAX's ``tests/test_tenfold_vmap.py``
takes the absent ``mutag`` fixture):

- the fold-looped runner equals a sequential ``SupTrainer`` a fold, bit for
  bit (JAX's bar, ``test_tenfold_vmap.py:33``, is a tolerance);
- the plateau decay is per fold (``:68``); ``shard_folds`` refuses (``:113``);
- the CLI prints JAX's lines in each of its three modes;
- slice parity with JAX: at dropout 0 with host sampling, where both
  packages' numpy builders give the same batches, the port's runner started
  from JAX's initial parameters matches JAX's ``TenfoldVmapRunner`` within
  JAX's own bar between its runners (losses ``rtol=2e-3, atol=2e-2``, best
  accuracies 1e-6); at dropout 0.5 with device sampling, where the random
  streams differ, both CLIs' 10-fold means on learnable labels are at least
  0.75 and within ``RESULTS.md``'s fold-noise bar of 0.04.

The JAX side's batch builders take their numpy path (the C++ assembler is
switched off), the port's only path, so that both draw the same batches."""

import dataclasses
import functools
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graph_transformer_tpu.models.u2gnn_sup as jax_model
import graph_transformer_tpu.native.batcher as jax_native
from graph_transformer_tpu.cli import tenfold as jax_tenfold
from graph_transformer_tpu.config import DataConfig as JaxDataConfig
from graph_transformer_tpu.config import ExperimentConfig as JaxExperimentConfig
from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.config import TrainConfig as JaxTrainConfig
from graph_transformer_tpu.data.tu import load_tu_dataset as jax_load
from graph_transformer_tpu.models.u2gnn_sup import U2GNNSup as JaxU2GNNSup
from graph_transformer_tpu.train.tenfold_vmap import (
    TenfoldVmapRunner as JaxRunner,
)
from graph_transformer_tpu_torch.cli import tenfold
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data import batching as tbatching
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import (
    load_tu_dataset,
    synthetic_powerlaw_dataset,
)
from graph_transformer_tpu_torch.models import u2gnn_sup
from graph_transformer_tpu_torch.train import sup_trainer
from graph_transformer_tpu_torch.train.optim import plateau_lr_step
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
from graph_transformer_tpu_torch.train.tenfold_vmap import (
    PARALLEL_ITEM,
    TenfoldVmapRunner,
)
from graph_transformer_tpu_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def numpy_builders(monkeypatch):
    """Both packages' ``BatchBuilder`` on its numpy path: JAX's finds no
    C++ assembler, the port's trainers ask for ``backend="numpy"``."""
    def refuse(ds):
        raise RuntimeError("the C++ assembler is off in this test")

    monkeypatch.setattr(jax_native, "NativeBatchAssembler", refuse)
    monkeypatch.setattr(sup_trainer, "BatchBuilder", functools.partial(
        tbatching.BatchBuilder, backend="numpy"))


def small():
    ds = synthetic_powerlaw_dataset("S", num_graphs=40, num_classes=2,
                                    mean_nodes=10, seed=1, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=8, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16),
        train=TrainConfig(num_epochs=2, learning_rate=5e-3))
    return ds, cfg


@pytest.mark.parametrize("host_sampling", [False, True])
def test_runner_matches_sequential_trainers(host_sampling):
    """Per fold and epoch, the runner's loss and best accuracy equal a
    ``SupTrainer``'s on that fold bit for bit, with device sampling (the
    plain K7) and with host sampling; evaluation interleaved as the CLI's
    loop does (eval batches built once)."""
    ds, cfg = small()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, on_device_sampling=not host_sampling))
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:3]
    runner = TenfoldVmapRunner(ds, cfg, folds=folds, device="cpu")
    vm, best = [], np.zeros(3)
    for _ in range(cfg.train.num_epochs):
        vm.append(runner.train_epoch())
        best = np.maximum(best, runner.evaluate())
    for f, (tr, te) in enumerate(folds):
        t = SupTrainer(ds, cfg, tr, te, device="cpu")
        assert t.num_batches_per_epoch == runner.steps_per_epoch
        losses, b = [], 0.0
        for _ in range(cfg.train.num_epochs):
            losses.append(t.train_epoch())
            b = max(b, t.evaluate())
        assert [float(v[f]) for v in vm] == losses
        assert best[f] == b


def test_plateau_decay_is_per_fold():
    """A decay fires once a fold has gathered ``step_size`` (its batches an
    epoch) plateau steps, each fold counting its own."""
    ds, cfg = small()
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:2]
    runner = TenfoldVmapRunner(ds, cfg, folds=folds, device="cpu")
    runner.epoch_losses[0] = [1.0] * 5 + [2.0]
    runner.epoch_losses[1] = [2.0] * 5 + [1.0]
    assert plateau_lr_step(runner.epoch_losses[0], 5)
    assert not plateau_lr_step(runner.epoch_losses[1], 5)
    runner.scheds[0].num_steps = runner.scheds[0].step_size - 1
    runner.epoch_losses[0] = [-1e30] * 5
    runner.epoch_losses[1] = [1e30] * 5
    runner.train_epoch()
    scales = [t.opt.lr_scale for t in runner.trainers]
    assert scales[0] == pytest.approx(cfg.train.lr_decay_gamma)
    assert scales[1] == pytest.approx(1.0)
    assert runner.lr_scales.tolist() == pytest.approx(scales)
    assert runner.scheds[1].num_steps < runner.scheds[1].step_size


def test_shard_folds_refuses():
    """JAX's divisibility check first, then a refusal naming the ROADMAP
    item that ports the parallel layer; the CLI passes the flag on."""
    ds, cfg = small()
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)
    with pytest.raises(ValueError, match="divide"):
        TenfoldVmapRunner(ds, cfg, folds=folds[:3], shard_folds=2,
                          device="cpu")
    with pytest.raises(NotImplementedError, match=re.escape(PARALLEL_ITEM)):
        TenfoldVmapRunner(ds, cfg, folds=folds[:2], shard_folds=2,
                          device="cpu")
    assert "Parallel layer" in PARALLEL_ITEM
    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    assert "10. **Parallel layer.**" in roadmap


def test_validation_scores_and_labels():
    """``val_fraction`` carves a stratified validation set out of each
    train split (JAX's draw), ``evaluate_scores`` returns the test scores
    [F, nb, B, C] padded by the last batch, ``test_label_mask`` their labels
    and mask, whose sum is each fold's test count."""
    ds, cfg = small()
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:2]
    runner = TenfoldVmapRunner(ds, cfg, folds=folds, val_fraction=0.2,
                               device="cpu")
    for (tr, te), (tr2, _), val in zip(folds, runner.folds, runner.val_sets):
        assert set(tr2) | set(val) == set(tr) and not set(tr2) & set(val)
    runner.train_epoch()
    acc_val = runner.evaluate_val()
    acc, scores = runner.evaluate_scores()
    labels, mask, counts = runner.test_label_mask()
    assert acc_val.shape == acc.shape == (2,)
    nb = max(-(-len(te) // 8) for _, te in folds)
    assert scores.shape == (2, nb, 8, ds.num_classes)
    assert labels.shape == mask.shape == (2, nb, 8)
    np.testing.assert_array_equal(mask.sum(axis=(1, 2)), counts)
    correct = ((scores.argmax(-1) == labels) * mask).sum(axis=(1, 2))
    np.testing.assert_allclose(correct / counts, acc)


@pytest.mark.parametrize("mode", [[], ["--vmap_folds"], ["--cv_on_device"]],
                         ids=["sequential", "vmap_folds", "cv_on_device"])
def test_cli_prints_jax_lines(tmp_path, capsys, mode):
    """``cli.tenfold`` on a generated file with ``--device cpu``: ten
    ``fold i: best acc a.aaaa`` lines and ``10-fold accuracy: m ± s``, as
    the JAX CLI prints them, and it returns (mean, std)."""
    chip_smoke.write_ptc_like_tu(str(tmp_path), num_graphs=40, seed=2)
    mean, std = tenfold.main([
        "--dataset", "PTC", "--data_dir", str(tmp_path), "--batch_size",
        "8", "--ff_hidden_size", "8", "--num_neighbors", "2",
        "--num_timesteps", "1", "--num_epochs", "1", "--device", "cpu"]
        + mode)
    out = capsys.readouterr().out
    folds = re.findall(r"^fold (\d): best acc (\d\.\d{4})$", out, re.M)
    assert [int(i) for i, _ in folds] == list(range(10))
    accs = [float(a) for _, a in folds]
    last = re.findall(r"^10-fold accuracy: (\d\.\d{4}) ± (\d\.\d{4})$", out,
                      re.M)
    assert last == [(f"{mean:.4f}", f"{std:.4f}")]
    assert mean == pytest.approx(np.mean(accs), abs=1e-4)


def flatten_jax(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    tree["head_w"] = np.asarray(p.head_w)
    tree["head_b"] = np.asarray(p.head_b)
    return tree


def test_runner_matches_jax_runner_at_dropout_0(tmp_path, monkeypatch,
                                                numpy_builders):
    """3 folds x 3 epochs at dropout 0 (the encoder's too, patched in both
    packages) with host sampling: the port's runner, started from JAX's
    initial parameters, against JAX's ``TenfoldVmapRunner`` on the same
    file: per-fold epoch losses within ``rtol=2e-3, atol=2e-2`` and best
    accuracies within 1e-6 (``tests/test_tenfold_vmap.py:64-65``)."""
    enc = jax_model.neighborhood_encoder
    monkeypatch.setattr(jax_model, "neighborhood_encoder", lambda *a, **kw:
                        enc(*a, **{**kw, "dropout_rate": 0.0}))
    monkeypatch.setattr(u2gnn_sup, "ENCODER_DROPOUT", 0.0)
    chip_smoke.write_ptc_like_tu(str(tmp_path), num_graphs=60, seed=5)
    dj = jax_load("PTC", data_dir=str(tmp_path))
    dt = load_tu_dataset("PTC", data_dir=str(tmp_path))
    kw = dict(data=dict(batch_size=8, num_neighbors=4),  # JAX's test's
              model=dict(num_timesteps=1, ff_hidden_size=32, dropout=0.0),
              train=dict(num_epochs=3, learning_rate=5e-4,
                         on_device_sampling=False))
    jcfg = JaxExperimentConfig(data=JaxDataConfig(**kw["data"]),
                               model=JaxModelConfig(**kw["model"]),
                               train=JaxTrainConfig(**kw["train"]))
    cfg = ExperimentConfig(data=DataConfig(**kw["data"]),
                           model=ModelConfig(**kw["model"]),
                           train=TrainConfig(**kw["train"]))
    folds = stratified_kfold_indices(dt.labels, 10, seed=0)[:3]
    jr = JaxRunner(dj, jcfg, folds=folds)
    p0 = JaxU2GNNSup(dj.feature_dim, dj.num_classes, jcfg.model).init(
        jax.random.key(jcfg.train.seed))
    tr = TenfoldVmapRunner(dt, cfg, folds=folds, device="cpu",
                           init_state=params_from_jax(flatten_jax(p0)))
    assert tr.steps_per_epoch == jr.steps_per_epoch
    lj, lt, bj, bt = [], [], np.zeros(3), np.zeros(3)
    for _ in range(3):
        lj.append(np.asarray(jr.train_epoch()))
        lt.append(tr.train_epoch())
        bj = np.maximum(bj, jr.evaluate())
        bt = np.maximum(bt, tr.evaluate())
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), rtol=2e-3,
                               atol=2e-2)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-6)
    assert lt[-1].sum() < lt[0].sum()


STAT_SEED = 14  # the generated file's seed, fixed before the first run
STAT_FLAGS = ["--batch_size", "8", "--ff_hidden_size", "32",
              "--num_neighbors", "4", "--num_timesteps", "1",
              "--learning_rate", "0.005", "--num_epochs", "5"]


def test_tenfold_means_on_learnable_labels(tmp_path, numpy_builders):
    """10-fold at dropout 0.5 with device sampling through both CLIs (JAX
    with ``--vmap_folds``, one compile; the port's default loop on the
    CPU) on a 220-graph PTC-like file whose labels come from overlapping
    class tag distributions: both means at least 0.75 (a label-blind model
    reads about 0.5) and within 0.04 of each other (``RESULTS.md:583``).
    Both runs are deterministic; epochs are cut to 5 for time, not
    graphs."""
    chip_smoke.write_ptc_like_tu(str(tmp_path), num_graphs=220,
                                 seed=STAT_SEED)
    flags = ["--dataset", "PTC", "--data_dir", str(tmp_path)] + STAT_FLAGS
    jax_mean, _ = jax_tenfold.main(flags + ["--vmap_folds"])
    mean, _ = tenfold.main(flags + ["--device", "cpu"])
    assert jax_mean >= 0.75 and mean >= 0.75
    assert abs(mean - jax_mean) <= 0.04


def test_cv_on_device_means_on_learnable_labels(tmp_path, numpy_builders):
    """JAX's ``run_cv_on_device`` against the port's, through both CLIs'
    ``--cv_on_device`` on the file and flags of
    :func:`test_tenfold_means_on_learnable_labels` (dropout 0.5, device
    sampling; each package's own selection and sampling streams): both
    means at least 0.75 and within 0.04 of each other."""
    chip_smoke.write_ptc_like_tu(str(tmp_path), num_graphs=220,
                                 seed=STAT_SEED)
    flags = ["--dataset", "PTC", "--data_dir", str(tmp_path), "--cv_on_device"
             ] + STAT_FLAGS
    jax_mean, _ = jax_tenfold.main(flags)
    mean, _ = tenfold.main(flags + ["--device", "cpu"])
    assert jax_mean >= 0.75 and mean >= 0.75
    assert abs(mean - jax_mean) <= 0.04
