"""The port's on-device CV (``train/cv_ondevice.run_cv_on_device``) and
its supervisor (``train/elastic.py``) on the CPU, on generated data (JAX's
``tests/test_cv_ondevice.py`` and ``tests/test_elastic.py`` take the absent
``mutag`` fixture): the CV's shapes and learning, chunked runs equal to one
chunk, a resume from a snapshot equal to the uninterrupted run bit for bit,
and JAX's five elastic tests.  On the CPU the wrappers run their plain
versions; the card runs the same in ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.ops.random import (
    select_without_replacement,
    step_seed,
)
from graph_transformer_tpu_torch.train import cv_ondevice
from graph_transformer_tpu_torch.train.cv_ondevice import (
    HIST_FILL,
    epochs_per_chunk,
    plateau_step,
    run_cv_on_device,
)
from graph_transformer_tpu_torch.train.elastic import (
    run_cv_elastic,
    run_elastic,
)


class Boom(RuntimeError):
    pass


@pytest.fixture(scope="module")
def data():
    ds = synthetic_powerlaw_dataset("S", num_graphs=40, num_classes=2,
                                    mean_nodes=10, seed=3, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=8, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16),
        train=TrainConfig(num_epochs=4, learning_rate=5e-3))
    return ds, cfg, stratified_kfold_indices(ds.labels, 10, seed=0)[:2]


def test_full_cv_shapes_and_learning(data):
    """Best accuracies [F], histories [epochs, F]; finite losses that drop
    over 4 epochs in every fold; the best is the running max of the
    accuracies."""
    ds, cfg, folds = data
    best, mean, std, eloss, eacc = run_cv_on_device(
        ds, cfg, folds=folds, return_history=True, device="cpu")
    assert best.shape == (2,) and eloss.shape == eacc.shape == (4, 2)
    assert np.all(np.isfinite(eloss)) and np.all(eloss[-1] < eloss[0])
    assert np.all((best >= 0) & (best <= 1))
    np.testing.assert_array_equal(best, eacc.max(axis=0))
    assert mean == pytest.approx(best.mean()) and std == pytest.approx(
        best.std())


def test_chunked_equals_one_chunk(data):
    """Chunks of 2 epochs (a host read between them) against one chunk of
    4: best accuracies, losses and accuracies equal bit for bit."""
    ds, cfg, folds = data
    one = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                           epochs_per_dispatch=4, device="cpu")
    two = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                           epochs_per_dispatch=2, device="cpu")
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_resume_bitexact(data, tmp_path):
    """A run with a ``checkpoint_dir`` saves the carry after chunk 0 (and
    not after the last); a second run finds the snapshot, resumes at chunk
    1 and reproduces the uninterrupted histories bit for bit."""
    ds, cfg, folds = data
    ref = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                           epochs_per_dispatch=2, device="cpu")
    ckpt = str(tmp_path / "cv")
    first = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                             epochs_per_dispatch=2, checkpoint_dir=ckpt,
                             device="cpu")
    assert sorted(p.name for p in (tmp_path / "cv").iterdir()) == [
        "step_00000001", "step_00000001.extra.json"]
    np.testing.assert_array_equal(first[0], ref[0])
    resumed = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                               epochs_per_dispatch=2, checkpoint_dir=ckpt,
                               device="cpu")
    for a, b in zip(resumed, ref):
        np.testing.assert_array_equal(a, b)


def test_needs_device_sampling_and_takes_the_two_pass_path(data,
                                                           monkeypatch):
    """Host sampling raises, as in JAX; the fused path's flags still train
    the two-pass path (K7 a step), as JAX's CV does."""
    ds, cfg, folds = data
    with pytest.raises(ValueError, match="on_device_sampling"):
        run_cv_on_device(ds, cfg.replace(train=dataclasses.replace(
            cfg.train, on_device_sampling=False)), folds=folds, device="cpu")
    calls = []
    sample = cv_ondevice.SupTrainer._scores

    def spy(self, batch, si, seed):
        calls.append((self.two_pass, len(si)))
        return sample(self, batch, si, seed)

    monkeypatch.setattr(cv_ondevice.SupTrainer, "_scores", spy)
    fused = cfg.replace(
        model=dataclasses.replace(cfg.model, use_fused_sampler=True,
                                  use_pallas=True,
                                  use_pallas_whole_encoder=True),
        train=dataclasses.replace(cfg.train, num_epochs=1))
    run_cv_on_device(ds, fused, folds=folds[:1], device="cpu")
    assert calls and set(calls) == {(True, 2)}


def test_selection_and_seeds():
    """Each step's draw is k distinct positions below the set's count; a
    step's seed is a function of (seed, epoch, step) only; the chunk length
    is JAX's largest-divisor rule."""
    sel = select_without_replacement(124, 3, [5, 9, 7], 4, 6, 9)
    assert sel.shape == (3, 6, 4)
    for f, n in enumerate([5, 9, 7]):
        for row in sel[f]:
            assert len(set(row.tolist())) == 4 and int(row.max()) < n
    torch.testing.assert_close(
        sel, select_without_replacement(124, 3, [5, 9, 7], 4, 6, 9))
    assert not torch.equal(sel, select_without_replacement(124, 4, [5, 9, 7],
                                                           4, 6, 9))
    assert step_seed(124, 2, 5) == step_seed(124, 2, 5) < 2**31
    assert len({step_seed(124, e, i) for e in range(4) for i in range(50)}) \
        == 200
    assert epochs_per_chunk(50, 43, 4) == 25  # 4800 // 172 = 27 -> 25
    assert epochs_per_chunk(4, 10, 8, 3) == 2
    assert epochs_per_chunk(7, 10, 8, 100) == 7


@pytest.mark.parametrize("steps,gamma", [(1, 0.1), (2, 0.5), (3, 0.1)])
def test_plateau_step_matches_jax_schedule(steps, gamma):
    """The device plateau rule, fed 40 epoch losses (falling, then noisy,
    so that it fires often), gives JAX's scale sequence: its
    ``PlateauStepLR``, which JAX's on-device CV rule
    (``cv_ondevice.py:251-260``) mirrors, on the same losses, epoch by
    epoch, with the same plateau-step count."""
    from graph_transformer_tpu.train.optim import PlateauStepLR

    rng = np.random.default_rng(steps)
    losses = (np.linspace(30.0, 10.0, 40) + rng.normal(0.0, 2.0, 40)) \
        .astype(np.float32)
    W = 5
    ref = PlateauStepLR(steps, gamma, W)
    hist = torch.full((W,), HIST_FILL)
    npl = torch.zeros((), dtype=torch.int64)
    g = torch.tensor(gamma, dtype=torch.float32)
    got, want = [], []
    for e, loss in enumerate(losses):
        scale, hist, npl = plateau_step(torch.tensor(loss), e, hist, npl,
                                        steps, g)
        got.append(float(scale))
        want.append(ref.update([float(v) for v in losses[: e + 1]]))
        assert int(npl) == ref.num_steps
        torch.testing.assert_close(hist, torch.from_numpy(
            np.concatenate([np.full(W, HIST_FILL, np.float32),
                            losses[: e + 1]])[-W:]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert ref.num_steps >= 2 * steps  # the rule fired, and decayed


def test_act_cv_loss_has_no_ponder_cost(data):
    """With ``recurrence="act"`` JAX's CV trains on the cross entropy alone
    (``cv_ondevice.py:227-233``): two CVs whose ACT loss weights differ
    give equal histories bit for bit, while a ``SupTrainer`` step, which
    adds the ponder cost, differs between them."""
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    ds, cfg, folds = data
    runs, steps = [], []
    for w in (0.01, 1.0):
        c = cfg.replace(
            model=dataclasses.replace(cfg.model, recurrence="act",
                                      act_loss_weight=w),
            train=dataclasses.replace(cfg.train, num_epochs=2))
        runs.append(run_cv_on_device(ds, c, folds=folds[:1],
                                     return_history=True, device="cpu"))
        t = SupTrainer(ds, c, *folds[0], device="cpu")
        b = t.builder.sample()
        steps.append(float(t.train_step(b, t.step_inputs(b), 5)))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert steps[0] != steps[1]


# ---- the five elastic tests of tests/test_elastic.py:26-65

def test_run_elastic_retries_then_succeeds():
    calls, seen = [], []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise Boom("transient")
        return "done"

    out = run_elastic(fn, max_restarts=3, retryable=(Boom,),
                      on_failure=lambda a, e: seen.append((a, str(e))))
    assert out == "done" and len(calls) == 3
    assert seen == [(1, "transient"), (2, "transient")]


def test_run_elastic_exhausts_and_reraises():
    def fn():
        raise Boom("permanent")

    with pytest.raises(Boom):
        run_elastic(fn, max_restarts=2, retryable=(Boom,))


def test_run_elastic_does_not_catch_unretryable():
    def fn():
        raise KeyError("bug, not a fault")

    with pytest.raises(KeyError):
        run_elastic(fn, max_restarts=5, retryable=(Boom,))


def test_cv_elastic_requires_checkpoint_dir(data):
    ds, cfg, _ = data
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_cv_elastic(ds, cfg, "")


def test_fault_injected_cv_matches_uninterrupted(data, tmp_path,
                                                 monkeypatch):
    """Killed right after its first chunk snapshot, the CV is resumed by
    the supervisor from the snapshot; its results equal the uninterrupted
    run's bit for bit."""
    ds, cfg, folds = data
    ref = run_cv_on_device(ds, cfg, folds=folds, return_history=True,
                           epochs_per_dispatch=2, device="cpu")
    real_save, fired = cv_ondevice.save_checkpoint, []

    def save_then_die(*args, **kwargs):
        path = real_save(*args, **kwargs)
        if not fired:
            fired.append(1)
            raise Boom("preempted right after the snapshot")
        return path

    monkeypatch.setattr(cv_ondevice, "save_checkpoint", save_then_die)
    attempts = []
    out = run_cv_elastic(ds, cfg, str(tmp_path / "ckpt"), folds=folds,
                         return_history=True, epochs_per_dispatch=2,
                         device="cpu", max_restarts=2, retryable=(Boom,),
                         on_failure=lambda a, e: attempts.append(a))
    assert attempts == [1]
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
