"""Checkpoints in the PyTorch port (``train/checkpoint.py``, the resume of
``cli/train_sup.py``), on generated data (JAX's
``tests/test_checkpoint_orthonet.py:25`` takes the absent ``mutag``
fixture): a round trip restores the parameters, the Adam state (``count``,
``mu``, ``nu``, ``lr_scale``), the epoch, the losses and the plateau scale;
an interrupted save's leftovers are never picked; the CLI resumes at the
right epoch and, with the host generators restored, trains what the
uninterrupted run trains."""

import json
import os
import re

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.cli import train_sup
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graph_transformer_tpu_torch.train.optim import ClippedAdam
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer


def trainer(seed=0):
    ds = synthetic_powerlaw_dataset("S", num_graphs=16, num_classes=2,
                                    mean_nodes=8, seed=3, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=2),
        model=ModelConfig(num_timesteps=1, ff_hidden_size=16),
        train=TrainConfig(num_epochs=1, learning_rate=5e-3, seed=seed))
    return SupTrainer(ds, cfg, train_idx=np.arange(12),
                      test_idx=np.arange(12, 16), device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    """A trained model and its Adam state, a loss history whose plateau
    steps decay the scale (3 plateau epochs at 3 batches an epoch), then
    ``train_sup.resume`` into a fresh trainer: every tensor, the count, the
    epoch, the losses, the best accuracy and the rebuilt scale (0.1, on the
    trainer and in the optimizer) are the saved ones."""
    t = trainer()
    t.train_epoch()
    t.epoch_losses = [1.0] * 5 + [2.0, 3.0, 4.0]
    for i in range(len(t.epoch_losses)):
        t.lr_scale = t.sched.update(t.epoch_losses[: i + 1])
    assert t.lr_scale == pytest.approx(0.1)
    path = save_checkpoint(
        str(tmp_path), 8, t.model.state_dict(), t.opt.state_dict(),
        {"epoch": 8, "losses": np.asarray(t.epoch_losses), "best_acc": 0.75,
         "rng": t.rng_state()})
    assert latest_checkpoint(str(tmp_path)) == path
    assert path.endswith("step_00000008")

    t2 = trainer(seed=5)  # other initial weights
    start, best = train_sup.resume(t2, path)
    assert (start, best) == (9, 0.75)
    assert t2.epoch_losses == t.epoch_losses
    assert t2.lr_scale == pytest.approx(0.1) and t2.opt.lr_scale == t2.lr_scale
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(t2.model.state_dict()[k], v, rtol=0, atol=0)
    assert t2.opt.count == t.opt.count == 3
    for a, b in zip(t2.opt.mu + t2.opt.nu, t.opt.mu + t.opt.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert t2.builder.rng.integers(1 << 30) == t.builder.rng.integers(1 << 30)
    params, opt_state, extra = restore_checkpoint(path)
    assert extra["epoch"] == 8 and opt_state["count"] == 3
    assert set(params) == set(t.model.state_dict())


def test_adam_state_dict_carries_a_device_scale():
    """``lr_scale`` may be a device scalar (the on-device CV's plateau
    rule); ``load_state_dict`` copies the moments in place."""
    p = [torch.ones(3, requires_grad=True)]
    a = ClippedAdam(p, 0.1)
    p[0].grad = torch.full((3,), 0.2)
    a.step()
    a.lr_scale = torch.tensor(0.01)
    b = ClippedAdam([torch.zeros(3)], 0.1)
    mu = b.mu[0]
    b.load_state_dict(a.state_dict())
    assert b.count == 1 and b.mu[0] is mu
    torch.testing.assert_close(b.mu[0], a.mu[0], rtol=0, atol=0)
    assert torch.is_tensor(b.lr_scale) and float(b.lr_scale) == \
        pytest.approx(0.01)
    with pytest.raises(ValueError):
        ClippedAdam([torch.zeros(3), torch.zeros(1)], 0.1).load_state_dict(
            a.state_dict())


def test_latest_checkpoint_skips_leftovers(tmp_path):
    """A temporary of an interrupted save (named off the ``step_`` pattern),
    a step directory without its state file and a stray metadata file are
    never picked; saving a step again replaces it whole."""
    t = trainer()
    assert latest_checkpoint(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 2, t.model.state_dict(),
                    t.opt.state_dict(), {"epoch": 2})
    good = save_checkpoint(str(tmp_path), 3, t.model.state_dict(),
                           t.opt.state_dict(), {"epoch": 3})
    (tmp_path / ".tmp.step_00000009.123").mkdir()
    torch.save({}, tmp_path / ".tmp.step_00000009.123" / "state.pt")
    (tmp_path / "step_00000010").mkdir()
    (tmp_path / "step_00000011.extra.json").write_text("{}")
    (tmp_path / "step_00000012.tmp").mkdir()
    assert latest_checkpoint(str(tmp_path)) == good
    again = save_checkpoint(str(tmp_path), 3, t.model.state_dict(),
                            t.opt.state_dict(), {"epoch": 33})
    assert again == good and restore_checkpoint(good)[2]["epoch"] == 33
    with pytest.raises(ValueError):
        restore_checkpoint(good, {"head_w": torch.zeros(1)})


def _write_tu(root, name="TINY", num_graphs=24, seed=0):
    rng = np.random.default_rng(seed)
    lines = [str(num_graphs)]
    for g in range(num_graphs):
        n = int(rng.integers(4, 9))
        lines.append(f"{n} {g % 2}")
        for j in range(n):
            nb = sorted({(j + 1) % n, (j - 1) % n})
            lines.append(" ".join(map(str, [int(rng.integers(0, 3)), len(nb),
                                            *nb])))
    os.makedirs(root / name)
    (root / name / f"{name}.txt").write_text("\n".join(lines) + "\n")


def test_train_sup_resumes_at_the_right_epoch(tmp_path, capsys):
    """``--checkpoint_every 1`` for 1 epoch, then ``--resume`` to 3: the
    resumed run starts at epoch 2, prints epochs 2 and 3 only, and its last
    checkpoint equals that of 3 epochs straight bit for bit (parameters,
    Adam state, epoch, losses)."""
    _write_tu(tmp_path)
    base = ["--dataset", "TINY", "--data_dir", str(tmp_path),
            "--batch_size", "4", "--ff_hidden_size", "16",
            "--num_neighbors", "2", "--num_timesteps", "1",
            "--learning_rate", "0.005", "--checkpoint_every", "1",
            "--run_folder", str(tmp_path / "runs"), "--device", "cpu"]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    train_sup.main(base + ["--num_epochs", "3", "--checkpoint_dir", straight])
    train_sup.main(base + ["--num_epochs", "1", "--checkpoint_dir", cut])
    capsys.readouterr()
    train_sup.main(base + ["--num_epochs", "3", "--checkpoint_dir", cut,
                           "--resume"])
    out = capsys.readouterr().out
    assert re.search(r"# resumed from .*step_00000001 at epoch 2", out)
    assert re.findall(r"^epoch (\d+)", out, re.M) == ["002", "003"]
    a = restore_checkpoint(latest_checkpoint(straight))
    b = restore_checkpoint(latest_checkpoint(cut))
    assert latest_checkpoint(cut).endswith("step_00000003")
    assert a[2] == b[2] and a[2]["epoch"] == 3 and len(a[2]["losses"]) == 3
    for k in a[0]:
        torch.testing.assert_close(a[0][k], b[0][k], rtol=0, atol=0)
    assert a[1]["count"] == b[1]["count"] > 0
    for x, y in zip(a[1]["mu"] + a[1]["nu"], b[1]["mu"] + b[1]["nu"]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with open(latest_checkpoint(cut) + ".extra.json") as f:
        assert json.load(f)["rng"]["builder"]["bit_generator"] == "PCG64"
