"""The fused sampler with the recompute backward (plain version of kernel
K13, ``ops/fused_sampled_encoder.py``) and the fused path's gate and
dispatch (``train/sup_trainer.fused_gate_ok``,
``ops/stored_encoder.training_encoder``).

JAX's kernel 12 (``fused_u2gnn_encoder_sampled``) draws its neighbors and
its dropout from the TPU's on-core PRNG, which neither interpret mode nor
the CPU can run, so it is not called here.  As JAX's own test does
(``tests/test_pallas_sampled_encoder.py:54-130``), degree-1 tag tables fix
the sampling, and the port's K13 is held against ``fused_u2gnn_encoder``
(interpret mode, rate 0) on the gathered bf16 one-hot rows, at the
tolerances stated there; with the draws handed to both, at any degree and a
random codebook, its bf16 gradients are held to JAX's kernel 5 leaf by leaf.
At rate 0.5 K13 is held to K1 and K5, which draw the same bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
from graph_transformer_tpu_torch.ops import sampled_encoder as se
from graph_transformer_tpu_torch.ops import stored_encoder as st
from graph_transformer_tpu_torch.ops.fused_sampled_encoder import (
    fused_sampled_encoder,
    fused_sampled_forward_plain,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.train.sup_trainer import (
    SupTrainer,
    fused_gate_ok,
)


def jax_params(rng, T, D, F):
    """Weights as JAX's test makes them (``standard_normal * 0.3``)."""
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in [(T, D, 3 * D), (T, 3 * D), (T, D, D), (T, D), (T, D),
                      (T, D), (T, D, F), (T, F), (T, F, D), (T, D), (T, D),
                      (T, D)]]


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("D", [7, 65])
def test_plain_k13_matches_jax_on_fixed_draws(D):
    """Degree-1 tag tables (every draw takes entry 0): the plain K13 and its
    recompute backward against ``fused_u2gnn_encoder`` and its ``jax.grad``
    on the gathered bf16 one-hot rows — forward within 2e-2, each gradient
    within 5e-2 (JAX's own test, at JAX's shapes n=64, S=5, F=32, T=2)."""
    rng = np.random.default_rng(D)
    n, S, F, T = 64, 5, 32, 2
    tags = rng.integers(0, D, n).astype(np.int32)
    nbr = rng.integers(0, n, n).astype(np.int32)
    tag_rows = np.tile(tags[nbr][:, None], (1, 128))
    params = jax_params(rng, T, D, F)
    w = rng.standard_normal((n, D)).astype(np.float32)
    neigh_tags = np.concatenate(
        [tags[:, None], np.tile(tags[nbr][:, None], (1, S - 1))], axis=1)
    x = jnp.asarray(np.eye(D, dtype=np.float32)[neigh_tags.reshape(-1)],
                    jnp.bfloat16)

    def loss(p):
        out = fused_u2gnn_encoder(x, p, None, S, T, 0.0, 40, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), gj = jax.value_and_grad(loss, has_aux=True)(
        tuple(jnp.asarray(p) for p in params))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    si = (torch.from_numpy(tag_rows), torch.ones(n, dtype=torch.int32),
          torch.from_numpy(tags), torch.eye(D))
    _, _, draws = fused_sampled_forward_plain(*si, pt, S, T, 0.0, 11)
    assert int(draws.abs().sum()) == 0
    got = fused_sampled_encoder(*si, pt, S, T, 0.0, 11)
    gt = torch.autograd.grad((got * torch.from_numpy(w)).sum(), pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-2, rtol=2e-2)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-2,
                                   rtol=5e-2)


@pytest.mark.parametrize("D", [7, 65])
def test_plain_k13_grads_match_jax_kernel5_from_draws(D):
    """Draws made outside at degrees up to 200, a random 16-row codebook:
    the plain K13's output against ``fused_u2gnn_encoder`` on codebook[tags]
    in bf16 within 2e-2, and each of the 12 gradient leaves of its recompute
    backward against kernel 5's at cosine > 0.999 (both bf16, the same
    function; LayerNorm scales near 1 as in tests/test_torch_two_pass.py)."""
    rng = np.random.default_rng(D + 1)
    n, S, F, T, C = 32, 9, 64, 3, 16
    params = jax_params(rng, T, D, F)
    params[4] += 1.0
    params[10] += 1.0
    codebook = rng.standard_normal((C, D)).astype(np.float32)
    tag_rows = rng.integers(0, C, (n, 128)).astype(np.int32)
    deg = rng.integers(0, 200, n).astype(np.int32)
    self_tag = rng.integers(0, C, n).astype(np.int32)
    draws = rng.integers(0, np.clip(deg, 1, 128)[:, None], (n, S - 1))
    w = rng.standard_normal((n, D)).astype(np.float32)
    tags = np.concatenate([self_tag[:, None],
                           np.take_along_axis(tag_rows, draws, 1)], 1)
    x = jnp.asarray(codebook[tags].reshape(n * S, D), jnp.bfloat16)

    def loss(p):
        out = fused_u2gnn_encoder(x, p, None, S, T, 0.0, 72, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), gj = jax.value_and_grad(loss, has_aux=True)(
        tuple(jnp.asarray(p) for p in params))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    si = tuple(torch.from_numpy(a) for a in (tag_rows, deg, self_tag,
                                             codebook))
    got = fused_sampled_encoder(*si, pt, S, T, 0.0, None,
                                torch.from_numpy(draws))
    gt = torch.autograd.grad((got * torch.from_numpy(w)).sum(), pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-2, rtol=2e-2)
    for a, b in zip(gt, gj):
        assert cosine(a.numpy(), np.asarray(b)) > 0.999


def si_case(D, n=40, C=9, seed=3):
    """Tag rows, degrees, self tags and a C-row codebook for n nodes."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, C, (n, 128)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 300, n).astype(np.int32)),
            torch.from_numpy(rng.integers(0, C, n).astype(np.int32)),
            torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("D,other", [(7, "K1"), (65, "K5")])
def test_plain_k13_equals_k1_and_k5(D, other, rate):
    """For one seed the plain K13 draws K1's (D=7) or K5's (D=65) neighbors
    and gives their output and saved bf16 layer inputs bit for bit, and the
    two-pass path on the bf16 codebook rows of those draws gives K13's
    output and gradients bit for bit (the same function, the same code);
    K13's gradients (recomputed from the bf16 saved inputs, as kernel 5
    does) agree with K1-K3's or K5/K6's (read from stored residuals) at
    cosine > 0.99 on every leaf here, the gap ROADMAP Queue C records
    between the two-pass and the fused paths."""
    S, F, T = 9, 32, 3
    si = si_case(D)
    rng = np.random.default_rng(D)
    params = jax_params(rng, T, D, F)
    params[4] += 1.0
    params[10] += 1.0
    w = torch.from_numpy(rng.standard_normal((40, D)).astype(np.float32))
    seed = 2024
    out, xs, draws = fused_sampled_forward_plain(
        *si, [torch.from_numpy(p) for p in params], S, T, rate, seed)
    fwd, enc = ((se.sampled_forward_plain, se.sampled_encoder) if other == "K1"
                else (st.stored_forward_plain, st.stored_encoder))
    ref, res = fwd(*si, [torch.from_numpy(p) for p in params], S, T, rate,
                   seed)
    assert torch.equal(draws, res["draws"]) and torch.equal(out, ref)
    assert xs.dtype == torch.bfloat16 and xs.shape == (T, 40 * S, D)
    assert torch.equal(xs, torch.stack(res["xs"]).reshape(T, -1, D))
    tags = torch.cat([si[2].long()[:, None], si[0].long().gather(1, draws)],
                     1)
    rows = si[3][tags].to(torch.bfloat16).reshape(-1, D)
    outs, grads = [], []
    for f in (fused_sampled_encoder, enc, None):
        pt = [torch.tensor(p, requires_grad=True) for p in params]
        o = (u2gnn_train_encoder(rows, pt, S, T, rate, seed) if f is None
             else f(*si, pt, S, T, rate, seed))
        outs.append(o.detach())
        grads.append(torch.autograd.grad((o * w).sum(), pt))
    assert torch.equal(outs[0], outs[2])
    for a, b, c in zip(*grads):
        assert torch.equal(a, c)
        assert cosine(a.numpy(), b.numpy()) > 0.99


def test_k13_gets_no_integer_or_codebook_grads():
    """Only the 12 parameters get gradients: the codebook and the integer
    inputs get none (``pallas_sampled_encoder.py:286-291``)."""
    S, F, T, D = 5, 16, 2, 6
    tag_rows, deg, self_tag, codebook = si_case(D, n=12)
    codebook.requires_grad_(True)
    pt = [torch.tensor(p, requires_grad=True)
          for p in jax_params(np.random.default_rng(0), T, D, F)]
    out = fused_sampled_encoder(tag_rows, deg, self_tag, codebook, pt, S, T,
                                0.5, 7)
    out.sum().backward()
    assert codebook.grad is None
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pt)


FLAGS = dict(use_fused_sampler=True, use_pallas=True,
             use_pallas_whole_encoder=True)


def codebook_ds(D=4):
    """A one-hot D-tag dataset: its features factor through a codebook."""
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=20, seed=0,
                                    reddit_like=False)
    tags = np.random.default_rng(0).integers(0, D, ds.num_nodes)
    ds.node_feat = np.eye(D, dtype=np.float32)[tags]
    return ds


@pytest.mark.parametrize("D", [4, 40])
@pytest.mark.parametrize("flags,path", [
    ({}, "two-pass"), (FLAGS, "K13"), (dict(FLAGS, use_stored_bwd=True),
                                       "K5/K6"),
    (dict(FLAGS, use_folded=True), "K1-K3"),
    (dict(use_fused_sampler=True, use_folded=True), "two-pass")],
    ids=["default", "flags", "stored", "folded", "no-pallas"])
def test_fused_gate_and_dispatch(monkeypatch, flags, path, D):
    """The path the port trains a one-layer codebook model on, as JAX picks
    it: the default configuration (and any without all three of
    ``use_fused_sampler``, ``use_pallas``, ``use_pallas_whole_encoder``)
    takes the two-pass path on float32 rows; the three flags the fused
    path, there K13 with the recompute backward, K5/K6 under
    ``use_stored_bwd``, and K1-K3 under ``use_folded`` where the folded gate
    holds (D=4) — K5/K6 where it does not (S=4, D=40).  Two steps each, with
    finite losses, through only that path's forward."""
    from graph_transformer_tpu_torch.models import u2gnn_sup

    calls = {"two-pass": [], "K13": 0, "K5/K6": 0, "K1-K3": 0}

    def spy(name, mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            if name == "two-pass":
                calls[name].append(a[0].dtype)
            else:
                calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)

    spy("two-pass", u2gnn_sup, "u2gnn_train_encoder")
    spy("K13", fs, "fused_sampled_forward")
    spy("K5/K6", st, "stored_forward")
    spy("K1-K3", se, "sampled_forward")
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16, **flags),
        train=TrainConfig(num_epochs=1, learning_rate=5e-3))
    tr = SupTrainer(codebook_ds(D), cfg, train_idx=np.arange(9),
                    test_idx=np.arange(9, 12), device="cpu")
    assert fused_gate_ok(cfg.model) == (path != "two-pass")
    assert tr.two_pass == (path == "two-pass")
    losses = tr.train_steps(tr.builder.sample(), 2)
    assert bool(torch.isfinite(losses).all())
    want = "K5/K6" if (path == "K1-K3" and D > 32) else path
    for name, got in calls.items():
        assert bool(got) == (name == want), name
    if path == "two-pass":
        assert set(calls["two-pass"]) == {torch.float32}


def test_default_config_trains_the_quickstart_in_float32(tmp_path):
    """The README quickstart's data (an IMDBBINARY-like file: one-hot degree
    tags past D=32) under the default ``ModelConfig`` trains on the two-pass
    path with float32 rows and float32 products, as the JAX CLI trains it,
    and no longer in bf16 on the fused kernels."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    chip_smoke.write_imdb_like_tu(tmp_path, num_graphs=60)
    ds = load_tu_dataset("IMDBBINARY", data_dir=str(tmp_path))
    assert ds.feature_dim > 32
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=8),
        model=dataclasses.replace(ModelConfig(), num_timesteps=2,
                                  ff_hidden_size=16),
        train=TrainConfig(num_epochs=1))
    assert cfg.model.compute_dtype == "float32"
    tr = SupTrainer(ds, cfg, train_idx=np.arange(50),
                    test_idx=np.arange(50, 60), device="cpu")
    assert tr.two_pass and tr._x_global.dtype == torch.float32
    losses = tr.train_steps(tr.builder.sample(), 2)
    assert bool(torch.isfinite(losses).all())
    assert 0.0 <= tr.evaluate() <= 1.0
