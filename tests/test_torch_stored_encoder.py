"""Wide-row sampled encoder of the PyTorch port (plain versions of kernels K5
and K6, ``ops/stored_encoder.py``) and the wide eval encoder (plain version
of the wide K4).

The JAX sampled stored kernel needs the TPU's PRNG, so the port's
draws-taking entry point is held against ``fused_u2gnn_encoder_stored``
(kernels 11 and 10 in interpret mode, ``jax.grad`` through its custom VJP),
fed x2d = codebook[tags] built from the same draws.  At rate 0.5 the plain
K5/K6 are held against the plain K1-K3, which draw the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.pallas_stored_bwd import (
    fused_u2gnn_encoder_stored,
)
from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.ops.sampled_encoder import sampled_encoder
from graph_transformer_tpu_torch.ops.stored_encoder import (
    stored_encoder,
    stored_forward_plain,
    training_encoder,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder

S, F, T, N = 9, 64, 2, 16
K = S - 1
TILE = 72  # two JAX tiles of 8 neighborhoods: the grads add across tiles


def make(D, stored, seed=0, C=None):
    """Weights at the scale of tests/test_pallas_stored_bwd.py, a one-hot
    codebook of D rows (the degree tags of IMDB*) unless C is given."""
    rng = np.random.default_rng(seed)
    shapes = [(stored, D, 3 * D), (stored, 3 * D), (stored, D, D),
              (stored, D), (stored, D), (stored, D), (stored, D, F),
              (stored, F), (stored, F, D), (stored, D), (stored, D),
              (stored, D)]
    params = [(rng.standard_normal(s) * 0.3).astype(np.float32)
              for s in shapes]
    C = C or D
    codebook = (np.eye(D, dtype=np.float32) if C == D
                else rng.standard_normal((C, D)).astype(np.float32))
    tag_rows = rng.integers(0, C, (N, 128)).astype(np.int32)
    deg = rng.integers(0, 200, N).astype(np.int32)
    self_tag = rng.integers(0, C, N).astype(np.int32)
    draws = rng.integers(0, np.clip(deg, 1, 128)[:, None], (N, K))
    w = rng.standard_normal((N, D)).astype(np.float32)
    return params, (tag_rows, deg, self_tag, codebook), draws, w


def jax_x2d(si, draws, dtype):
    tag_rows, _, self_tag, codebook = si
    tags = np.concatenate(
        [self_tag[:, None], np.take_along_axis(tag_rows, draws, 1)], 1)
    D = codebook.shape[1]
    return jnp.asarray(codebook[tags].reshape(N * S, D), dtype)


def cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("stored", [T, 1])
@pytest.mark.parametrize("D", [37, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_jax_stored(dtype, D, stored):
    """float32: forward to 1e-4, each gradient leaf to 1e-4 of its own max.
    bfloat16: forward to 2e-2, each leaf at cosine > 0.999."""
    params, si, draws, w = make(D, stored, seed=D + stored)
    x2d = jax_x2d(si, draws, jnp.dtype(dtype))

    def loss(p):
        out = fused_u2gnn_encoder_stored(x2d, p, None, S, T, 0.0, TILE, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), gj = jax.value_and_grad(loss, has_aux=True)(
        tuple(jnp.asarray(p) for p in params))
    mm = torch.float32 if dtype == "float32" else torch.bfloat16
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    st = tuple(torch.from_numpy(a) for a in si)
    out = stored_encoder(*st, pt, S, T, 0.0, None, torch.from_numpy(draws),
                         mm)
    gt = torch.autograd.grad((out * torch.from_numpy(w)).sum(), pt)
    ref = np.asarray(ref, np.float32)
    assert out.shape == (N, D)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-4)
        for a, b in zip(gt, gj):
            b = np.asarray(b, np.float32)
            assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    else:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)
        for a, b in zip(gt, gj):
            assert cosine(a.numpy(), np.asarray(b, np.float32)) > 0.999


@pytest.mark.parametrize("mm", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_stored_equals_sampled_path(rate, mm):
    """At D=7 both paths run: the plain K5/K6 and the plain K1-K3 draw the
    same neighbors and dropout bits and compute one function."""
    params, si, _, w = make(7, T, seed=3, C=7)
    st = tuple(torch.from_numpy(a) for a in si)
    wt = torch.from_numpy(w)
    outs, grads = [], []
    for enc in (sampled_encoder, stored_encoder):
        pt = [torch.tensor(p, requires_grad=True) for p in params]
        out = enc(*st, pt, S, T, rate, 1234, None, mm)
        grads.append(torch.autograd.grad((out * wt).sum(), pt))
        outs.append(out.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_stored_backward_matches_autograd_f32(rate):
    """The plain K6 (FFN from the stored hidden) against torch.autograd
    through the plain forward, in float32, at D=65."""
    params, si, draws, w = make(65, 1, seed=5)
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    st = tuple(torch.from_numpy(a) for a in si)
    dt, wt = torch.from_numpy(draws), torch.from_numpy(w)
    seed = 77 if rate > 0 else None
    ref, res = stored_forward_plain(*st, pt, S, T, rate, seed, dt,
                                    torch.float32)
    assert [h.shape for h in res["h"]] == [(N, S, F), (N, F)]
    g_ref = torch.autograd.grad((ref * wt).sum(), pt)
    out = stored_encoder(*st, pt, S, T, rate, seed, dt, torch.float32)
    g_got = torch.autograd.grad((out * wt).sum(), pt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


FOLDED = ModelConfig(use_fused_sampler=True, use_pallas=True,
                     use_pallas_whole_encoder=True, use_folded=True)


@pytest.mark.parametrize("S_,D,kernels", [
    (9, 4, "K1-K3"), (9, 7, "K1-K3"), (9, 19, "K5/K6"), (17, 19, "K5/K6"),
    (9, 37, "K5/K6"), (9, 65, "K5/K6"), (32, 128, "K5/K6"), (2, 40, "K5/K6")])
def test_model_picks_training_encoder_by_shape(S_, D, kernels):
    """Under ``use_folded``: K1-K3 where the folded gate holds (S·D <= 128,
    S·S·D <= 1024) and D <= 32, else K5/K6: PTC at K=16 (S=17, D=19) moves
    to K5/K6 as in the JAX model, and so do rows past D=32 that the folded
    gate admits (S=2, D=40)."""
    want = sampled_encoder if kernels == "K1-K3" else stored_encoder
    assert training_encoder(S_, D, FOLDED) is want


@pytest.mark.parametrize("S_,D", [(9, 129), (33, 8)])
def test_shapes_past_the_wide_kernels_raise(S_, D):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        training_encoder(S_, D, FOLDED)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_wide_eval_encoder_matches_jax(dtype, tol):
    """The plain wide K4 against ``fused_u2gnn_encoder`` (interpret mode)
    at D=65."""
    params, _, _, _ = make(65, T, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N * S, 65)).astype(np.float32)
    ref = fused_u2gnn_encoder(jnp.asarray(x, jnp.dtype(dtype)),
                              tuple(jnp.asarray(p) for p in params), None,
                              S, T, 0.0, TILE, True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = u2gnn_encoder(xt, [torch.from_numpy(p) for p in params], S, T)
    assert got.shape == (N, 65) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
