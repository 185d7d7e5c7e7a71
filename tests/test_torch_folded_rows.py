"""The folded row-input encoders of the PyTorch port (plain versions of
kernels K15 and K16, ``ops/folded_encoder.py``): ``folded_u2gnn_encoder``
and ``folded_u2gnn_encoder_grad``, against the JAX functions of the same
names in interpret mode at rate 0, called as ``tests/test_pallas_folded.py``
calls them (``:77, :89``), and at rate 0.5 against K1-K3, which draw the
same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.pallas_folded import (
    folded_u2gnn_encoder as jax_folded,
)
from graph_transformer_tpu.ops.pallas_folded import (
    folded_u2gnn_encoder_grad as jax_folded_grad,
)
from graph_transformer_tpu_torch.ops import folded_encoder as fe
from graph_transformer_tpu_torch.ops.folded_encoder import (
    folded_u2gnn_encoder,
    folded_u2gnn_encoder_grad,
)
from graph_transformer_tpu_torch.ops.sampled_encoder import (
    sampled_encoder,
    sampled_forward_plain,
)
from graph_transformer_tpu_torch.ops.stored_encoder import stored_rows_forward

F, T, N = 32, 2, 24


def mk(S, D, seed=0, stored=T):
    """Rows, weights and the output's weights as test_pallas_folded.mk
    makes them (weights at scale 0.3, bf16 rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N * S, D)).astype(np.float32)
    params = [(rng.standard_normal(s) * 0.3).astype(np.float32)
              for s in [(stored, D, 3 * D), (stored, 3 * D), (stored, D, D),
                        (stored, D), (stored, D), (stored, D), (stored, D, F),
                        (stored, F), (stored, F, D), (stored, D), (stored, D),
                        (stored, D)]]
    w = rng.standard_normal((N, D)).astype(np.float32)
    return x, params, w


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("S,D", [(5, 4), (3, 40)])
def test_folded_forward_matches_jax(S, D):
    """The port's ``folded_u2gnn_encoder`` (the plain K16; at S=3, D=40 the
    wide forward's route) against JAX's kernel 7 on the same bf16 rows,
    within 2e-2 (both bf16)."""
    x, params, _ = mk(S, D, seed=D)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_folded(xb, tuple(jnp.asarray(p) for p in params),
                                 None, S, T, 0.0, 8, True))
    got = folded_u2gnn_encoder(torch.from_numpy(x).to(torch.bfloat16),
                               [torch.from_numpy(p) for p in params], S, T)
    assert got.shape == (N, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S,D", [(5, 4), (3, 40)])
def test_folded_grad_matches_jax(S, D):
    """``folded_u2gnn_encoder_grad`` (plain K15, K3, K2; at S=3, D=40 K17
    with K6 on the bf16 rows) against JAX's kernels 8, 3 and 2: output
    within 2e-2, dx and each of the 12 gradient leaves at cosine > 0.999
    (both bf16)."""
    x, params, w = mk(S, D, seed=D + 1)
    xb = jnp.asarray(x, jnp.bfloat16)

    def loss(p, xx):
        out = jax_folded_grad(xx, p, None, S, T, 0.0, 8, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), (gj, gxj) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(p) for p in params), xb)
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = folded_u2gnn_encoder_grad(xt, pt, S, T)
    gt = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    assert gt[0].dtype == torch.bfloat16 and gt[0].shape == xt.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    for a, b in zip(gt, (gxj,) + tuple(gj)):
        assert cosine(a.float().numpy(), np.asarray(b, np.float32)) > 0.999


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_folded_equals_k1_on_its_rows(rate):
    """Fed K1's own bf16 x0 rows and seed, the plain K15 gives K1's output
    and residuals bit for bit, K16 K15's output, and the folded gradient
    (K15, K3, K2) K1-K3's."""
    rng = np.random.default_rng(5)
    S, D, C = 9, 7, 16
    _, params, w = mk(S, D, seed=9, stored=1)
    pt = [torch.from_numpy(p) for p in params]
    si = (torch.from_numpy(rng.integers(0, C, (N, 128)).astype(np.int32)),
          torch.from_numpy(rng.integers(0, 200, N).astype(np.int32)),
          torch.from_numpy(rng.integers(0, C, N).astype(np.int32)),
          torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)))
    seed = 2718
    out1, res1 = sampled_forward_plain(*si, pt, S, T, rate, seed)
    x0 = res1["xs"][0].reshape(N * S, D)
    out15, res15 = fe.folded_stored_forward(x0, pt, S, T, rate, seed)
    torch.testing.assert_close(out15, out1, rtol=0, atol=0)
    for key in ("xs", "qkv", "attn", "strip"):
        for a, b in zip(res15[key], res1[key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(fe.folded_forward(x0, pt, S, T, rate, seed),
                               out15, rtol=0, atol=0)
    wt = torch.from_numpy(w)
    grads = []
    for run in ("k1", "folded"):
        ps = [p.clone().requires_grad_(True) for p in pt]
        out = (sampled_encoder(*si, ps, S, T, rate, seed) if run == "k1"
               else folded_u2gnn_encoder_grad(x0, ps, S, T, rate, seed))
        grads.append(torch.autograd.grad((out * wt).sum(), ps))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wide_route_and_gate():
    """Past D=32 the folded gate holds only at S <= 3: the gradient takes
    K17 (one launch counter of the stored path; on the CPU its plain
    version) and outside the gate both entry points raise."""
    x, params, _ = mk(3, 40, seed=2)
    pt = [torch.from_numpy(p) for p in params]
    xt = torch.from_numpy(x)
    out = folded_u2gnn_encoder_grad(xt, pt, 3, T, 0.5, 11)
    ref, _ = stored_rows_forward(xt.to(torch.bfloat16), pt, 3, T, 0.5, 11)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    x, params, _ = mk(9, 19, seed=3)
    pt = [torch.from_numpy(p) for p in params]
    for fn in (folded_u2gnn_encoder, folded_u2gnn_encoder_grad):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(x), pt, 9, T)
