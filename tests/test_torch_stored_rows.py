"""The stored-residual encoder on given rows of the PyTorch port (plain
version of kernel K17 with K6, ``ops/stored_encoder.fused_u2gnn_encoder_stored``)
against JAX's ``fused_u2gnn_encoder_stored`` (kernels 11 and 10 in
interpret mode, ``jax.grad`` through its custom VJP, as
``tests/test_pallas_stored_bwd.py:35, 62`` call it) at rate 0, in float32
and bf16; and at rate 0.5 against K5/K6, which draw the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.pallas_stored_bwd import (
    fused_u2gnn_encoder_stored as jax_stored,
)
from graph_transformer_tpu_torch.ops.stored_encoder import (
    fused_u2gnn_encoder_stored,
    stored_encoder,
    stored_forward_plain,
    stored_rows_forward,
)

S, F, T, N = 5, 32, 3, 16
TILE = 40  # two JAX tiles of 8 neighborhoods: the grads add across tiles


def mk(D, seed=0, stored=T):
    """Rows and weights at the scale of tests/test_pallas_stored_bwd.mk."""
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


@pytest.mark.parametrize("D", [7, 37, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stored_rows_match_jax(dtype, D):
    """Output, dx and the 12 gradient leaves.  float32: output and dx to
    1e-4, each leaf to 1e-4 of its own max; bf16: output to 2e-2, dx and
    each leaf at cosine > 0.999."""
    x, params, w = mk(D, seed=D)
    jdt = jnp.dtype(dtype)

    def loss(p, xx):
        out = jax_stored(xx, p, None, S, T, 0.0, TILE, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), (gj, gxj) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(x, jdt))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = fused_u2gnn_encoder_stored(xt, pt, S, T)
    gt = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    assert out.shape == (N, D) and gt[0].dtype == xt.dtype
    got = [g.float().numpy() for g in gt]
    ref = [np.asarray(g, np.float32) for g in (gxj,) + tuple(gj)]
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
        for a, b in zip(got[1:], ref[1:]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    else:
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-2,
                                   atol=2e-2)
        for a, b in zip(got, ref):
            assert cosine(a, b) > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stored_rows_residuals_in_the_rows_dtype(dtype):
    """K17 keeps the layer inputs (the first being the rows) and the FFN
    hidden in the rows' dtype, q/k/v and the strip in float32."""
    x, params, _ = mk(37, seed=1)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt)
    _, res = stored_rows_forward(xt, [torch.from_numpy(p) for p in params],
                                 S, T, 0.5, 5)
    assert [h.dtype for h in res["h"]] == [dt] * T
    assert [a.dtype for a in res["xs"]] == [dt] * T
    torch.testing.assert_close(res["xs"][0].reshape(N * S, 37), xt, rtol=0,
                               atol=0)
    assert res["h"][-1].shape == (N, F) and res["qkv"][0].dtype == torch.float32


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_stored_rows_equal_k5_on_its_rows(rate):
    """Fed K5's own bf16 x0 rows and seed, the plain K17 gives K5's output
    and residuals bit for bit, and its K6 backward K5/K6's gradients."""
    rng = np.random.default_rng(6)
    Sk, D = 9, 65
    _, params, w = mk(D, seed=4)
    pt = [torch.from_numpy(p) for p in params]
    si = (torch.from_numpy(rng.integers(0, D, (N, 128)).astype(np.int32)),
          torch.from_numpy(rng.integers(0, 200, N).astype(np.int32)),
          torch.from_numpy(rng.integers(0, D, N).astype(np.int32)),
          torch.eye(D))
    seed = 1618
    out5, res5 = stored_forward_plain(*si, pt, Sk, T, rate, seed)
    x0 = res5["xs"][0].reshape(N * Sk, D)
    out17, res17 = stored_rows_forward(x0, pt, Sk, T, rate, seed)
    torch.testing.assert_close(out17, out5, rtol=0, atol=0)
    for key in ("xs", "qkv", "attn", "strip", "h"):
        for a, b in zip(res17[key], res5[key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    wt = torch.from_numpy(w)
    grads = []
    for run in ("k5", "k17"):
        ps = [p.clone().requires_grad_(True) for p in pt]
        out = (stored_encoder(*si, ps, Sk, T, rate, seed) if run == "k5"
               else fused_u2gnn_encoder_stored(x0, ps, Sk, T, rate, seed))
        grads.append(torch.autograd.grad((out * wt).sum(), ps))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
