"""The whole-stack recompute backward of the PyTorch port (plain version of
kernels K14 and K14w, ``ops/u2gnn_train.mega_recompute_backward``), behind
``mega_bwd`` of ``u2gnn_train_encoder`` and of ``fused_sampled_encoder``.

The JAX reference is ``fused_u2gnn_encoder(..., mega_bwd=True)`` in
interpret mode at rate 0, whose ``jax.grad`` runs kernel 6
(``pallas_u2gnn.py:284``, ``_bwd_rule_mega``).  At rate 0.5 the random
streams cannot match the TPU's, so the port's whole-stack backward is held
against its per-layer chain (K8s, then K8), which draws the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu_torch.ops.fused_sampled_encoder import (
    fused_sampled_encoder,
    fused_sampled_forward_plain,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import (
    mega_recompute_backward,
    mega_recompute_backward_plain,
    u2gnn_train_encoder,
)

S, F, T, N = 5, 32, 3, 24
TILE = 40  # three JAX tiles of 8 neighborhoods: the grads add across tiles


def make(D, stored, seed=0):
    """Weights at the scale of tests/test_torch_two_pass.py (LayerNorm
    scales near 1), rows [N·S, D] and the output's weights."""
    rng = np.random.default_rng(seed)
    shapes = [(stored, D, 3 * D), (stored, 3 * D), (stored, D, D),
              (stored, D), (stored, D), (stored, D), (stored, D, F),
              (stored, F), (stored, F, D), (stored, D), (stored, D),
              (stored, D)]
    params = [(rng.standard_normal(s) * 0.3).astype(np.float32)
              for s in shapes]
    params[4] += 1.0
    params[10] += 1.0
    x = rng.standard_normal((N * S, D)).astype(np.float32)
    w = rng.standard_normal((N, D)).astype(np.float32)
    return params, x, w


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("stored", [T, 1])
@pytest.mark.parametrize("D", [6, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mega_backward_matches_jax_kernel6(dtype, D, stored):
    """The plain K14 (D=6) and K14w (D=40) through ``u2gnn_train_encoder(...,
    mega_bwd=True)`` against ``jax.grad`` of ``fused_u2gnn_encoder(...,
    mega_bwd=True)`` (interpret mode, rate 0), weight-tied or not.
    float32: out and dx to 1e-4, each parameter gradient to 1e-4 of its
    own max; bfloat16: out to 2e-2, dx and each gradient at cosine >
    0.999."""
    params, x, w = make(D, stored, seed=D + stored)
    jdt = jnp.dtype(dtype)

    def loss(p, xx):
        out = fused_u2gnn_encoder(xx, p, None, S, T, 0.0, TILE, True,
                                  mega_bwd=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (gj, gxj) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(x, jdt))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = u2gnn_train_encoder(xt, pt, S, T, 0.0, None, mega_bwd=True)
    gt = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    assert out.shape == (N, D) and gt[0].dtype == xt.dtype
    got = [g.float().numpy() for g in gt]
    want = [np.asarray(g, np.float32) for g in (gxj,) + tuple(gj)]
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        for a, b in zip(got[1:], want[1:]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    else:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)
        for a, b in zip(got, want):
            assert cosine(a, b) > 0.999


@pytest.mark.parametrize("stored", [T, 1])
@pytest.mark.parametrize("D", [6, 40])
def test_mega_backward_equals_chain_at_rate_half(D, stored):
    """At rate 0.5 the whole-stack backward replays the forward's counter
    sites 4t..4t+3 and sums each stored slice in the chain's order: its dx
    and gradients equal the chain's bit for bit (float32)."""
    params, x, w = make(D, stored, seed=7)
    grads = []
    for mega in (False, True):
        pt = [torch.tensor(p, requires_grad=True) for p in params]
        xt = torch.from_numpy(x).requires_grad_(True)
        out = u2gnn_train_encoder(xt, pt, S, T, 0.5, 4242, mega_bwd=mega)
        grads.append(torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                         [xt] + pt))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mega_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is its plain version and counts no
    launch."""
    params, x, _ = make(6, T, seed=1)
    pt = [torch.from_numpy(p) for p in params]
    xt = torch.from_numpy(x)
    xs = torch.randn(T - 1, N * S, 6)
    g = torch.randn(N, 6)
    before = mega_recompute_backward.launches
    a = mega_recompute_backward(xt, xs, g, pt, S, T, 0.5, 3)
    b = mega_recompute_backward_plain(xt, xs, g, pt, S, T, 0.5, 3)
    assert mega_recompute_backward.launches == before
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for u, v in zip(a[1], b[1]):
        assert u.shape == v.shape and u.dtype == torch.float32
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("D", [7, 65])
def test_fused_sampled_mega_matches_jax_kernel6_from_draws(D):
    """The fused sampler with the whole-stack backward (the plain K13, then
    the plain K14/K14w on its bf16 saved inputs) against
    ``fused_u2gnn_encoder(..., mega_bwd=True)`` on codebook[tags] of the
    same draws in bf16, as tests/test_torch_fused_sampled.py holds K13's
    chain to kernel 5: output within 2e-2, each of the 12 gradient leaves
    at cosine > 0.999."""
    rng = np.random.default_rng(D + 3)
    n, S_, F_, T_, C = 32, 9, 64, 3, 16
    params = [(rng.standard_normal(s) * 0.3).astype(np.float32)
              for s in [(T_, D, 3 * D), (T_, 3 * D), (T_, D, D), (T_, D),
                        (T_, D), (T_, D), (T_, D, F_), (T_, F_), (T_, F_, D),
                        (T_, D), (T_, D), (T_, D)]]
    params[4] += 1.0
    params[10] += 1.0
    codebook = rng.standard_normal((C, D)).astype(np.float32)
    tag_rows = rng.integers(0, C, (n, 128)).astype(np.int32)
    deg = rng.integers(0, 200, n).astype(np.int32)
    self_tag = rng.integers(0, C, n).astype(np.int32)
    draws = rng.integers(0, np.clip(deg, 1, 128)[:, None], (n, S_ - 1))
    w = rng.standard_normal((n, D)).astype(np.float32)
    tags = np.concatenate([self_tag[:, None],
                           np.take_along_axis(tag_rows, draws, 1)], 1)
    x = jnp.asarray(codebook[tags].reshape(n * S_, D), jnp.bfloat16)

    def loss(p):
        out = fused_u2gnn_encoder(x, p, None, S_, T_, 0.0, 72, True,
                                  mega_bwd=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), gj = jax.value_and_grad(loss, has_aux=True)(
        tuple(jnp.asarray(p) for p in params))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    si = tuple(torch.from_numpy(a) for a in (tag_rows, deg, self_tag,
                                             codebook))
    dr = torch.from_numpy(draws)
    got = fused_sampled_encoder(*si, pt, S_, T_, 0.0, None, dr,
                                mega_bwd=True)
    gt = torch.autograd.grad((got * torch.from_numpy(w)).sum(), pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-2, rtol=2e-2)
    for a, b in zip(gt, gj):
        assert cosine(a.numpy(), np.asarray(b)) > 0.999
    # the whole-stack backward gives the chain's gradients on K13's inputs
    _, xs, _ = fused_sampled_forward_plain(*si, pt, S_, T_, 0.0, None, dr)
    assert xs.dtype == torch.bfloat16
    pc = [p.detach().clone().requires_grad_(True) for p in pt]
    out_c = fused_sampled_encoder(*si, pc, S_, T_, 0.0, None, dr)
    gc = torch.autograd.grad((out_c * torch.from_numpy(w)).sum(), pc)
    for a, b in zip(gt, gc):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
