"""K19's and K20's backward (``ops/rows_encoder.py``): the plain versions the
card holds the kernels to (``tests/test_torch_cuda_kernels.py``,
``test_rows_k19_backward_matches_plain`` and ``..._k20_...``), and the
timing harness around them.

1. Against the JAX package at rate 0, float32: K19's backward over a full
   layer through the vjp of ``ops/attention.multihead_attention`` (one head,
   W_out the identity, so its input cotangent is dqkv W_inᵀ and dW_in is
   xᵀ dqkv), K20's through the vjp of ``ops/attention._layer_norm`` on u =
   res[::every] + v.  Within 1e-4 of each output's largest value (float32
   sums in another order).
2. The slot-0 layer leaves q unwritten off slot 0: NaN there leaves the
   slot-0 backward's dqkv finite, its dq 0 on those rows.
3. ``chip_smoke``'s harness on CPU tensors (the wrappers take their plain
   versions there): every call of ``rows_fwd_calls`` and ``rows_bwd_calls``
   runs, and ``check_rows_bwd`` passes equal outputs and fails a wrong one.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops import attention as jatt
from graph_transformer_tpu_torch.ops import rows_encoder as rows

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the card's timing harness)

N, D = 6, 160


def close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), (label, err)


@pytest.mark.parametrize("S", [1, 5, 17])
def test_k19_backward_plain_matches_jax(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((N, S, D)).astype(np.float32)
    w_in = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    g = rng.standard_normal((N, S, D)).astype(np.float32)
    p = jatt.MHAParams(w_in=jnp.asarray(w_in),
                       b_in=jnp.zeros(3 * D, jnp.float32),
                       w_out=jnp.eye(D, dtype=jnp.float32),
                       b_out=jnp.zeros(D, jnp.float32))
    out, vjp = jax.vjp(lambda xx, pp: jatt.multihead_attention(pp, xx), x, p)
    dx, dp = vjp(jnp.asarray(g))
    qkv = torch.from_numpy(x.reshape(-1, D)) @ torch.from_numpy(w_in)
    ctx = rows.attention_forward_plain(qkv, S)
    dqkv = rows.attention_backward_plain(
        qkv, torch.from_numpy(g).reshape(-1, D), S)
    close(ctx.reshape(N, S, D), out, "ctx")
    close(dqkv @ torch.from_numpy(w_in).T, np.asarray(dx).reshape(-1, D),
          "dx")
    close(torch.from_numpy(x.reshape(-1, D)).T @ dqkv, dp.w_in, "dW_in")


@pytest.mark.parametrize("every", [1, 5])
def test_k20_backward_plain_matches_jax(every):
    rng = np.random.default_rng(every)
    R = 7
    res = rng.standard_normal(((R - 1) * every + 1, D)).astype(np.float32)
    v, g = (rng.standard_normal((R, D)).astype(np.float32) for _ in range(2))
    gamma = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    _, vjp = jax.vjp(lambda u, sc, b: jatt._layer_norm(u, sc, b),
                     jnp.asarray(res[::every] + v), jnp.asarray(gamma),
                     jnp.asarray(beta))
    du_j, dg_j, db_j = vjp(jnp.asarray(g))
    du, dv, dg, db = rows.res_ln_backward_plain(
        *(torch.from_numpy(a) for a in (g, res, v, gamma, beta)),
        res_every=every)
    for label, a, b in (("du", du, du_j), ("dv", dv, du_j),
                        ("dgamma", dg, dg_j), ("dbeta", db, db_j)):
        close(a, b, label)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_slot0_backward_reads_q_on_slot0_only(rate):
    S = 5
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(N * S, 3 * D, generator=gen)
    dctx = torch.randn(N, D, generator=gen)
    kw = dict(slot0=True, rate=rate, seed=9, layer=0)
    want = rows.attention_backward(qkv, dctx, S, **kw)
    qkv.view(N, S, 3 * D)[:, 1:, :D] = float("nan")
    got = rows.attention_backward(qkv, dctx, S, **kw)
    assert torch.equal(got, want)
    assert bool((got.view(N, S, 3 * D)[:, 1:, :D] == 0).all())


@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_timing_harness_runs_on_cpu(kind):
    S = 5
    gen = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    x, qkv = rnd(N * S, D), rnd(N * S, 3 * D)
    gamma, beta = 1.0 + 0.1 * rnd(D), 0.1 * rnd(D)
    make = chip_smoke.rows_fwd_calls if kind == "forward" else \
        chip_smoke.rows_bwd_calls
    calls = make(qkv, x, S, gamma, beta, rnd)
    assert sorted(calls) == ["K19 full", "K19 slot0", "K20 full", "K20 slot0"]
    for name, (fn, plain, lib, names, b, f) in calls.items():
        got, want = fn(), plain()
        lib()
        assert names and b > 0 and f > 0, name
        if kind == "backward":
            chip_smoke.check_rows_bwd(name, got, want)
        else:
            assert torch.equal(got, want), name


def test_check_rows_bwd_fails_a_wrong_output():
    gen = torch.Generator().manual_seed(5)
    rows_out, sums = torch.randn(40, D, generator=gen), torch.randn(
        D, generator=gen)
    chip_smoke.check_rows_bwd("equal", (rows_out, sums), (rows_out, sums))
    with pytest.raises(SystemExit):
        chip_smoke.check_rows_bwd("rows", (rows_out + 1e-3, sums),
                                  (rows_out, sums))
    with pytest.raises(SystemExit):
        chip_smoke.check_rows_bwd("sums", (rows_out, sums * 1.01),
                                  (rows_out, sums))
