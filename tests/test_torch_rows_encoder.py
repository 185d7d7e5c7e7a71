"""The encoder layer past D = 128 (``ops/rows_encoder.py``): the plain
versions of kernels K18 (products), K19 (neighborhood attention) and K20
(residual LayerNorm) and the routes composed of them.

1. The compositions of the plain pieces against the port's existing plain
   layer (``ops/attention.layer_forward``, ``ops/u2gnn_train.
   layer_recompute_backward_plain``, ``ops/ffn``'s and ``ops/encoder_layer``'s
   plain versions) at D = 40 and 160, float32 and bf16, rates 0 and 0.5:
   the same torch operations on the same values, so within 1e-6 (they read
   0 here).
2. At rate 0 and D = 160 the routes against the JAX package:
   ``fused_u2gnn_encoder`` (interpret mode) and ``neighborhood_encoder``
   (XLA) for the whole encoder at T = 2, ``fused_encoder_layer`` (interpret
   mode) and ``transformer_encoder`` (XLA) for the layer, ``ffn_residual_ln``
   (interpret mode) for the FFN.  Float32; the forward within 1e-5, every
   gradient leaf within 1e-4 of its own largest value (float32 sums in
   another order).
3. The shape rules: D > 128 passes every route's check, S = 33 raises, the
   fused flags and the wide kernels (K14w) at D = 160 raise, all naming
   ROADMAP item 6; a wrapper given a tensor on neither the CPU nor a CUDA
   device raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.ops import attention as jatt
from graph_transformer_tpu.ops.pallas_encoder import (
    fused_encoder_layer as jax_fused_layer,
)
from graph_transformer_tpu.ops.pallas_ffn import ffn_residual_ln as jax_ffn
from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.models.u2gnn_sup import check_encoder_shapes
from graph_transformer_tpu_torch.ops import rows_encoder as rows
from graph_transformer_tpu_torch.ops.attention import (
    KERNEL_ORDER,
    layer_forward,
)
from graph_transformer_tpu_torch.ops.encoder_layer import (
    encoder_layer_backward_plain,
    encoder_layer_forward_plain,
    fused_encoder_layer,
)
from graph_transformer_tpu_torch.ops.ffn import (
    ffn_backward_plain,
    ffn_forward_plain,
    ffn_residual_ln,
)
from graph_transformer_tpu_torch.ops.stored_encoder import training_encoder
from graph_transformer_tpu_torch.ops.u2gnn_encoder import check_wide_shapes
from graph_transformer_tpu_torch.ops.u2gnn_train import (
    layer_recompute_backward_plain,
    u2gnn_train_encoder,
)

S, N, F = 5, 8, 32
EXACT = 1e-6  # the compositions run the plain layer's own torch operations
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def enc_arrays(stored, D, seed):
    """The 12 encoder fields (JAX names), weights 0.3 / sqrt(D / 6) so that
    the layer's activations stay at the scale of the D = 6 tests, LayerNorm
    scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = dict(w_in=(D, 3 * D), b_in=(3 * D,), w_out=(D, D), b_out=(D,),
                  w_ff1=(D, F), b_ff1=(F,), w_ff2=(F, D), b_ff2=(D,),
                  ln1_scale=(D,), ln1_bias=(D,), ln2_scale=(D,),
                  ln2_bias=(D,))
    scale = 0.3 / np.sqrt(D / 6.0)
    out = {k: (rng.standard_normal((stored,) + s) * scale).astype(np.float32)
           for k, s in shapes.items()}
    out["ln1_scale"] += 1.0
    out["ln2_scale"] += 1.0
    return out


def kernel_order(arrs):
    return [arrs[k] for k in KERNEL_ORDER]


def layer_params(D, seed=0):
    return [torch.from_numpy(a[0]) for a in kernel_order(
        enc_arrays(1, D, seed))]


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_leaves(got, want):
    """Each leaf within GRAD_TOL of its own largest value."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), i


# ============================================ 1. compositions vs plain layer
@pytest.mark.parametrize("slot0", [False, True], ids=["full", "slot0"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 160])
def test_composition_equals_plain_layer(D, dtype, rate, slot0):
    """K18-K20's plain pieces composed (forward, recompute backward) equal
    ``layer_forward`` and ``layer_recompute_backward_plain``."""
    p = layer_params(D, seed=D)
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((N * S, D), np.float32)).to(dt)
    mm = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(layer=1, rate=rate, seed=7)
    ref, _ = layer_forward(x.float().view(N, S, D), p, mm=mm, slot0=slot0,
                           **kw)
    out = rows.layer_forward_rows(x, p, S, bf16=dtype == "bfloat16",
                                  slot0=slot0, **kw)
    assert max_diff(out.view_as(ref), ref) <= EXACT
    g = torch.from_numpy(rng.standard_normal(tuple(ref.shape), np.float32))
    dx_ref, g_ref = layer_recompute_backward_plain(
        x.view(N, S, D), g, p, mm=mm, slot0=slot0, **kw)
    dx, grads = rows.layer_backward_rows(
        x, g.reshape(-1, D), p, S, bf16=dtype == "bfloat16", slot0=slot0,
        **kw)
    assert max_diff(dx.view_as(dx_ref), dx_ref) <= EXACT
    for a, b in zip(grads, g_ref):
        assert a.shape == b.shape and max_diff(a, b) <= EXACT
    # without the input's cotangent: the same gradients, no dx
    dx_none, grads2 = rows.layer_backward_rows(
        x, g.reshape(-1, D), p, S, bf16=dtype == "bfloat16", slot0=slot0,
        need_dx=False, **kw)
    assert dx_none is None
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 160])
def test_ffn_and_layer_routes_equal_plain(D, dtype, rate):
    """K11/K12's contract (``ffn_rows_*``) and K9/K10's (``layer_rows_*``)
    composed of the plain pieces equal ``ffn_forward_plain`` /
    ``ffn_backward_plain`` and ``encoder_layer_forward_plain`` /
    ``encoder_layer_backward_plain``."""
    p = layer_params(D, seed=3)
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((N * S, D), np.float32)).to(dt)
    dout = torch.from_numpy(rng.standard_normal((N * S, D), np.float32))
    fp = [p[i] for i in (6, 7, 8, 9, 10, 11)]  # w1 b1 w2 b2 gamma beta
    kw = dict(rate=rate, seed=11, layer=2)
    assert max_diff(rows.ffn_rows_forward(x, *fp, **kw),
                    ffn_forward_plain(x, *fp, **kw)) <= EXACT
    dx_a, g_a = rows.ffn_rows_backward(x, dout, *fp, **kw)
    dx_b, g_b = ffn_backward_plain(x, dout, *fp, **kw)
    assert dx_a.dtype == x.dtype and max_diff(dx_a, dx_b) <= EXACT
    assert all(max_diff(a, b) <= EXACT for a, b in zip(g_a, g_b))
    assert max_diff(rows.layer_rows_forward(x, p, S, **kw),
                    encoder_layer_forward_plain(x, p, S, **kw)) <= EXACT
    dx_a, g_a = rows.layer_rows_backward(x, dout, p, S, **kw)
    dx_b, g_b = encoder_layer_backward_plain(x, dout, p, S, **kw)
    assert dx_a.dtype == x.dtype and max_diff(dx_a, dx_b) <= EXACT
    assert all(max_diff(a, b) <= EXACT for a, b in zip(g_a, g_b))


# ============================================================= 2. vs JAX
D_JAX, T_JAX = 160, 2


def rows_encoder_grads(x, params, w):
    """The whole-encoder route past D = 128 as the card runs it, on the
    plain pieces: ``encoder_train_rows``, then the chain of
    ``recompute_backward_rows`` (the slot-0 layer first); (out, dx, the 12
    stacked gradients)."""
    out, xs = rows.encoder_train_rows(x, params, S, T_JAX, 0.0, None)
    g = w
    dparams = [torch.zeros_like(p) for p in params]
    for t in range(T_JAX - 1, -1, -1):
        xt = (x if t == 0 else xs[t - 1]).view(N, S, D_JAX)
        g, grads = rows.recompute_backward_rows(
            xt, g, params, t, 0.0, None, slot0=(t == T_JAX - 1))
        for acc, dg in zip(dparams, grads):
            acc[t % acc.shape[0]] += dg
    return out, g.reshape(N * S, D_JAX), dparams


def test_whole_encoder_past_128_matches_jax():
    """At D = 160, T = 2 (two stored layers), rate 0: the rows route and
    the port's ``u2gnn_train_encoder`` against ``fused_u2gnn_encoder``
    (interpret mode) and ``neighborhood_encoder`` (XLA), forward and every
    gradient leaf (dx and the 12 stacked tensors)."""
    arrs = enc_arrays(T_JAX, D_JAX, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N * S, D_JAX)).astype(np.float32)
    w = rng.standard_normal((N, D_JAX)).astype(np.float32)
    ko = kernel_order(arrs)

    def fused_loss(p, xx):
        out = fused_u2gnn_encoder(xx, p, None, S, T_JAX, 0.0, N * S, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref_f), (gp_f, gx_f) = jax.value_and_grad(
        fused_loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(a) for a in ko), jnp.asarray(x))

    def xla_loss(p, xx):
        out = jatt.neighborhood_encoder(p, xx.reshape(N, S, D_JAX), 1, 0.0,
                                        None, "neighborhood", T_JAX)
        return jnp.sum(out * jnp.asarray(w)), out

    jp = jatt.TransformerEncoderParams(
        **{k: jnp.asarray(v) for k, v in arrs.items()})
    (_, ref_x), (gp_x, gx_x) = jax.value_and_grad(
        xla_loss, (0, 1), has_aux=True)(jp, jnp.asarray(x))
    want_f = [gx_f] + list(gp_f)
    want_x = [gx_x] + [getattr(gp_x, k) for k in KERNEL_ORDER]

    pt = [torch.from_numpy(a) for a in ko]
    out, dx, dparams = rows_encoder_grads(torch.from_numpy(x), pt,
                                          torch.from_numpy(w))
    pr = [torch.tensor(a, requires_grad=True) for a in ko]
    xr = torch.tensor(x, requires_grad=True)
    out_r = u2gnn_train_encoder(xr, pr, S, T_JAX, 0.0, None)
    got_r = torch.autograd.grad((out_r * torch.from_numpy(w)).sum(),
                                [xr] + pr)
    for ref, want in ((ref_f, want_f), (ref_x, want_x)):
        ref = np.asarray(ref, np.float32)
        for o in (out, out_r):
            assert np.abs(o.detach().numpy() - ref).max() <= FWD_TOL
        assert_leaves([dx.numpy()] + [g.numpy() for g in dparams], want)
        assert_leaves([g.numpy() for g in got_r], want)


def test_layer_and_ffn_past_128_match_jax():
    """At D = 160, rate 0: K9/K10's route (``fused_encoder_layer``, whose
    CPU plain version the rows route equals) against JAX's
    ``fused_encoder_layer`` (interpret mode) and a one-timestep
    ``transformer_encoder`` (XLA); K11/K12's route (``ffn_residual_ln``)
    against JAX's ``ffn_residual_ln`` (interpret mode)."""
    D = D_JAX
    arrs = enc_arrays(1, D, seed=8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((N * S, D)).astype(np.float32)
    w = rng.standard_normal((N * S, D)).astype(np.float32)
    one = [a[0] for a in kernel_order(arrs)]

    def layer_loss(ps, xx):
        out = jax_fused_layer(xx, *ps, None, S, 0.0, 128, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (gp, gx) = jax.value_and_grad(layer_loss, (0, 1),
                                            has_aux=True)(
        [jnp.asarray(a) for a in one], jnp.asarray(x))

    def xla_loss(p, xx):
        out = jatt.transformer_encoder(p, xx.reshape(N, S, D), 1, 0.0, None,
                                       1)
        return jnp.sum(out.reshape(N * S, D) * jnp.asarray(w)), out

    jp = jatt.TransformerEncoderParams(
        **{k: jnp.asarray(v) for k, v in arrs.items()})
    (_, ref_x), (gp_x, gx_x) = jax.value_and_grad(xla_loss, (0, 1),
                                                  has_aux=True)(
        jp, jnp.asarray(x))

    pt = [torch.tensor(a, requires_grad=True) for a in one]
    xt = torch.tensor(x, requires_grad=True)
    out = fused_encoder_layer(xt, *pt, None, S, 0.0, 0)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    dx_r, g_r = rows.layer_rows_backward(torch.from_numpy(x),
                                         torch.from_numpy(w), one_t(one), S)
    for r in (ref, np.asarray(ref_x).reshape(N * S, D)):
        assert np.abs(out.detach().numpy() - np.asarray(r)).max() <= FWD_TOL
        assert np.abs(rows.layer_rows_forward(
            torch.from_numpy(x), one_t(one), S).numpy()
            - np.asarray(r)).max() <= FWD_TOL
    for want in ([gx] + list(gp),
                 [gx_x] + [getattr(gp_x, k)[0] for k in KERNEL_ORDER]):
        assert_leaves([g.numpy() for g in got], want)
        assert_leaves([dx_r.numpy()] + [g.numpy() for g in g_r], want)

    fp = [one[i] for i in (6, 7, 8, 9, 10, 11)]

    def ffn_loss(*args):
        out = jax_ffn(args[0], *args[1:], None, 0.0, 32, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), gj = jax.value_and_grad(ffn_loss, tuple(range(7)),
                                      has_aux=True)(
        jnp.asarray(x), *[jnp.asarray(a) for a in fp])
    ft = [torch.tensor(a, requires_grad=True) for a in fp]
    xt = torch.tensor(x, requires_grad=True)
    out = ffn_residual_ln(xt, *ft)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + ft)
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() <= FWD_TOL
    assert_leaves([g.numpy() for g in got], list(gj))
    dx_r, g_r = rows.ffn_rows_backward(torch.from_numpy(x),
                                       torch.from_numpy(w), *one_t(fp))
    assert_leaves([dx_r.numpy()] + [g.numpy() for g in g_r], list(gj))


def one_t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ========================================================== 3. shape rules
def test_past_128_passes_and_the_rest_raises():
    """D > 128 passes the checks of every route (whole encoder, layer,
    node axis / heads); S = 33 raises; the fused flags' encoders and the
    wide kernels' check (K4tw, K8w, K14w, ...) at D = 160 raise; each
    raise names ROADMAP item 6.  A tensor on neither the CPU nor a CUDA
    device raises in every wrapper."""
    cfgs = [ModelConfig(), ModelConfig(recurrence="gru"),
            ModelConfig(attention_axis="node"), ModelConfig(num_heads=2)]
    for cfg in cfgs:
        check_encoder_shapes(cfg, 5, 1433)
        check_encoder_shapes(cfg, 32, 3703)
    for cfg in cfgs[:2]:
        with pytest.raises(NotImplementedError, match="item 6"):
            check_encoder_shapes(cfg, 33, 160)
    fused = ModelConfig(use_fused_sampler=True, use_pallas=True,
                        use_pallas_whole_encoder=True)
    for flags in (dict(), dict(use_stored_bwd=True), dict(use_folded=True)):
        cfg = dataclasses.replace(fused, **flags)
        with pytest.raises(NotImplementedError, match="item 6"):
            training_encoder(5, 160, cfg)
    with pytest.raises(NotImplementedError, match="item 6"):
        check_wide_shapes(5, 160)
    with pytest.raises(NotImplementedError, match="item 6"):
        rows.attention_forward(torch.zeros(33 * 2, 3 * 160), 33)
    meta = torch.zeros(10, 160, device="meta")
    with pytest.raises(ValueError, match="meta"):
        rows.gemm(meta, meta, "nt")
    with pytest.raises(ValueError, match="meta"):
        rows.res_ln_forward(meta, meta, meta[0], meta[0])
    with pytest.raises(ValueError, match="meta"):
        rows.attention_forward(torch.zeros(10, 480, device="meta"), 5)
