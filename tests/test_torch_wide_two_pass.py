"""The wide two-pass path of the PyTorch port (32 < D <= 128): the plain
versions of kernels K4tw and K8w/K8ws (``ops/u2gnn_train.U2GNNTrainFn``) and
K9w/K10w (``ops/encoder_layer.fused_encoder_layer``), a two-layer model on
IMDB-like degree-tag rows, and the default configuration's path.

The JAX references run in interpret mode at rate 0: ``fused_u2gnn_encoder``
with ``jax.grad`` (kernel 4's forward, kernel 5's hybrid chain),
``fused_encoder_layer`` (kernels 14 and 15) and ``U2GNNSup.apply`` fed the
same global neighborhoods with ``use_pallas`` and
``use_pallas_whole_encoder`` on.  Tolerances: float32 forwards within 1e-4
(the same float32 function, summed in another order); float32 gradient
leaves within 1e-4 of their own largest value and at cosine > 0.9999; bf16
leaves at cosine > 0.999 (both sides round the same operands to bf16, but
a sum that lands beside a rounding boundary rounds the other way)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu.models.u2gnn_sup import U2GNNSup as JaxU2GNNSup
from graph_transformer_tpu.ops.losses import label_smoothing as jax_smooth
from graph_transformer_tpu.ops.losses import (
    soft_cross_entropy as jax_soft_ce,
)
from graph_transformer_tpu.ops.pallas_encoder import (
    fused_encoder_layer as jax_fused_layer,
)
from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops.encoder_layer import fused_encoder_layer
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    u2gnn_encoder_train_plain,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    sample_neighbors,
)
from graph_transformer_tpu_torch.weights import params_from_jax

S, F, T, N = 9, 64, 3, 16
TILE = 72  # two JAX tiles of 8 neighborhoods: the grads add across tiles


def make(D, stored, seed=0):
    """Weights at the scale of tests/test_torch_two_pass.py (LayerNorm
    scales near 1), rows [N·S, D] and an output weighting [N, D]."""
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


def assert_leaves(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        if dtype == "float32":
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0), i
            assert cosine(a, b) > 0.9999, i
        else:
            assert cosine(a, b) > 0.999, i


@pytest.mark.parametrize("D", [40, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_recompute_matches_jax_kernel5(dtype, D):
    """The plain K4tw and K8w/K8ws through ``U2GNNTrainFn`` against
    ``jax.grad`` of ``fused_u2gnn_encoder``: the output (float32 within
    1e-4; bf16 within 2e-2), dx and the 12 gradients."""
    params, x, w = make(D, T, seed=D)
    jdt = jnp.dtype(dtype)

    def loss(p, xx):
        out = fused_u2gnn_encoder(xx, p, None, S, T, 0.0, TILE, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (gj, gxj) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(x, jdt))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = u2gnn_train_encoder(xt, pt, S, T, 0.0, None)
    gt = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    assert out.shape == (N, D) and gt[0].dtype == xt.dtype
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)
    assert_leaves([g.float().numpy() for g in gt],
                  (gxj,) + tuple(gj), dtype)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_wide_recompute_matches_autograd_f32(rate):
    """The explicit backward (K8ws, then K8w per earlier layer, replaying
    the dropout masks) against torch.autograd through the plain K4tw at
    D=40, float32, to 1e-5."""
    params, x, w = make(40, 1, seed=5)
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    seed = 77 if rate > 0 else None
    ref, xs = u2gnn_encoder_train_plain(xt, pt, S, T, rate, seed)
    assert xs.shape == (T - 1, N * S, 40) and xs.dtype == torch.float32
    g_ref = torch.autograd.grad((ref * wt).sum(), [xt] + pt)
    out = u2gnn_train_encoder(xt, pt, S, T, rate, seed)
    g_got = torch.autograd.grad((out * wt).sum(), [xt] + pt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [40, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_encoder_layer_matches_jax_kernel14_15(dtype, D):
    """The plain K9w and K10w through ``fused_encoder_layer`` against the
    JAX ``fused_encoder_layer`` and its ``jax.grad``: every row out, dx and
    the 12 gradients.  float32 rows within 1e-4.  bf16 rows by the wide
    bf16 rule of ``chip_smoke.check_bf16_spread`` (relative L2 <= 1e-2, at
    most 1% of outputs beyond 2e-2 + 2e-2 of |ref|): the outputs are
    themselves bf16, an ulp is 0.008-0.016 at their magnitude, and at
    D >= 40 a product operand that rounds to the other bf16 neighbour moves
    single outputs by a few ulps (0.07 here on 0.7% of them).  float32
    leaves as the module says.  bf16 leaves at cosine > 0.99 against JAX's
    bf16 leaves and against its float32 leaves: at these widths JAX's own
    bf16 leaves lie at cosine 0.9976-0.9990 from its float32 ones, and the
    port's at 0.9940-0.9993 (b_out and w1 lowest at D=40), since both round
    the same operands to bf16 but sum them in other orders."""
    params, x, _ = make(D, 1, seed=D + 1)
    one = [p[0] for p in params]
    w = np.random.default_rng(D).standard_normal((N * S, D)).astype(
        np.float32)
    jdt = jnp.dtype(dtype)

    def loss(ps, xx):
        out = jax_fused_layer(xx, *ps, None, S, 0.0, TILE, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w)), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        [jnp.asarray(a) for a in one], jnp.asarray(x, jdt))
    (gp32, gx32), _ = jax.grad(loss, (0, 1), has_aux=True)(
        [jnp.asarray(a) for a in one], jnp.asarray(x))
    pt = [torch.tensor(a, requires_grad=True) for a in one]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = fused_encoder_layer(xt, *pt, None, S, 0.0, 2)
    assert out.dtype == xt.dtype and out.shape == (N * S, D)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              [xt] + pt)
    a = out.detach().float().numpy()
    b = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    else:
        d = np.abs(a - b)
        assert np.linalg.norm(d) <= 1e-2 * np.linalg.norm(b)
        assert (d > 2e-2 + 2e-2 * np.abs(b)).mean() <= 1e-2
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        assert_leaves(got, (gx,) + tuple(gp), dtype)
    else:
        for i, (a, b, f) in enumerate(zip(got, (gx,) + tuple(gp),
                                          (gx32,) + tuple(gp32))):
            assert cosine(a, b) > 0.99 and cosine(a, f) > 0.99, i


K, T2, F2 = 4, 2, 32
DS = dict(num_graphs=8, num_classes=3, mean_nodes=15, seed=0,
          reddit_like=False)


def flatten_jax(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    tree["head_w"] = np.asarray(p.head_w)
    tree["head_b"] = np.asarray(p.head_b)
    return tree


def degree_tags(ds, D):
    """IMDB-like features: one-hot degree tags over D columns (degrees past
    D-1 share the last column)."""
    return np.eye(D, dtype=np.float32)[np.minimum(ds.degrees, D - 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_two_layer_model_matches_jax(dtype):
    """k=2 at encoder rate 0 on one-hot degree tags of D=65: the same global
    neighborhoods (drawn by the port's sampler) go to both packages.
    float32: scores and loss within 1e-4, every gradient leaf within 1e-4 of
    its own max and at cosine > 0.9999; bf16: scores and loss within 2e-2,
    every leaf at cosine > 0.999."""
    D = 65
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    dj.node_feat = degree_tags(dj, D)
    dt.node_feat = degree_tags(dt, D)
    jcfg = JaxModelConfig(num_timesteps=T2, num_hidden_layers=2,
                          ff_hidden_size=F2, compute_dtype=dtype,
                          use_pallas=True, use_pallas_whole_encoder=True)
    jm = JaxU2GNNSup(D, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(3))
    tm = U2GNNSup(D, dt.num_classes,
                  ModelConfig(num_timesteps=T2, num_hidden_layers=2,
                              ff_hidden_size=F2, compute_dtype=dtype))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    graphs = [0, 1, 2, 3]
    bj = JaxBuilder(dj, 4, K, seed=3, backend="numpy").build(graphs)
    bt = BatchBuilder(dt, 4, K, seed=3, backend="numpy").build(graphs)
    table = torch.from_numpy(build_neighbor_table(dt, hub_seed=0))
    gidx = bt.node_gidx
    neigh_g = sample_neighbors(99, table[gidx.long()],
                               torch.from_numpy(dt.degrees)[gidx.long()], gidx,
                               K)
    x_global = dt.node_feat
    C, n = dt.num_classes, dt.num_nodes

    def loss_j(p):
        scores = jm.apply(p, bj, rng=None,
                          neigh_feat=jnp.asarray(x_global)[neigh_g.numpy()],
                          neigh_global=jnp.asarray(neigh_g.numpy()),
                          num_total_nodes=n)
        return jax_soft_ce(scores, jax_smooth(bj.labels, C, 0.1)), scores

    (lj, sj), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    scores = tm(bt, neigh_feat=torch.from_numpy(x_global)[neigh_g.long()],
                neigh_global=neigh_g, num_total_nodes=n)
    lt = soft_cross_entropy(scores, label_smoothing(bt.labels, C, 0.1))
    lt.backward()
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(sj),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol)
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    assert_leaves([got[k].grad.numpy() for k in flat], list(flat.values()),
                  dtype)
