"""The per-layer encoder of the PyTorch port against the JAX package: the
plain versions of kernels K9/K10 (``ops/encoder_layer.py``) and K11/K12
(``ops/ffn.py``), ``transformer_encoder`` with every Universal-Transformer
recurrence, ``neighborhood_encoder`` on the node axis and with two heads,
and whole models that take the per-layer path.

JAX runs as its own tests run it (``tests/test_pallas_encoder.py``,
``tests/test_pallas_ffn.py``, ``tests/test_ut_recurrence.py``): Pallas in
interpret mode at rate 0, ``use_pallas`` on, so that its encoder reaches
kernels 14-17.  Inputs and weights are made with numpy from a seed and
handed to both.  Tolerances, float32: outputs within 1e-4, every gradient
leaf within 1e-4 times the larger of 1 and its own largest value (float32
sums in another order); bfloat16 (rows and products, both packages rounding
the same operands): outputs within 2e-2, every gradient leaf at cosine >
0.999."""

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
from graph_transformer_tpu.ops import attention as jatt
from graph_transformer_tpu.ops import ut_recurrence as jut
from graph_transformer_tpu.ops.losses import label_smoothing as jax_smooth
from graph_transformer_tpu.ops.losses import (
    soft_cross_entropy as jax_soft_ce,
)
from graph_transformer_tpu.ops.pallas_encoder import (
    fused_encoder_layer as jax_fused_layer,
)
from graph_transformer_tpu.ops.pallas_ffn import (
    ffn_residual_ln as jax_ffn,
)
from graph_transformer_tpu_torch.config import ModelConfig
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops import attention as tatt
from graph_transformer_tpu_torch.ops import ut_recurrence as tut
from graph_transformer_tpu_torch.ops.attention import FIELDS, KERNEL_ORDER
from graph_transformer_tpu_torch.ops.encoder_layer import (
    check_layer_shapes,
    fused_encoder_layer,
)
from graph_transformer_tpu_torch.ops.ffn import ffn_residual_ln
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    sample_neighbors,
)
from graph_transformer_tpu_torch.weights import params_from_jax

S, D, F, T, N = 5, 6, 16, 3, 9
KINDS = tut.KINDS


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def assert_leaves(got, want, dtype="float32"):
    """float32: each leaf within 1e-4 times the larger of 1 and its own
    largest value; bfloat16: each leaf at cosine > 0.999."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        if dtype == "float32":
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0), i
        else:
            assert cosine(a, b) > 0.999, i


def enc_arrays(stored, seed, D_=D, F_=F):
    """The 12 encoder fields (JAX names) at the scale of
    tests/test_torch_two_pass.py: weights 0.3, LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = dict(w_in=(D_, 3 * D_), b_in=(3 * D_,), w_out=(D_, D_),
                  b_out=(D_,), w_ff1=(D_, F_), b_ff1=(F_,), w_ff2=(F_, D_),
                  b_ff2=(D_,), ln1_scale=(D_,), ln1_bias=(D_,),
                  ln2_scale=(D_,), ln2_bias=(D_,))
    out = {k: (rng.standard_normal((stored,) + s) * 0.3).astype(np.float32)
           for k, s in shapes.items()}
    out["ln1_scale"] += 1.0
    out["ln2_scale"] += 1.0
    return out


def jax_enc(arrs):
    return jatt.TransformerEncoderParams(
        **{k: jnp.asarray(v) for k, v in arrs.items()})


def torch_stack(arrs):
    return [torch.tensor(arrs[k], requires_grad=True) for k in KERNEL_ORDER]


def jax_kernel_order(p):
    """A JAX TransformerEncoderParams (or its grads) in KERNEL_ORDER."""
    return [getattr(p, k) for k in KERNEL_ORDER]


# ----------------------------------------------------------- K9/K10 (plain)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_matches_jax_kernel14_15(dtype):
    """The plain K9 and K10 through ``fused_encoder_layer`` against the JAX
    ``fused_encoder_layer`` (interpret mode, rate 0) and its ``jax.grad``:
    every row out, dx and the 12 gradients."""
    arrs = enc_arrays(1, seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N * S, D)).astype(np.float32)
    w = rng.standard_normal((N * S, D)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    one = [arrs[k][0] for k in KERNEL_ORDER]

    def loss(ps, xx):
        out = jax_fused_layer(xx, *ps, None, S, 0.0, 128, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w)), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        [jnp.asarray(a) for a in one], jnp.asarray(x, jdt))
    pt = [torch.tensor(a, requires_grad=True) for a in one]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = fused_encoder_layer(xt, *pt, None, S, 0.0, 2)
    assert out.dtype == xt.dtype and out.shape == (N * S, D)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              [xt] + pt)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    assert got[0].dtype == xt.dtype
    assert_leaves([g.float().numpy() for g in got],
                  [np.asarray(g, np.float32) for g in (gx,) + tuple(gp)],
                  dtype)


def test_encoder_layer_shapes():
    """K9/K10 take S <= 32 at any D (K9w/K10w past D=32, K18-K20 past
    D=128); more slots name ROADMAP Queue A's item "Rows past D=128 or
    S=32" (item 6)."""
    for S_, D_ in ((32, 32), (9, 33), (32, 128), (9, 129), (5, 1433)):
        check_layer_shapes(S_, D_)
    for S_, D_ in ((33, 8), (33, 129)):
        with pytest.raises(NotImplementedError,
                           match="Queue A, 'Rows past D=128 or S=32', item 6"):
            check_layer_shapes(S_, D_)
    x = torch.zeros(33 * 2, 130)
    with pytest.raises(NotImplementedError, match="K9/K10"):
        fused_encoder_layer(x, *[torch.zeros(1)] * 12, None, 33)


# ---------------------------------------------------------- K11/K12 (plain)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D_,M,F_", [(8, 70, F), (37, 70, F), (65, 37, 100)],
                         ids=["8", "37", "65-M37-F100"])
def test_ffn_matches_jax_kernel16_17(dtype, D_, M, F_):
    """The plain K11 and K12 through ``ffn_residual_ln`` against the JAX
    ``ffn_residual_ln`` (interpret mode, rate 0, 70 or 37 rows: a ragged
    last tile) and its ``jax.grad``: out, dx and the six gradients; also at
    the shapes where K12's tiles have ragged edges (D = 65, F = 100)."""
    rng = np.random.default_rng(D_)
    x = rng.standard_normal((M, D_)).astype(np.float32)
    ps = [(rng.standard_normal(s) * 0.3).astype(np.float32)
          for s in ((D_, F_), (F_,), (F_, D_), (D_,), (D_,), (D_,))]
    ps[4] += 1.0
    w = rng.standard_normal((M, D_)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def loss(xx, *pp):
        out = jax_ffn(xx, *pp, None, 0.0, 32, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w)), out

    (_, ref), g = jax.value_and_grad(loss, tuple(range(7)), has_aux=True)(
        jnp.asarray(x, jdt), *[jnp.asarray(p) for p in ps])
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    pt = [torch.tensor(p, requires_grad=True) for p in ps]
    out = ffn_residual_ln(xt, *pt, seed=None, rate=0.0, layer=1)
    assert out.dtype == xt.dtype
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              [xt] + pt)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    assert_leaves([a.float().numpy() for a in got],
                  [np.asarray(b, np.float32) for b in g], dtype)


def test_ffn_shapes():
    """K11/K12 take D <= 128 and K18 with K20 past it, so rows of any width
    run (here the plain version, D=129: finite, LayerNorm-scaled rows)."""
    rng = np.random.default_rng(0)
    D_, F_ = 129, 8
    x = torch.from_numpy(rng.standard_normal((4, D_), np.float32))
    p = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((D_, F_)) * 0.1, np.zeros(F_),
        rng.standard_normal((F_, D_)) * 0.1, np.zeros(D_), np.ones(D_),
        np.zeros(D_))]
    out = ffn_residual_ln(x, *p)
    assert out.shape == (4, D_) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.mean(-1).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_ffn_backward_matches_autograd(rate):
    """The explicit K12 plain backward (dropout masks replayed from the
    counters) against torch.autograd through the plain K11, float32, 1e-5."""
    from graph_transformer_tpu_torch.ops.ffn import (
        ffn_backward_plain,
        ffn_forward_plain,
    )

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, D)).astype(np.float32))
    ps = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
          for s in ((D, F), (F,), (F, D), (D,), (D,), (D,))]
    w = torch.from_numpy(rng.standard_normal((40, D)).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    pr = [p.clone().requires_grad_(True) for p in ps]
    seed = 11 if rate else None
    out = ffn_forward_plain(xr, *pr, rate=rate, seed=seed, layer=3)
    want = torch.autograd.grad((out * w).sum(), [xr] + pr)
    dx, grads = ffn_backward_plain(x, w, *ps, rate=rate, seed=seed, layer=3)
    for a, b in zip((dx,) + tuple(grads), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- the recurrences
def rec_pair(kind, D_=D, seed=2):
    """The JAX recurrence parameters of ``kind`` and the port's module
    holding the same values (None for basic and skip)."""
    jr = jut.init_recurrence_params(jax.random.key(seed), kind, D_)
    if jr is None:
        assert tut.init_recurrence_params(kind, D_) is None
        return None, None
    tr = tut.init_recurrence_params(kind, D_)
    tr.load_state_dict({f.name: torch.from_numpy(
        np.array(getattr(jr, f.name), np.float32))
        for f in dataclasses.fields(jr)})
    return jr, tr


@pytest.mark.parametrize("kind", KINDS)
def test_transformer_encoder_recurrences_match_jax(kind):
    """``transformer_encoder`` with each recurrence (one tied layer, T=3
    timesteps, rate 0) against the JAX one with ``use_pallas`` (kernel 14
    in interpret mode): the output and the ponder cost; for ``gru`` and
    ``act`` also the gradients of x, the 12 encoder tensors and the
    recurrence's parameters."""
    arrs = enc_arrays(1, seed=4)
    jr, tr = rec_pair(kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, S, D)).astype(np.float32)
    w = rng.standard_normal((N, S, D)).astype(np.float32)

    def run_j(enc, xx, rec):
        out, ponder = jatt.transformer_encoder(
            enc, xx, 1, 0.0, None, T, use_pallas=True, recurrence=kind,
            rec_params=rec, return_ponder=True)
        return jnp.sum(out * jnp.asarray(w)) + ponder, (out, ponder)

    grad = kind in ("gru", "act")
    enc_j = jax_enc(arrs)
    if grad:
        (_, (ref, pj)), (ge, gx, gr) = jax.value_and_grad(
            run_j, (0, 1, 2), has_aux=True)(enc_j, jnp.asarray(x), jr)
    else:
        _, (ref, pj) = run_j(enc_j, jnp.asarray(x), jr)
    pt = torch_stack(arrs)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, pp = tatt.transformer_encoder(pt, xt, 1, 0.0, None, T,
                                       recurrence=kind, rec_params=tr,
                                       return_ponder=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(pp.detach()), float(pj), rtol=1e-5,
                               atol=1e-6)
    if kind == "act":
        assert float(pp.detach()) > 1.0
    if not grad:
        return
    leaves = [xt] + pt + list(tr.parameters())
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum() + pp, leaves)
    want = ([gx] + jax_kernel_order(ge)
            + [getattr(gr, n) for n, _ in tr.named_parameters()])
    assert_leaves([g.numpy() for g in got],
                  [np.asarray(g, np.float32) for g in want])


def test_recurrence_params_match_jax_fields():
    """Each kind's port module holds the JAX dataclass's fields, at the same
    shapes (ACT's ``b_halt`` 0-d), and an unknown kind raises."""
    for kind in KINDS:
        jr = jut.init_recurrence_params(jax.random.key(0), kind, D)
        tr = tut.init_recurrence_params(kind, D)
        if jr is None:
            assert tr is None
            continue
        want = {f.name: np.shape(getattr(jr, f.name))
                for f in dataclasses.fields(jr)}
        assert {n: tuple(p.shape) for n, p in tr.named_parameters()} == want
        assert set(want) <= tut.REC_FIELDS
    with pytest.raises(ValueError):
        tut.init_recurrence_params("nope", D)


# ------------------------------------------- node axis and several heads
@pytest.mark.parametrize("axis,heads", [("node", 1), ("node", 2),
                                        ("neighborhood", 2)])
def test_neighborhood_encoder_matches_jax(axis, heads):
    """``neighborhood_encoder`` on the reference's node axis (padding nodes
    masked out of the softmax) and with two heads, T=2 untied layers, rate
    0, against the JAX one with ``use_pallas`` (XLA attention, then kernel
    16 in interpret mode): the self vectors and the gradients of the rows
    and the 12 encoder tensors."""
    arrs = enc_arrays(2, seed=6)
    rng = np.random.default_rng(7)
    nf = rng.standard_normal((N, S, D)).astype(np.float32)
    mask = (np.arange(N) < N - 3).astype(np.float32)
    w = rng.standard_normal((N, D)).astype(np.float32)

    def run_j(enc, xx):
        out = jatt.neighborhood_encoder(
            enc, xx, heads, 0.0, None, axis=axis, num_timesteps=2,
            node_mask=jnp.asarray(mask), use_pallas=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (ge, gx) = jax.value_and_grad(run_j, (0, 1), has_aux=True)(
        jax_enc(arrs), jnp.asarray(nf))
    pt = torch_stack(arrs)
    xt = torch.from_numpy(nf).requires_grad_(True)
    out = tatt.neighborhood_encoder(pt, xt, heads, 0.0, None, axis, 2,
                                    torch.from_numpy(mask))
    assert out.shape == (N, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + pt)
    assert_leaves([g.numpy() for g in got],
                  [np.asarray(g, np.float32)
                   for g in [gx] + jax_kernel_order(ge)])
    if axis == "node":
        # the padding nodes' features do not reach the real nodes
        nf2 = nf.copy()
        nf2[mask == 0] = 100.0
        out2 = tatt.neighborhood_encoder(pt, torch.from_numpy(nf2), heads,
                                         0.0, None, axis, 2,
                                         torch.from_numpy(mask))
        real = mask > 0
        np.testing.assert_allclose(out2.detach().numpy()[real],
                                   out.detach().numpy()[real], rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------- models
K, T2, F2 = 4, 2, 32
DS = dict(num_graphs=8, num_classes=3, mean_nodes=15, seed=0,
          reddit_like=False)


def flatten_jax(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    for i, rec in enumerate(p.rec):
        if rec is not None:
            for f in dataclasses.fields(rec):
                tree[f"rec.{i}.{f.name}"] = np.asarray(getattr(rec, f.name))
    tree["head_w"] = np.asarray(p.head_w)
    tree["head_b"] = np.asarray(p.head_b)
    return tree


@pytest.mark.parametrize("case", ["k2-highway", "tied-basic"])
def test_model_matches_jax(case):
    """A k=2 model with the highway recurrence (the per-layer path: K9/K10
    in the port, kernels 14/15 in JAX) and a one-layer basic model with
    tied timesteps (``share_timestep_weights``: the whole-encoder path with
    one stored layer), deterministic two-pass forward (rate 0) on the same
    global neighborhoods: scores and loss within 1e-4, every gradient leaf
    (the ``rec.*`` ones included) within 1e-4 of its own largest value."""
    k, kw = ((2, dict(recurrence="highway")) if case == "k2-highway"
             else (1, dict(share_timestep_weights=True)))
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    jm = JaxU2GNNSup(dj.feature_dim, dj.num_classes, JaxModelConfig(
        num_timesteps=T2, num_hidden_layers=k, ff_hidden_size=F2,
        use_pallas=True, use_pallas_whole_encoder=True, **kw))
    jp = jm.init(jax.random.key(3))
    tm = U2GNNSup(dt.feature_dim, dt.num_classes, ModelConfig(
        num_timesteps=T2, num_hidden_layers=k, ff_hidden_size=F2, **kw))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    assert tm.encoders[0].w_in.shape[0] == 1
    graphs = [4, 5, 6, 7]
    bj = JaxBuilder(dj, 4, K, seed=3, backend="numpy").build(graphs)
    bt = BatchBuilder(dt, 4, K, seed=3, backend="numpy").build(graphs)
    table = torch.from_numpy(build_neighbor_table(dt, hub_seed=0))
    gidx = bt.node_gidx
    neigh_g = sample_neighbors(99, table[gidx.long()],
                               torch.from_numpy(dt.degrees)[gidx.long()],
                               gidx, K)
    x_global = dt.node_feat.astype(np.float32)
    C, n = dt.num_classes, dt.num_nodes

    def loss_j(p):
        scores = jm.apply(p, bj, rng=None,
                          neigh_feat=jnp.asarray(x_global)[neigh_g.numpy()],
                          neigh_global=jnp.asarray(neigh_g.numpy()),
                          num_total_nodes=n)
        return jax_soft_ce(scores, jax_smooth(bj.labels, C, 0.1)), scores

    (lj, sj), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    scores, ponder = tm(bt, neigh_feat=torch.from_numpy(x_global)[
        neigh_g.long()], neigh_global=neigh_g, num_total_nodes=n,
        return_ponder=True)
    assert float(ponder) == 0.0
    lt = soft_cross_entropy(scores, label_smoothing(bt.labels, C, 0.1))
    lt.backward()
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(sj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for key, b in flat.items():
        a = got[key].grad.numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-6), key


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("kind", KINDS)
def test_params_from_jax_maps_recurrence_keys(kind):
    """Every recurrence kind's ``rec.<i>.<field>`` keys load into the port's
    model (ACT's 0-d ``b_halt`` included) and give the same values."""
    dj = jax_synthetic("S", **DS)
    jm = JaxU2GNNSup(dj.feature_dim, dj.num_classes, JaxModelConfig(
        num_timesteps=2, num_hidden_layers=2, ff_hidden_size=8,
        recurrence=kind))
    tree = flatten_jax(jm.init(jax.random.key(0)))
    tm = U2GNNSup(dj.feature_dim, dj.num_classes, ModelConfig(
        num_timesteps=2, num_hidden_layers=2, ff_hidden_size=8,
        recurrence=kind))
    sd = params_from_jax(tree)
    tm.load_state_dict(sd)
    rec_keys = {k for k in tree if k.startswith("rec.")}
    assert bool(rec_keys) == (kind not in ("basic", "skip"))
    for key in rec_keys:
        got = dict(tm.named_parameters())[key].detach().numpy()
        assert got.shape == tree[key].shape
        np.testing.assert_array_equal(got, tree[key])
    if kind == "act":
        assert sd["rec.0.b_halt"].dim() == 0


@pytest.mark.parametrize("key", ["rec.0.w_bogus", "rec.x.w_z",
                                 "encoders.0.w_halt", "rec.0"])
def test_params_from_jax_rejects_unknown_rec_keys(key):
    tree = {"head_w": np.zeros((1, 2, 2)), "head_b": np.zeros((1, 2)),
            key: np.zeros(2)}
    with pytest.raises(KeyError):
        params_from_jax(tree)


def test_field_lists_agree_with_jax():
    assert set(FIELDS) == {f.name for f in dataclasses.fields(
        jatt.TransformerEncoderParams)}
