"""The two-pass training path of the PyTorch port: the encoder with its
per-layer recompute backward (plain versions of kernels K4t, K8 and K8s,
``ops/u2gnn_train.py``), ``global_regather``, the k-layer model and the
trainer's dispatch.

The JAX reference is ``fused_u2gnn_encoder`` in interpret mode at rate 0,
whose ``jax.grad`` runs kernel 5's hybrid chain (as in
``tests/test_pallas_u2gnn.py:51-70``), and ``U2GNNSup.apply`` fed the same
global neighborhoods with ``use_pallas`` and ``use_pallas_whole_encoder`` on,
so that it reaches kernels 4 and 5 (``ops/attention.py:393-421``).  At rate
0.5 the random streams cannot match the TPU's, so the port's explicit
backward is held against ``torch.autograd`` through its own plain forward,
and the two-pass path against the fused one, which draw the same bits."""

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
from graph_transformer_tpu.ops.pallas_u2gnn import fused_u2gnn_encoder
from graph_transformer_tpu.ops.sparse import (
    global_regather as jax_global_regather,
)
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.ops.random import layer_seed
from graph_transformer_tpu_torch.ops.sampled_encoder import sampled_encoder
from graph_transformer_tpu_torch.ops.sparse import global_regather
from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
    check_wide_shapes,
    u2gnn_encoder_train_plain,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.models import u2gnn_sup
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    build_neighbor_table,
    sample_neighborhoods_plain,
    sample_neighbors,
)
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
from graph_transformer_tpu_torch.weights import params_from_jax

S, D, F, T, N = 5, 6, 32, 3, 24
TILE = 40  # three JAX tiles of 8 neighborhoods: the grads add across tiles


def make(stored, seed=0, D_=D, S_=S):
    """Weights at the scale of tests/test_torch_encoder.py (LayerNorm scales
    near 1) and rows [N·S, D]."""
    rng = np.random.default_rng(seed)
    shapes = [(stored, D_, 3 * D_), (stored, 3 * D_), (stored, D_, D_),
              (stored, D_), (stored, D_), (stored, D_), (stored, D_, F),
              (stored, F), (stored, F, D_), (stored, D_), (stored, D_),
              (stored, D_)]
    params = [(rng.standard_normal(s) * 0.3).astype(np.float32)
              for s in shapes]
    params[4] += 1.0
    params[10] += 1.0
    x = rng.standard_normal((N * S_, D_)).astype(np.float32)
    w = rng.standard_normal((N, D_)).astype(np.float32)
    return params, x, w


def cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("stored,S_", [(T, S), (1, S), (T, 17)],
                         ids=["3", "1", "3-S17"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recompute_backward_matches_jax_kernel5(dtype, stored, S_):
    """The plain K4t and K8/K8s through ``U2GNNTrainFn`` against ``jax.grad``
    of ``fused_u2gnn_encoder`` (interpret mode, rate 0), weight-tied
    (``stored`` = 1) or not, also at the MUTAG HPO arm's S = 17 (D = 6).
    float32: out and dx to 1e-4, each parameter gradient to 1e-4 of its own
    max; bfloat16: out to 2e-2, dx and each gradient at cosine > 0.999."""
    params, x, w = make(stored, seed=stored, S_=S_)
    jdt = jnp.dtype(dtype)
    tile = TILE // S * S_  # three JAX tiles of 8 neighborhoods

    def loss(p, xx):
        out = fused_u2gnn_encoder(xx, p, None, S_, T, 0.0, tile, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (gj, gxj) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(x, jdt))
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = u2gnn_train_encoder(xt, pt, S_, T, 0.0, None)
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


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_recompute_backward_matches_autograd_f32(rate):
    """The explicit backward (K8s, then K8 per earlier layer, replaying the
    dropout masks) against torch.autograd through the plain K4t, float32,
    to 1e-5."""
    params, x, w = make(T, seed=5)
    pt = [torch.tensor(p, requires_grad=True) for p in params]
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    seed = 77 if rate > 0 else None
    ref, xs = u2gnn_encoder_train_plain(xt, pt, S, T, rate, seed)
    assert xs.shape == (T - 1, N * S, D)
    g_ref = torch.autograd.grad((ref * wt).sum(), [xt] + pt)
    out = u2gnn_train_encoder(xt, pt, S, T, rate, seed)
    g_got = torch.autograd.grad((out * wt).sum(), [xt] + pt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_global_regather_matches_jax():
    """Same rows, ids and mask (padding rows with id 0, as batches pad);
    the output and its cotangent with respect to ``out``."""
    rng = np.random.default_rng(0)
    total, n_real, n_pad, k1 = 40, 13, 16, 5
    gidx = np.zeros(n_pad, np.int32)
    gidx[:n_real] = rng.choice(total, n_real, replace=False)
    mask = (np.arange(n_pad) < n_real).astype(np.float32)
    neigh = gidx[rng.integers(0, n_real, (n_pad, k1))]
    out = rng.standard_normal((n_pad, 3)).astype(np.float32)
    w = rng.standard_normal((n_pad, k1, 3)).astype(np.float32)

    def jf(o):
        r = jax_global_regather(o, jnp.asarray(gidx), jnp.asarray(mask),
                                jnp.asarray(neigh), total)
        return jnp.sum(r * w), r

    (_, ref), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_(True)
    got = global_regather(ot, torch.from_numpy(gidx), torch.from_numpy(mask),
                          torch.from_numpy(neigh), total)
    (gt,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), [ot])
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(AssertionError):
        global_regather(ot, torch.from_numpy(gidx), torch.from_numpy(mask),
                        torch.from_numpy(neigh), 2_000_001)


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


def two_layer_models(k, seed=0, dtype="float32"):
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    jcfg = JaxModelConfig(num_timesteps=T2, num_hidden_layers=k,
                          ff_hidden_size=F2, compute_dtype=dtype,
                          use_pallas=True, use_pallas_whole_encoder=True)
    jm = JaxU2GNNSup(dj.feature_dim, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = U2GNNSup(dt.feature_dim, dt.num_classes,
                  ModelConfig(num_timesteps=T2, num_hidden_layers=k,
                              ff_hidden_size=F2, compute_dtype=dtype))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    return dj, dt, jm, jp, tm


@pytest.mark.parametrize("route,dtype", [
    ("global", "float32"), ("global", "bfloat16"), ("slots", "float32"),
    ("slots", "bfloat16")],
    ids=["float32", "bfloat16", "slots-float32", "slots-bfloat16"])
def test_two_layer_model_matches_jax(dtype, route):
    """k=2 at encoder rate 0: the same global neighborhoods (drawn by the
    port's sampler) go to both packages; JAX re-gathers by global id, the
    port by global id (``global``) or, as its trainer does, by the batch
    slots K7 writes (``slots``).  float32: scores and loss to 1e-4, every
    gradient leaf to 1e-4 of its own max; bfloat16: scores and loss to
    2e-2, every leaf at cosine > 0.999."""
    dj, dt, jm, jp, tm = two_layer_models(2, seed=1, dtype=dtype)
    graphs = [4, 5, 6, 7]
    bj = JaxBuilder(dj, 4, K, seed=3, backend="numpy").build(graphs)
    bt = BatchBuilder(dt, 4, K, seed=3, backend="numpy").build(graphs)
    table = torch.from_numpy(build_neighbor_table(dt, hub_seed=0))
    gidx = bt.node_gidx
    deg = torch.from_numpy(dt.degrees.astype(np.int32))
    neigh_g = sample_neighbors(2024, table[gidx.long()], deg[gidx.long()],
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
    if route == "global":
        scores = tm(bt, neigh_feat=torch.from_numpy(x_global)[neigh_g.long()],
                    neigh_global=neigh_g, num_total_nodes=n)
    else:
        feat, slots, ids = sample_neighborhoods_plain(
            2024, table, deg, torch.from_numpy(x_global), gidx, bt.node_mask,
            K, with_ids=True)
        assert torch.equal(ids, neigh_g)
        scores = tm(dataclasses.replace(bt, neigh=slots), neigh_feat=feat)
    lt = soft_cross_entropy(scores, label_smoothing(bt.labels, C, 0.1))
    lt.backward()
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(sj),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol)
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for key, b in flat.items():
        a = got[key].grad.numpy()
        if dtype == "float32":
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
        else:
            assert cosine(a, b) > 0.999, key


def test_global_path_equals_batch_local_eval_path():
    """Three U2GNN layers: fed the batch's own neighborhoods as global ids
    (features from the dataset table, re-gathers through global_regather),
    the deterministic two-pass forward equals the batch-local eval forward —
    the port's counterpart of tests/test_models.py:198-219."""
    _, dt, _, _, tm = two_layer_models(3, seed=2)
    bt = BatchBuilder(dt, 4, K, seed=3).build([0, 1, 2, 3])
    neigh_g = bt.node_gidx[bt.neigh.long()]
    x_global = torch.from_numpy(dt.node_feat.astype(np.float32))
    a = tm(bt)
    b = tm(bt, neigh_feat=x_global[neigh_g.long()], neigh_global=neigh_g,
           num_total_nodes=dt.num_nodes)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


def forward_rows(model, batch, **kw):
    """(scores, [each U2GNN layer's output on the real rows]) of one
    forward of ``model``."""
    rows, head = [], model._head

    def spy(i, out, b, seed):
        rows.append(out[b.node_mask > 0])
        return head(i, out, b, seed)

    model._head = spy
    try:
        return model(batch, **kw), rows
    finally:
        del model._head


@pytest.mark.parametrize("k", [2, 3])
def test_slot_route_equals_global_route(k):
    """K7's slots as the batch's neighborhoods: with dropout (a seed), every
    U2GNN layer's output on the real rows, and so the scores, equal bit for
    bit the route through ``global_regather`` on K7's global ids.  (Padding
    rows differ: their slots are their own rows.)"""
    ds = synthetic_powerlaw_dataset("S", **DS)
    tm = U2GNNSup(ds.feature_dim, ds.num_classes,
                  ModelConfig(num_timesteps=T2, num_hidden_layers=k,
                              ff_hidden_size=F2), seed=k)
    bt = BatchBuilder(ds, 4, K, seed=k).sample()
    assert bool((bt.node_mask == 0).any())
    table = torch.from_numpy(build_neighbor_table(ds, hub_seed=0))
    deg = torch.from_numpy(ds.degrees.astype(np.int32))
    x_global = torch.from_numpy(ds.node_feat.astype(np.float32))
    feat, slots, ids = sample_neighborhoods_plain(
        99, table, deg, x_global, bt.node_gidx, bt.node_mask, K,
        with_ids=True)
    with torch.no_grad():
        a, rows_a = forward_rows(tm, dataclasses.replace(bt, neigh=slots),
                                 seed=7, neigh_feat=feat)
        b, rows_b = forward_rows(tm, bt, seed=7, neigh_feat=feat,
                                 neigh_global=ids,
                                 num_total_nodes=ds.num_nodes)
    assert len(rows_a) == len(rows_b) == k
    for ra, rb in zip(rows_a, rows_b):
        torch.testing.assert_close(ra, rb, rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trainer_regathers_by_slot(monkeypatch):
    """A two-pass trainer at k=2 re-gathers by K7's slots: training never
    reaches ``global_regather``."""
    def refuse(*args, **kwargs):
        raise AssertionError("global_regather on the trainer's path")

    monkeypatch.setattr(u2gnn_sup, "global_regather", refuse)
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=20,
                                    seed=0, reddit_like=False)
    tr = SupTrainer(ds, small_cfg(2), train_idx=np.arange(9),
                    test_idx=np.arange(9, 12), device="cpu")
    assert tr.two_pass
    losses = tr.train_steps(tr.builder.sample(), 2)
    assert bool(torch.isfinite(losses).all())
    assert np.isfinite(tr.train_epoch())


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_two_pass_equals_fused_at_one_layer(rate, mm):
    """A codebook dataset at one U2GNN layer: K7 + the feature gather + K4t
    give K1's neighborhoods and output exactly for one seed.  With float32
    products the gradients agree to 1e-5.  With bf16 products (the fused
    kernels' only mode) each gradient leaf is held at cosine > 0.99: K8
    recomputes each layer from the bf16 input K4t saved, as kernel 5 does,
    while K2 reads residuals of the unrounded input (ROADMAP Queue C)."""
    rng = np.random.default_rng(4)
    n, C, D_, S_ = 60, 5, 7, 9
    dt = getattr(torch, mm)
    params = [torch.from_numpy(p) for p in make(T, seed=6, D_=D_)[0]]
    tags = torch.from_numpy(rng.integers(0, C, n).astype(np.int32))
    codebook = torch.from_numpy(rng.standard_normal((C, D_))
                                .astype(np.float32))
    table = torch.from_numpy(rng.integers(0, n, (n, 128)).astype(np.int32))
    deg = torch.from_numpy(rng.integers(0, 200, n).astype(np.int32))
    gidx = torch.arange(n, dtype=torch.int32)
    w = torch.from_numpy(rng.standard_normal((n, D_)).astype(np.float32))
    seed = 31337
    outs, grads = [], []
    for path in ("fused", "two-pass"):
        ps = [p.clone().requires_grad_(True) for p in params]
        if path == "fused":
            out = sampled_encoder(tags[table.long()], deg, tags, codebook, ps,
                                  S_, T, rate, seed, mm=dt)
        else:
            neigh = sample_neighbors(seed, table, deg, gidx, S_ - 1)
            x = codebook[tags[neigh.long()].long()].to(torch.bfloat16)
            out = u2gnn_train_encoder(x.to(dt).reshape(n * S_, D_), ps, S_, T,
                                      rate, seed)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * w).sum(), ps))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    for a, b in zip(*grads):
        if mm == "float32":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert cosine(a.numpy(), b.numpy()) > 0.99


def test_layer_seeds():
    assert layer_seed(123, 0) == 123
    seeds = {layer_seed(123, i) for i in range(1, 6)}
    assert len(seeds) == 5 and all(0 <= s < 2**31 for s in seeds)
    assert layer_seed(124, 1) != layer_seed(123, 1)


FUSED_FLAGS = dict(use_fused_sampler=True, use_pallas=True,
                   use_pallas_whole_encoder=True)


def small_cfg(k=1, dtype="float32", **flags):
    return ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16,
                          num_hidden_layers=k, compute_dtype=dtype, **flags),
        train=TrainConfig(num_epochs=1, learning_rate=5e-3))


@pytest.mark.parametrize("case", ["k2", "attributes", "codebook"])
def test_trainer_dispatch(case):
    """With the fused path's three flags set, two U2GNN layers, or
    continuous features, take the two-pass path and train; one layer over a
    codebook keeps the fused path."""
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=20,
                                    seed=0, reddit_like=False)
    k = 2 if case == "k2" else 1
    if case == "attributes":
        ds.node_feat = np.random.default_rng(0).standard_normal(
            (ds.num_nodes, 5)).astype(np.float32)
    tr = SupTrainer(ds, small_cfg(k, **FUSED_FLAGS), train_idx=np.arange(9),
                    test_idx=np.arange(9, 12), device="cpu")
    assert tr.two_pass == (case != "codebook")
    losses = tr.train_steps(tr.builder.sample(), 2)
    assert bool(torch.isfinite(losses).all())
    assert 0.0 <= tr.evaluate() <= 1.0


def test_two_pass_past_d32_raises():
    """Rows past D=32 on the two-pass path take the wide kernels (K4tw,
    K8w), whose shape check the model runs; past D=128 or S=32 they raise
    naming the wide kernels' ROADMAP item.  (The trainer's raise on such
    features: test_unported_configurations_raise.)"""
    for S_, D_ in ((32, 32), (9, 33), (32, 128)):
        check_wide_shapes(S_, D_)
    for S_, D_ in ((9, 129), (33, 8)):
        with pytest.raises(NotImplementedError, match="Rows past D=128"):
            check_wide_shapes(S_, D_)
