"""Model, loss, optimizer and trainer of the PyTorch port against the JAX
package: eval scores with converted weights, the rate-0 training loss and
gradient through the sampled encoder, one optax step, the plateau schedule,
and a short CPU training run."""

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
from graph_transformer_tpu.ops.pallas_folded import folded_u2gnn_encoder_grad
from graph_transformer_tpu.ops.pallas_sampled_encoder import (
    setup_fused_tables as jax_fused_tables,
)
from graph_transformer_tpu.ops.sparse import graph_sum_pool as jax_pool
from graph_transformer_tpu.sampling.pallas_sampler import (
    build_neighbor_table as jax_neighbor_table,
)
from graph_transformer_tpu.train import optim as jax_optim
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
from graph_transformer_tpu_torch.ops.sampled_encoder import sampled_encoder
from graph_transformer_tpu_torch.ops.sparse import graph_sum_pool
from graph_transformer_tpu_torch.train import optim
from graph_transformer_tpu_torch.train.sup_trainer import (
    SupTrainer,
    fused_gate_ok,
    train_evaluate_sup,
)
from graph_transformer_tpu_torch.weights import params_from_jax

K, T, F = 4, 2, 32
S = K + 1
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


def models(seed=0):
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    jcfg = JaxModelConfig(num_timesteps=T, ff_hidden_size=F, use_pallas=True,
                          use_pallas_whole_encoder=True)
    jm = JaxU2GNNSup(dj.feature_dim, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = U2GNNSup(dt.feature_dim, dt.num_classes,
                  ModelConfig(num_timesteps=T, ff_hidden_size=F))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    return dj, dt, jm, jp, tm


def test_eval_scores_match_jax():
    dj, dt, jm, jp, tm = models()
    bj = JaxBuilder(dj, 4, K, seed=3, backend="numpy").build([0, 1, 2, 3])
    bt = BatchBuilder(dt, 4, K, seed=3, backend="numpy").build([0, 1, 2, 3])
    ref = jm.apply(jp, bj, rng=None)
    got = tm(bt)
    assert got.shape == (4, dt.num_classes)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_rate0_loss_and_grad_match_jax():
    """sampled encoder -> pool -> head -> label-smoothed CE at rate 0, with
    the same neighbor draws handed to both packages."""
    dj, dt, jm, jp, tm = models(seed=1)
    b = BatchBuilder(dt, 4, K, seed=4).build([4, 5, 6, 7])
    table = jax_neighbor_table(dj, hub_seed=0)
    tag_table, tags, codebook = jax_fused_tables(dj.node_feat, table)
    gidx = b.node_gidx.numpy()
    deg = dj.degrees[gidx]
    rng = np.random.default_rng(5)
    draws = rng.integers(0, np.clip(deg, 1, 128)[:, None], (len(gidx), K))
    tag_rows = tag_table[gidx]
    all_tags = np.concatenate(
        [tags[gidx][:, None], np.take_along_axis(tag_rows, draws, 1)], 1)
    x2d = jnp.asarray(codebook[all_tags].reshape(-1, dj.feature_dim),
                      jnp.bfloat16)
    mask, gid, labels = (b.node_mask.numpy(), b.graph_id.numpy(),
                         b.labels.numpy())
    C = dj.num_classes

    def loss_j(p):
        e = p.encoders[0]
        stacked = (e.w_in, e.b_in, e.w_out, e.b_out, e.ln1_scale,
                   e.ln1_bias, e.w_ff1, e.b_ff1, e.w_ff2, e.b_ff2,
                   e.ln2_scale, e.ln2_bias)
        out = folded_u2gnn_encoder_grad(x2d, stacked, None, S, T, 0.0, 8,
                                        True)
        pooled = jax_pool(out * mask[:, None], gid, 4)
        scores = pooled @ p.head_w[0] + p.head_b[0]
        return jax_soft_ce(scores, jax_smooth(labels, C, 0.1))

    lj, gj = jax.value_and_grad(loss_j)(jp)
    out = sampled_encoder(
        torch.from_numpy(tag_rows), torch.from_numpy(deg),
        torch.from_numpy(tags[gidx]), torch.from_numpy(codebook),
        tm.encoders[0].stacked(), S, T, 0.0, None, torch.from_numpy(draws))
    pooled = graph_sum_pool(out * b.node_mask[:, None], b.graph_id, 4)
    scores = pooled @ tm.head_w[0] + tm.head_b[0]
    lt = soft_cross_entropy(scores, label_smoothing(b.labels, C, 0.1))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-2)
    flat = flatten_jax(gj)
    a = np.concatenate([flat[k].ravel() for k in sorted(flat)])
    g = dict(tm.named_parameters())
    t = np.concatenate([g[k].grad.numpy().ravel() for k in sorted(flat)])
    assert a @ t / (np.linalg.norm(a) * np.linalg.norm(t)) > 0.999


def test_optimizer_steps_match_optax():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 5, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grad_seq = [[(rng.standard_normal(s) * sc).astype(np.float32)
                 for s in shapes] for sc in (3.0, 0.01, 1.0, 0.02)]
    jopt = jax_optim.make_optimizer(5e-4, 0.5)
    pj = [jnp.asarray(p) for p in p0]
    state = jopt.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    topt = optim.make_optimizer(pt, 5e-4, 0.5)
    for step, gs in enumerate(grad_seq):
        if step == 2:
            state = jax_optim.set_lr_scale(state, 0.1)
            optim.set_lr_scale(topt, 0.1)
        upd, state = jopt.update([jnp.asarray(g) for g in gs], state, pj)
        pj = [p + u for p, u in zip(pj, upd)]
        topt.step([torch.from_numpy(g) for g in gs])
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("step_size", [1, 2])
def test_plateau_schedule_matches_jax(step_size):
    losses = [10, 9, 8, 8.5, 7, 7.2, 9, 6, 6.5, 8, 8.1, 9, 9.5, 9.9]
    js = jax_optim.PlateauStepLR(step_size, 0.1, 5)
    ts = optim.PlateauStepLR(step_size, 0.1, 5)
    for i in range(1, len(losses) + 1):
        assert js.update(losses[:i]) == ts.update(losses[:i])
    assert ts.num_steps > 0


def small_cfg(epochs=5):
    return ExperimentConfig(
        data=DataConfig(batch_size=8, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16),
        train=TrainConfig(num_epochs=epochs, learning_rate=5e-3))


def test_train_evaluate_sup_cpu_loss_falls():
    ds = synthetic_powerlaw_dataset("S", num_graphs=40, num_classes=2,
                                    mean_nodes=12, seed=0, reddit_like=False)
    # a learnable label: is the graph larger than the median
    sizes = ds.graph_num_nodes
    ds.labels = (sizes > np.median(sizes)).astype(np.int32)
    logs = []
    out = train_evaluate_sup(ds, small_cfg(), log_fn=logs.append,
                             device="cpu")
    hist = out["history"]
    assert len(hist) == 5 and len(logs) == 5
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(0.0 <= h["test_acc"] <= 1.0 for h in hist)
    losses = out["trainer"].train_steps(out["trainer"].builder.sample(), 2)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    ds = synthetic_powerlaw_dataset("S", num_graphs=4, mean_nodes=8, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        SupTrainer(ds, small_cfg(1), train_idx=np.arange(3),
                   test_idx=np.arange(3, 4))


def test_unported_configurations_raise():
    """Models other than U2GNNSup, and neighborhoods past the kernels of
    each encoder path, raise naming their ROADMAP item: the whole-encoder
    kernels (K4t/K4tw/K8w, K18-K20 past D=128) and the encoder-layer
    kernels (K9/K10, K9w/K10w, K18-K20) at S=33 (Queue A's item "Rows past
    D=128 or S=32", item 6).  Rows of D=130 take every path, and the node
    axis and several heads (plain attention, K11/K12 or K18 and K20) any
    S."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        U2GNNSup(4, 2, ModelConfig(model="gcn"))
    rng = np.random.default_rng(0)
    # continuous features: more than 128 distinct rows, no codebook, so the
    # two-pass path
    ds = synthetic_powerlaw_dataset("S", num_graphs=4, mean_nodes=60, seed=0)
    assert ds.num_nodes > 128
    ds.node_feat = rng.standard_normal((ds.num_nodes, 130)).astype(
        np.float32)
    for K, kw, match in ((32, {}, "Rows past D=128"),
                         (32, dict(recurrence="gru"), "K9/K10"),
                         (32, dict(attention_axis="node"), None),
                         (32, dict(num_heads=2), None),
                         (3, {}, None), (3, dict(recurrence="gru"), None)):
        cfg = small_cfg(1)
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, num_neighbors=K),
            model=dataclasses.replace(cfg.model, **kw))
        if match is None:
            SupTrainer(ds, cfg, train_idx=np.arange(3),
                       test_idx=np.arange(3, 4), device="cpu")
            continue
        with pytest.raises(NotImplementedError, match=match) as err:
            SupTrainer(ds, cfg, train_idx=np.arange(3),
                       test_idx=np.arange(3, 4), device="cpu")
        assert "item 6" in str(err.value)


def test_params_from_jax_rejects_unknown_keys():
    with pytest.raises(KeyError):
        params_from_jax({"head_w": np.zeros((1, 2, 2)),
                         "head_b": np.zeros((1, 2)),
                         "encoders.0.w_bogus": np.zeros(1)})


def codebook_ds():
    """A one-hot 4-tag dataset: its features factor through a codebook, so
    only the configuration decides the path."""
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=20, seed=0,
                                    reddit_like=False)
    tags = np.random.default_rng(0).integers(0, 4, ds.num_nodes)
    ds.node_feat = np.eye(4, dtype=np.float32)[tags]
    return ds


@pytest.mark.parametrize("kw", [{}, dict(recurrence="gru"),
                                dict(attention_axis="node"),
                                dict(num_heads=2)],
                         ids=["basic", "gru", "node", "heads2"])
def test_fused_gate_sends_per_layer_configs_to_two_pass(kw):
    """With the fused path's three flags set, one U2GNN layer over a
    codebook keeps the fused path only for a basic, single-head,
    neighborhood-axis encoder (the JAX ``fused_gate_ok``); a recurrence,
    the node axis or two heads take the two-pass path with the per-layer
    encoder, and train."""
    cfg = small_cfg(1)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, num_timesteps=2, use_fused_sampler=True, use_pallas=True,
        use_pallas_whole_encoder=True, **kw))
    tr = SupTrainer(codebook_ds(), cfg, train_idx=np.arange(9),
                    test_idx=np.arange(9, 12), device="cpu")
    assert fused_gate_ok(cfg.model) == (not kw)
    assert tr.two_pass == bool(kw)
    losses = tr.train_steps(tr.builder.sample(), 2)
    assert bool(torch.isfinite(losses).all())
    assert 0.0 <= tr.evaluate() <= 1.0


@pytest.mark.parametrize("kind", ["act", "gru"])
def test_act_loss_adds_ponder(kind):
    """With ``recurrence="act"`` a training step's loss is the soft cross
    entropy plus 0.01 (``act_loss_weight``) times the ponder cost; other
    recurrences add nothing."""
    cfg = small_cfg(1)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, recurrence=kind))
    ds = codebook_ds()
    tr = SupTrainer(ds, cfg, train_idx=np.arange(9),
                    test_idx=np.arange(9, 12), device="cpu")
    batch = tr.builder.sample()
    scores, ponder = tr._scores(batch, tr.step_inputs(batch), 1234)
    ce = soft_cross_entropy(scores, label_smoothing(batch.labels,
                                                    ds.num_classes, 0.1))
    loss = tr.loss(batch, scores, ponder)
    if kind == "act":
        assert tr.act_weight == 0.01 and float(ponder.detach()) > 1.0
        torch.testing.assert_close(loss, ce + 0.01 * ponder)
    else:
        assert tr.act_weight == 0.0 and float(ponder) == 0.0
        torch.testing.assert_close(loss, ce)
