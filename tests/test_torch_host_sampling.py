"""Host sampling in the PyTorch port: ``TrainConfig.on_device_sampling``
off (the CLI's ``--host_sampling``) trains on the host batch's own
neighborhoods, as the JAX trainer does (``train/sup_trainer.py:71, 80-81,
157-158``; ``models/u2gnn_sup.py:184-186, 232-233``).

The JAX reference is ``U2GNNSup.apply(p, batch, rng=None)`` on the same
host batch, which gathers ``x[batch.neigh]`` and re-gathers
``out[batch.neigh]`` between U2GNN layers.  Its ``rng=None`` pass draws no
dropout, so the port's seeded forward is held against it with the
encoder's and the head's dropout at 0."""

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
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models import u2gnn_sup
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.ops.losses import (
    label_smoothing,
    soft_cross_entropy,
)
from graph_transformer_tpu_torch.train import sup_trainer
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
from graph_transformer_tpu_torch.weights import params_from_jax

K, T, F = 4, 2, 32
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


def models(k, seed=0):
    """The JAX and the port's model with the same weights; the port's head
    dropout at 0."""
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    jcfg = JaxModelConfig(num_timesteps=T, num_hidden_layers=k,
                          ff_hidden_size=F, use_pallas=True,
                          use_pallas_whole_encoder=True)
    jm = JaxU2GNNSup(dj.feature_dim, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = U2GNNSup(dt.feature_dim, dt.num_classes,
                  ModelConfig(num_timesteps=T, num_hidden_layers=k,
                              ff_hidden_size=F, dropout=0.0))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    return dj, dt, jm, jp, tm


@pytest.mark.parametrize("k", [1, 2])
def test_host_sampled_forward_matches_jax(k, monkeypatch):
    """At dropout 0 the port's host-sampled training forward (a seed and no
    neighborhoods given) against JAX's ``apply(p, batch, rng=None)`` on the
    same host batch: scores, loss and every gradient leaf within 1e-4 (the
    leaves of their own max) in float32."""
    monkeypatch.setattr(u2gnn_sup, "ENCODER_DROPOUT", 0.0)
    dj, dt, jm, jp, tm = models(k, seed=k)
    graphs = [1, 3, 5, 6]
    bj = JaxBuilder(dj, 4, K, seed=4, backend="numpy").build(graphs)
    bt = BatchBuilder(dt, 4, K, seed=4, backend="numpy").build(graphs)
    np.testing.assert_array_equal(np.asarray(bj.neigh), bt.neigh.numpy())
    C = dt.num_classes

    def loss_j(p):
        scores = jm.apply(p, bj, rng=None)
        return jax_soft_ce(scores, jax_smooth(bj.labels, C, 0.1)), scores

    (lj, sj), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    scores = tm(bt, seed=2024)
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
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key


def test_seeded_forward_trains_not_evaluates():
    """``forward(batch, seed=s)`` with no neighborhoods given trains with
    dropout: it differs from the evaluation pass, repeats for one seed and
    equals the two-pass path fed the same neighborhoods as global ids (its
    re-gathers ``out[batch.neigh]`` agree with ``global_regather`` on the
    batch's rows)."""
    _, dt, _, _, tm = models(2, seed=3)
    tm.cfg = dataclasses.replace(tm.cfg, dropout=0.5)
    bt = BatchBuilder(dt, 4, K, seed=5).build([0, 2, 4, 7])
    a = tm(bt, seed=99)
    torch.testing.assert_close(tm(bt, seed=99), a, rtol=0, atol=0)
    assert not torch.allclose(a, tm(bt), atol=1e-3)
    neigh_g = bt.node_gidx[bt.neigh.long()]
    x_global = torch.from_numpy(dt.node_feat.astype(np.float32))
    b = tm(bt, seed=99, neigh_feat=x_global[neigh_g.long()],
           neigh_global=neigh_g, num_total_nodes=dt.num_nodes)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(a.sum(), [tm.encoders[0].w_in])
    assert float(g.abs().max()) > 0.0


@pytest.mark.parametrize("flags", [{}, dict(use_fused_sampler=True,
                                            use_pallas=True,
                                            use_pallas_whole_encoder=True)])
def test_trainer_without_on_device_sampling(flags, monkeypatch):
    """``on_device_sampling=False``: no neighbor table, no fused tables, no
    sampler call (the fused flags too take the host path, as JAX's tables
    need the flag on); an epoch trains to a finite loss and evaluates."""
    def refuse(*a, **kw):
        raise AssertionError("called with on_device_sampling off")

    for name in ("sample_neighborhoods", "build_neighbor_table",
                 "setup_fused_tables"):
        monkeypatch.setattr(sup_trainer, name, refuse)
    ds = synthetic_powerlaw_dataset("S", num_graphs=16, num_classes=2,
                                    mean_nodes=10, seed=1, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=16, **flags),
        train=TrainConfig(num_epochs=1, learning_rate=5e-3,
                          on_device_sampling=False))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16), device="cpu")
    assert tr.host_sampling and tr.two_pass
    assert not hasattr(tr, "_nbr_table") and not hasattr(tr, "_tag_table")
    loss = tr.train_epoch()
    assert np.isfinite(loss)
    losses = tr.train_steps(tr.builder.sample(), 3)
    assert bool(torch.isfinite(losses).all())
    assert 0.0 <= tr.evaluate() <= 1.0
