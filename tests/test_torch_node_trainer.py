"""The node path of the port (``train/node_trainer.py``, ``cli/train_node.py``)
against the JAX package's.

1. The node model, ``U2GNNUnsup(head="cross_attention")`` with the
   vocabulary the node count, at D = 160 (past the wide kernels' D = 128)
   on a 60-node SBM's whole-graph batch, weights carried by
   ``params_from_jax``: JAX at ``rng=None``, the port without a seed
   (deterministic, float32); the encoder output and, for the GAE,
   contrastive and default (tf, JAX's candidates and P(k) table handed in)
   losses, the loss and every gradient leaf within 1e-5 of each leaf's
   largest magnitude (float32 sums in another order).  The same in bf16
   (``compute_dtype="bfloat16"``: the rows rounded to bf16, products of
   bf16-rounded operands summed in float32 in both packages, XLA's and the
   port's plain K18-K20 at different places and orders): z and the loss
   within relative L2 5e-3, each gradient leaf at cosine > 0.995 (the CPU
   reads 2.7e-3 on z, 2.7e-5 on the loss and 0.99907 on the worst leaf);
   and the port's bf16 z at least 1e-3 from its own float32 z (2.9e-3;
   a run that kept float32 would read 0).
2. JAX's own node-trainer cases (``tests/test_node_classification.py``:
   u2gnn with the sampled softmax and the 2-fold probe, the neighbor
   sampler, the contrastive head on a padded batch) on the port on the
   CPU; ``gcn`` and ``gat`` build and train (``test_torch_gcn_gat.py`` holds
   them to JAX), an unknown node model raises.
3. ``cli.train_node.main`` on karate, and on a small Planetoid-format file
   of ``chip_smoke.write_planetoid_like``: every eval mode, finite losses,
   metrics in [0, 1]; the trainer's steps repeat for one seed.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.citation import (
    sbm_synthetic as jax_sbm,
)
from graph_transformer_tpu.models.u2gnn_unsup import U2GNNUnsup as JaxUnsup
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu.sampling.neighbors import DeviceCSR as JaxCSR
from graph_transformer_tpu_torch.cli import train_node
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import whole_dataset_batch
from graph_transformer_tpu_torch.data.citation import (
    karate_club,
    sbm_synthetic,
)
from graph_transformer_tpu_torch.models.u2gnn_unsup import U2GNNUnsup
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.sampling.neighbors import DeviceCSR
from graph_transformer_tpu_torch.train.node_trainer import (
    NodeTrainer,
    train_evaluate_node,
)
from graph_transformer_tpu_torch.weights import params_from_jax
from test_torch_batcher import jax_assembler

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = 1e-5
BF16_REL, BF16_COS = 5e-3, 0.995  # bf16: z and the loss; each gradient leaf
BF16_MOVES = 1e-3  # the least relative L2 of bf16 z from float32 z
K, F, NS, D_WIDE = 4, 32, 16, 160


@pytest.fixture(autouse=True)
def one_thread():
    """The trainer tests run torch on one intra-op thread: under the test
    run's parallel workers the default pool is many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten_jax(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    tree["ss.weight"] = np.asarray(p.ss.weight)
    tree["ss.bias"] = np.asarray(p.ss.bias)
    for f in dataclasses.fields(p.cross_attn):
        tree[f"cross_attn.{f.name}"] = np.asarray(getattr(p.cross_attn,
                                                          f.name))
    tree["weight"] = np.asarray(p.weight)
    return tree


def close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, top = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def setup(seed, **kw):
    """The two packages' node models at D = 160 on a 60-node SBM, one
    whole-graph batch each (JAX's builder on its numpy path)."""
    ds_kw = dict(num_nodes=60, num_classes=3, feature_dim=D_WIDE, seed=2)
    dj, dt = jax_sbm(**ds_kw), sbm_synthetic(**ds_kw)
    mk = dict(num_timesteps=1, num_hidden_layers=1, ff_hidden_size=F,
              sampled_num=NS, **kw)
    jm = JaxUnsup(dj.feature_dim, dj.num_nodes, JaxModelConfig(**mk),
                  "cross_attention")
    jp = jm.init(jax.random.key(seed))
    tm = U2GNNUnsup(dt.feature_dim, dt.num_nodes, ModelConfig(**mk),
                    "cross_attention")
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    jax_assembler()
    bj = JaxBuilder(dj.graph, 1, K, pad_multiple=32, seed=4,
                    backend="native").build(np.arange(1))
    bt = whole_dataset_batch(dt.graph, K, pad_multiple=32, seed=4)
    np.testing.assert_array_equal(np.asarray(bj.neigh), bt.neigh.numpy())
    assert bt.n_pad == 64 and dt.feature_dim == D_WIDE
    return dj, dt, jm, jp, tm, bj, bt


def test_encode_past_128_matches_jax():
    _, _, jm, jp, tm, bj, bt = setup(1)
    zj = jm.encode(jp, bj, rng=None)
    zt = tm.encode(bt)
    close(zt.detach().numpy(), zj, "z")


@pytest.mark.parametrize("loss_type", ["gae", "contrastive", "default"])
def test_node_loss_and_grads_match_jax(loss_type, monkeypatch):
    dj, dt, jm, jp, tm, bj, bt = setup(3, loss_type=loss_type)
    V = dj.num_nodes
    key = jax.random.key(7)
    adj = dt.dense_adj(bt.n_pad)

    def loss_j(p):
        return jm.loss(p, bj, key, jm.spec(), rng=None,
                       adj_mask=jnp.asarray(adj))

    lj, gj = jax.value_and_grad(loss_j)(jp)
    ids = np.array(jlu.sample_log_uniform_unique(key, V, NS))
    table = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    monkeypatch.setattr(sampled_softmax, "probs_table", lambda v, d: table)
    lt = tm.loss(bt, tm.spec(), candidates=(torch.from_numpy(ids), None),
                 adj_mask=torch.from_numpy(adj))
    lt.backward()
    close(float(lt.detach()), float(lj), "loss")
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for name, g in flat.items():
        t = got[name].grad
        close(np.zeros_like(g) if t is None else t.numpy(), g, name)


def close_bf16(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    assert rel <= BF16_REL, (what, rel)


def cosine_bf16(a, b, what=""):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if nb == 0.0:
        assert na == 0.0, (what, na)
        return
    cos = a @ b / max(na * nb, 1e-300)
    assert cos > BF16_COS, (what, cos)


def test_encode_past_128_matches_jax_bf16():
    _, _, jm, jp, tm, bj, bt = setup(1, compute_dtype="bfloat16")
    zj = jm.encode(jp, bj, rng=None)
    zt = tm.encode(bt).detach().float().numpy()
    close_bf16(zt, np.asarray(zj, np.float32), "z")
    _, _, _, _, tm32, _, bt32 = setup(1)
    z32 = tm32.encode(bt32).detach().numpy().astype(np.float64)
    moved = np.linalg.norm(zt - z32) / np.linalg.norm(z32)
    assert moved >= BF16_MOVES, ("bf16 z against float32 z", moved)


@pytest.mark.parametrize("loss_type", ["gae", "contrastive", "default"])
def test_node_loss_and_grads_match_jax_bf16(loss_type, monkeypatch):
    dj, dt, jm, jp, tm, bj, bt = setup(3, loss_type=loss_type,
                                       compute_dtype="bfloat16")
    V = dj.num_nodes
    key = jax.random.key(7)
    adj = dt.dense_adj(bt.n_pad)

    def loss_j(p):
        return jm.loss(p, bj, key, jm.spec(), rng=None,
                       adj_mask=jnp.asarray(adj))

    lj, gj = jax.value_and_grad(loss_j)(jp)
    ids = np.array(jlu.sample_log_uniform_unique(key, V, NS))
    table = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    monkeypatch.setattr(sampled_softmax, "probs_table", lambda v, d: table)
    lt = tm.loss(bt, tm.spec(), candidates=(torch.from_numpy(ids), None),
                 adj_mask=torch.from_numpy(adj))
    lt.backward()
    close_bf16(float(lt.detach()), float(lj), "loss")
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for name, g in flat.items():
        t = got[name].grad
        cosine_bf16(np.zeros_like(g) if t is None else t.numpy(), g, name)


# ----------------------------------------------- JAX's node-trainer cases
def _cfg(model="u2gnn", loss_type="default", **model_kw):
    """``tests/test_node_classification.py``'s configuration."""
    return ExperimentConfig(
        data=DataConfig(num_neighbors=4, pad_multiple=32),
        model=ModelConfig(model=model, num_timesteps=1, num_hidden_layers=1,
                          ff_hidden_size=16, sampled_num=8,
                          loss_type=loss_type, **model_kw),
        train=TrainConfig(num_epochs=2, learning_rate=1e-3))


def test_node_trainer_u2gnn_sampled_softmax():
    ds = karate_club()
    out = train_evaluate_node(ds, _cfg(), eval_mode="2fold",
                              log_fn=lambda *_: None, device="cpu")
    assert np.isfinite(out["history"][-1]["loss"])
    assert 0.0 <= out["best_metric"] <= 1.0


@pytest.mark.parametrize("model,loss_type", [("gat", "contrastive"),
                                             ("gcn", "gae")])
def test_node_baselines_raise(model, loss_type):
    """JAX's baseline cases (gat contrastive, gcn gae) train a step on the
    port; only an unknown node model raises."""
    t = NodeTrainer(karate_club(), _cfg(model, loss_type=loss_type),
                    device="cpu")
    assert np.isfinite(t.train_epoch())
    assert t.node_embeddings().shape == (34, 2)
    with pytest.raises(ValueError, match="unknown node model"):
        NodeTrainer(karate_club(), _cfg("gin", loss_type=loss_type),
                    device="cpu")


def test_node_trainer_neighbor_sampler():
    t = NodeTrainer(karate_club(), _cfg(sampler_type="neighbor"),
                    device="cpu")
    assert np.isfinite(t.train_epoch())


def test_u2gnn_contrastive_head_padded_batch():
    """The fork's contrastive head trains the vocabulary-sized table while
    the batch is padded (JAX's regression case)."""
    ds = sbm_synthetic(num_nodes=60, seed=0)
    cfg = ExperimentConfig(
        data=DataConfig(num_neighbors=4),
        model=ModelConfig(model="u2gnn", num_timesteps=1,
                          num_hidden_layers=2, ff_hidden_size=16,
                          sampled_num=8, loss_type="contrastive"),
        train=TrainConfig(num_epochs=1, learning_rate=0.1))
    tr = NodeTrainer(ds, cfg, device="cpu")
    assert tr.batch.n_pad > ds.num_nodes
    assert np.isfinite(tr.train_epoch())
    assert 0.0 <= tr.evaluate_masks() <= 1.0


def test_steps_repeat_for_one_seed():
    """Two trainers of one configuration take the same steps: the seeds,
    neighborhoods, dropout and candidates are functions of the seed."""
    losses = []
    for _ in range(2):
        t = NodeTrainer(sbm_synthetic(num_nodes=60, feature_dim=D_WIDE,
                                      seed=1), _cfg(), device="cpu")
        losses.append([t.train_epoch() for _ in range(3)])
        emb = t.node_embeddings()
    assert losses[0] == losses[1]
    assert emb.shape == (60, D_WIDE)


# ------------------------------------------------------------------- CLI
def test_cli_on_karate(capsys):
    metric = train_node.main(["--node_dataset", "karate", "--num_epochs",
                              "2", "--ff_hidden_size", "8", "--sampled_num",
                              "8", "--num_neighbors", "2", "--device", "cpu"])
    assert 0.0 <= metric <= 1.0
    assert "node data: karate, 34 nodes" in capsys.readouterr().out
    metric = train_node.main(["--node_model", "gcn", "--num_epochs", "2",
                              "--ff_hidden_size", "8", "--sampled_num", "8",
                              "--device", "cpu"])
    assert 0.0 <= metric <= 1.0
    assert "best masks metric" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["masks", "2fold", "kmeans"])
def test_cli_on_planetoid_like_file(tmp_path, mode, capsys):
    """A Planetoid-format file of ``chip_smoke.write_planetoid_like`` at a
    small size (the card runs it at Cora's), every eval mode, features of
    D = 150 (past 128)."""
    labels = chip_smoke.write_planetoid_like(
        str(tmp_path), num_feats=150, class_sizes=(30, 20, 25), n_train=12,
        n_val=15, n_test=30, num_edges=140, class_words=20)
    assert len(labels) == 75
    emb = str(tmp_path / "emb.npy")
    metric = train_node.main([
        "--node_dataset", "cora", "--citation_dir", str(tmp_path),
        "--num_epochs", "2", "--eval_every", "1", "--ff_hidden_size", "16",
        "--sampled_num", "16", "--eval_mode", mode, "--device", "cpu",
        "--save_embeddings", emb])
    assert 0.0 <= metric <= 1.0
    out = capsys.readouterr().out
    assert "75 nodes" in out and "feature dim 150" in out
    assert np.load(emb).shape == (75, 150)
