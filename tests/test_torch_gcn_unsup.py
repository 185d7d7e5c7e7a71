"""The port's unsupervised GCN baseline for graph classification
(``models/gcn_unsup_graphs.py``, ``UnsupTrainer(model="gcn_unsup")``)
against the JAX package's ``GCNGraphUnsup``, weights carried across by
``params_from_jax``, on one batch of a small dataset built by both
packages' default builders (their C++ assemblers):

1. ``encode`` at dropout 0 (JAX ``rng=None``, the port without a seed), 1
   and 2 layers: within 1e-5 of the output's largest magnitude.
2. ``loss`` in both sampled-softmax modes, ``vocab_perm`` on and off, with
   JAX's candidates and P(k) table handed in: the loss and every gradient
   leaf within 1e-5 of each leaf's largest magnitude (as
   ``tests/test_torch_unsup_model.py`` holds ``U2GNNUnsup``);
   ``node_embeddings`` with and without ``vocab_perm``.
3. The trainer builds the model with no neighbor table, its losses fall
   and repeat for one seed, and dropout draws repeat for one seed.
"""

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
from graph_transformer_tpu.models.gcn_unsup_graphs import (
    GCNGraphUnsup as JaxGCNUnsup,
)
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models.gcn_unsup_graphs import GCNGraphUnsup
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer
from graph_transformer_tpu_torch.weights import params_from_jax
from test_torch_batcher import jax_assembler

H, NS = 16, 32
DS = dict(num_graphs=10, num_classes=2, mean_nodes=12, seed=0,
          reddit_like=False)
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread: under the test run's parallel workers
    the default pool is many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten_jax(p):
    tree = {}
    for i, layer in enumerate(p.layers):
        tree[f"layers.{i}.w"] = np.asarray(layer.w)
        tree[f"layers.{i}.b"] = np.asarray(layer.b)
    tree["ss.weight"] = np.asarray(p.ss.weight)
    tree["ss.bias"] = np.asarray(p.ss.bias)
    return tree


def close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, top = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def setup(k, seed=0, **model_kw):
    jax_assembler()
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    kw = dict(num_hidden_layers=k, ff_hidden_size=H, sampled_num=NS,
              model="gcn_unsup", **model_kw)
    jm = JaxGCNUnsup(dj.feature_dim, dj.num_nodes, JaxModelConfig(**kw))
    jp = jm.init(jax.random.key(seed))
    tm = GCNGraphUnsup(dt.feature_dim, dt.num_nodes, ModelConfig(**kw))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    graphs = [1, 4, 7, 9]
    bj = JaxBuilder(dj, 4, 3, seed=seed).build(graphs)
    bt = BatchBuilder(dt, 4, 3, seed=seed).build(graphs)
    for f in ("x", "neigh", "edge_src", "edge_dst", "edge_mask"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)))
    return dj, dt, jm, jp, tm, bj, bt


@pytest.mark.parametrize("k", [1, 2])
def test_encode_matches_jax(k):
    _, _, jm, jp, tm, bj, bt = setup(k, seed=k)
    zj = jm.encode(jp, bj, rng=None)
    zt = tm.encode(bt)
    assert zt.shape == (bt.n_pad, k * H) == tuple(zj.shape)
    assert tm.embedding_dim == jm.embedding_dim == k * H
    close(zt.detach().numpy(), zj, "z")


@pytest.mark.parametrize("k,mode,perm", [(1, "tf", False), (2, "tf", True),
                                         (2, "reference", False),
                                         (1, "reference", True)])
def test_loss_and_grads_match_jax(k, mode, perm, monkeypatch):
    dj, _, jm, jp, tm, bj, bt = setup(k, seed=5 + k,
                                      sampled_softmax_mode=mode)
    V = dj.num_nodes
    key = jax.random.key(11)
    vp = np.random.default_rng(4).permutation(V) if perm else None
    lj, gj = jax.value_and_grad(lambda p: jm.loss(
        p, bj, key, jm.spec(), rng=None,
        vocab_perm=None if vp is None else jnp.asarray(vp, jnp.int32)))(jp)
    ids = np.array(jlu.sample_log_uniform_unique(key, V, NS))
    table = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    monkeypatch.setattr(sampled_softmax, "probs_table", lambda v, d: table)
    lt = tm.loss(bt, tm.spec(), candidates=(torch.from_numpy(ids), None),
                 vocab_perm=None if vp is None else torch.from_numpy(vp))
    lt.backward()
    close(float(lt.detach()), float(lj), "loss")
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for name, g in flat.items():
        t = got[name].grad
        close(np.zeros_like(g) if t is None else t.numpy(), g, name)


def test_node_embeddings_with_and_without_perm():
    dj, _, jm, jp, tm, _, _ = setup(2)
    vp = np.random.default_rng(0).permutation(dj.num_nodes)
    close(tm.node_embeddings().detach().numpy(), jm.node_embeddings(jp))
    got = tm.node_embeddings(torch.from_numpy(vp)).detach().numpy()
    close(got, jm.node_embeddings(jp, jnp.asarray(vp)))
    np.testing.assert_array_equal(got, tm.ss.weight.detach().numpy()[vp])


def test_seeded_dropout_repeats_and_differs():
    *_, tm, _, bt = setup(2)
    with torch.no_grad():
        a, b = tm.encode(bt, 3), tm.encode(bt, 3)
        c, d = tm.encode(bt, 4), tm.encode(bt)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    with pytest.raises(ValueError, match="seed"):
        tm.loss(bt, tm.spec())


def cfg(**train):
    return ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=2),
        model=ModelConfig(model="gcn_unsup", num_hidden_layers=2,
                          ff_hidden_size=H, sampled_num=NS),
        train=TrainConfig(num_epochs=1, learning_rate=1e-2, **train))


def test_trainer_builds_trains_and_repeats():
    """JAX's ``test_unsup_trainer_gcn_backend`` on the port: no neighbor
    table, finite falling epoch losses, a probe mean in [0, 1], and two
    trainers of one seed equal."""
    ds = synthetic_powerlaw_dataset("S", **dict(DS, num_graphs=40))
    runs = []
    for _ in range(2):
        t = UnsupTrainer(ds, cfg(), device="cpu")
        assert t.gcn and isinstance(t.model, GCNGraphUnsup)
        assert not hasattr(t, "_nbr_table") and t.csr is None
        runs.append([t.train_epoch() for _ in range(8)])
    losses = runs[0]
    assert np.all(np.isfinite(losses)) and runs[0] == runs[1]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    mean, std = t.evaluate()
    assert 0.0 <= mean <= 1.0
    host = UnsupTrainer(ds, cfg(on_device_sampling=False), device="cpu")
    assert np.isfinite(host.train_epoch())


def test_trainer_step_is_the_models_loss():
    """A trainer step's loss is the model's summed sampled softmax at the
    step's seed (dropout and candidates from it)."""
    ds = synthetic_powerlaw_dataset("S", **DS)
    t = UnsupTrainer(ds, cfg(), device="cpu")
    batch, seed = t.builder.sample(), 1234
    with torch.no_grad():
        want = t.model.loss(batch, t.spec, seed)
    got = t.train_step(batch, seed)
    assert float(got) == float(want)
