"""The port's multiplex model and trainer (``models/multilayer.py``,
``train/ml_node_trainer.py``, ``cli/node_classification.py``) against the
JAX package's.

1. ``build_multiplex_batch`` equals JAX's array for array over 3 steps of one
   seed (the same ``np.random.Generator`` draws).
2. ``MultilayerU2GNN``'s loss and every gradient leaf at rate 0 (JAX
   ``rng=None``, the port without a seed) within 1e-5 of each leaf's largest
   magnitude, float32 sums in another order: siamese and multi,
   contrastive and GAE, ``projection_dim`` -1 and 3 (≠ D: the loss ignores
   z), the neighborhood and node attention axes, T = 1 and 2, on a gaussian
   multiplex of 40 nodes and 4 views with weights carried by
   ``params_from_jax``.
3. The trainer and the CLI on the CPU beside JAX's: the printout's lines,
   finite losses, metrics in [0, 1], steps that repeat for one seed, the
   spectral baselines and the saved embeddings.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.cli import node_classification as jax_cli
from graph_transformer_tpu.data.multiplex import (
    gaussian_multiplex as jax_gaussian,
)
from graph_transformer_tpu.models import multilayer as jml
from graph_transformer_tpu_torch.cli import node_classification
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.multiplex import gaussian_multiplex
from graph_transformer_tpu_torch.models import multilayer as tml
from graph_transformer_tpu_torch.train.ml_node_trainer import (
    MultiplexNodeTrainer,
    train_evaluate_multiplex,
)
from graph_transformer_tpu_torch.weights import params_from_jax

TOL = 1e-5
K, F = 3, 16
DS = dict(n=40, num_clusters=4, size_x=4, seed=2)


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
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    for f in dataclasses.fields(p.cross_attn):
        tree[f"cross_attn.{f.name}"] = np.asarray(getattr(p.cross_attn,
                                                          f.name))
    tree["weight"] = np.asarray(p.weight)
    if p.proj_w is not None:
        tree["proj_w"] = np.asarray(p.proj_w)
        tree["proj_b"] = np.asarray(p.proj_b)
    return tree


def close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, top = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def test_batches_equal_jax_over_three_steps():
    dj, dt = jax_gaussian(**DS), gaussian_multiplex(**DS)
    np.testing.assert_array_equal(dj.adj, dt.adj)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    nbrs = tml.neighbor_lists(dt.adj)
    for step in range(3):
        bj = jml.build_multiplex_batch(dj.x, dj.adj, K, rj)
        if step == 0:
            bt = tml.build_multiplex_batch(dt.x, dt.adj, K, rt)
            neigh = bt.neigh.numpy()
            np.testing.assert_array_equal(bt.x.numpy(), np.asarray(bj.x))
            np.testing.assert_array_equal(bt.adj.numpy(), np.asarray(bj.adj))
            np.testing.assert_array_equal(bt.node_mask.numpy(),
                                          np.asarray(bj.node_mask))
        else:
            neigh = tml.sample_multiplex_neighbors(nbrs, K, rt)
        assert neigh.dtype == np.int32
        np.testing.assert_array_equal(neigh, np.asarray(bj.neigh))


def test_isolated_node_takes_itself_and_shared_features():
    adj = np.zeros((5, 5, 2), np.float32)
    adj[0, 1, 0] = adj[1, 0, 0] = 1.0
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    bj = jml.build_multiplex_batch(x, adj, 4, np.random.default_rng(0))
    bt = tml.build_multiplex_batch(x, adj, 4, np.random.default_rng(0))
    np.testing.assert_array_equal(bt.neigh.numpy(), np.asarray(bj.neigh))
    np.testing.assert_array_equal(bt.x.numpy(), np.asarray(bj.x))
    assert (bt.neigh[1, 3, 1:] == 3).all() and bt.x.shape == (2, 5, 2)


CASES = [(mt, lt, pd, ax, t)
         for mt in ("siamese", "multi")
         for lt in ("contrastive", "gae")
         for pd in (-1, 3)
         for ax in ("neighborhood", "node")
         for t in ((1,) if pd == 3 else (1, 2))]


@pytest.mark.parametrize("mt,lt,pd,ax,T", CASES)
def test_loss_and_grads_match_jax(mt, lt, pd, ax, T):
    dj, dt = jax_gaussian(**DS), gaussian_multiplex(**DS)
    kw = dict(num_timesteps=T, ff_hidden_size=F, ml_model_type=mt,
              loss_type=lt, projection_dim=pd, attention_axis=ax)
    jm = jml.MultilayerU2GNN(dj.feature_dim, dj.num_nodes, dj.num_views,
                             JaxModelConfig(**kw))
    jp = jm.init(jax.random.key(5))
    tm = tml.MultilayerU2GNN(dt.feature_dim, dt.num_nodes, dt.num_views,
                             ModelConfig(**kw))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    bj = jml.build_multiplex_batch(dj.x, dj.adj, K,
                                   np.random.default_rng(3))
    bt = tml.build_multiplex_batch(dt.x, dt.adj, K,
                                   np.random.default_rng(3))
    zj = jm.encode(jp, bj, rng=None)
    zt = tm.encode(bt)
    close(zt.detach().numpy(), zj, "z")
    lj, gj = jax.value_and_grad(lambda p: jm.loss(p, bj, rng=None))(jp)
    lt_ = tm.loss(bt)
    lt_.backward()
    close(float(lt_.detach()), float(lj), "loss")
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for name, g in flat.items():
        t = got[name].grad
        close(np.zeros_like(g) if t is None else t.numpy(), g, name)
    if pd == 3:  # z is ignored: no gradient reaches the encoder
        assert all(got[k].grad is None or not got[k].grad.any()
                   for k in got if k.startswith("encoders."))


def test_node_embeddings_are_the_weight_table():
    ds = gaussian_multiplex(**DS)
    m = tml.MultilayerU2GNN(ds.feature_dim, ds.num_nodes, ds.num_views,
                            ModelConfig(ff_hidden_size=F))
    assert m.node_embeddings() is m.weight
    assert m.weight.shape == (40, ds.feature_dim)


def test_seeded_loss_draws_dropout_and_repeats():
    ds = gaussian_multiplex(**DS)
    m = tml.MultilayerU2GNN(ds.feature_dim, ds.num_nodes, ds.num_views,
                            ModelConfig(ff_hidden_size=F,
                                        loss_type="contrastive"), seed=1)
    b = tml.batch_from_dataset(ds, K)
    with torch.no_grad():
        a1, a2, c, d = m.loss(b, 7), m.loss(b, 7), m.loss(b, 8), m.loss(b)
    assert float(a1) == float(a2) and float(a1) != float(c)
    assert float(d) != float(a1)


def _cfg(epochs=3, loss_type="contrastive", **model):
    return ExperimentConfig(
        data=DataConfig(num_neighbors=K),
        model=ModelConfig(ff_hidden_size=F, loss_type=loss_type, **model),
        train=TrainConfig(num_epochs=epochs, eval_every=1,
                          learning_rate=1e-3))


@pytest.mark.parametrize("mode", ["kmeans", "logistic"])
def test_trainer_modes(mode):
    ds = gaussian_multiplex(n=60, num_clusters=3, size_x=4, seed=1)
    out = train_evaluate_multiplex(ds, _cfg(), eval_mode=mode,
                                   log_fn=lambda *_: None, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert 0.0 <= out["best_metric"] <= 1.0
    assert out["trainer"].node_embeddings().shape == (60, ds.feature_dim)


def test_trainer_steps_repeat_for_one_seed():
    ds = gaussian_multiplex(n=60, num_clusters=3, size_x=4, seed=1)
    runs = []
    for _ in range(2):
        t = MultiplexNodeTrainer(ds, _cfg(ml_model_type="multi",
                                          num_timesteps=2), device="cpu")
        runs.append(([t.train_epoch() for _ in range(3)],
                     t.node_embeddings()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert len(t.batch_ms) == 3


def test_contrastive_loss_decreases_as_jax_test_asks():
    """JAX's ``test_multiplex_trainer_contrastive_decreases`` on the port."""
    ds = gaussian_multiplex(n=60, num_clusters=3, size_x=4, seed=1)
    t = MultiplexNodeTrainer(ds, ExperimentConfig(
        data=DataConfig(num_neighbors=4),
        model=ModelConfig(ff_hidden_size=16, loss_type="contrastive"),
        train=TrainConfig(num_epochs=6, learning_rate=5e-3)), device="cpu")
    losses = [t.train_epoch() for _ in range(6)]
    assert losses[-1] < losses[0]


def test_spectral_baselines_on_the_trainer_device():
    ds = gaussian_multiplex(n=100, num_clusters=5, size_x=8, seed=100)
    t = MultiplexNodeTrainer(ds, _cfg(), device="cpu")
    sp = t.spectral_baselines()
    assert set(sp) == {"arithmetic_mean", "geometric_mean"}
    for metrics in sp.values():
        assert 0.0 <= metrics["accuracy"] <= 1.0


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiplexNodeTrainer(gaussian_multiplex(**DS), _cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node_classification.main(["--num_epochs", "1"])


def _lines(text):
    """The printout without the seconds of each epoch line and the path of
    the saved embeddings."""
    return [line.rsplit("|", 1)[0] if line.startswith("epoch ")
            else line.split(" to ")[0] for line in text.splitlines()]


def test_cli_defaults_print_what_jax_prints(tmp_path, capsys):
    """Both CLIs with the defaults (gaussian, siamese, contrastive, k-means)
    at a small width print the same lines, numbers aside: the data line is
    equal, and every epoch and metric line is there."""
    flags = ["--num_epochs", "2", "--eval_every", "1", "--ff_hidden_size",
             "16", "--spectral_baselines"]
    jax_cli.main(flags + ["--save_embeddings", str(tmp_path / "j.npy")])
    out_j = _lines(capsys.readouterr().out)
    best = node_classification.main(flags + [
        "--device", "cpu", "--save_embeddings", str(tmp_path / "t.npy")])
    out_t = _lines(capsys.readouterr().out)
    assert 0.0 <= best <= 1.0
    assert out_t[0] == out_j[0] == ("# multiplex data: 200 nodes, 4 views, "
                                    "5 classes, feature dim 10")
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert a.split(":")[0].split("|")[0] == b.split(":")[0].split("|")[0]
    assert np.load(tmp_path / "t.npy").shape == np.load(
        tmp_path / "j.npy").shape == (200, 10)
    # the spectral baselines run on the loaders' equal Laplacians
    sp_t = [line for line in out_t if line.startswith("spectral[")]
    sp_j = [line for line in out_j if line.startswith("spectral[")]
    assert sp_t[0] == sp_j[0]
