"""The port's sparse substrate (``ops/sparse.py``) and the GCN / GAT node
baselines (``models/gcn.py``, ``models/gat.py``, ``train/node_trainer.py``,
``cli/train_node.py --node_model gcn|gat``) against the JAX package's.

1. ``spmm``, ``gcn_norm_edges``, ``edge_softmax``, ``sddmm_dot`` and the
   segment sums on a random padded edge list (repeated and masked edges,
   empty segments) within 1e-5 of JAX's, gradients too (``jax.grad``).
2. GCN and GAT on a 60-node SBM's whole-graph batch (64 padded rows), weights
   carried by ``params_from_jax``, dropout 0 (JAX ``rng=None``, the port
   without a seed): mu and sigma, and for each loss (GAE, contrastive, the
   sampled softmax with JAX's candidates and P(k) table handed in) the loss
   and every gradient leaf within 1e-5 of each leaf's largest magnitude.
3. JAX's node-trainer cases for the baselines on the port on the CPU, steps
   that repeat for one seed, and both CLIs with ``--node_model gcn|gat`` at a
   small width: the printout's lines, numbers aside.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.cli import train_node as jax_cli
from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.citation import sbm_synthetic as jax_sbm
from graph_transformer_tpu.models.gat import GATModel as JaxGAT
from graph_transformer_tpu.models.gcn import GCNModel as JaxGCN
from graph_transformer_tpu.ops import sparse as jsp
from graph_transformer_tpu.sampling import log_uniform as jlu
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
from graph_transformer_tpu_torch.models.gat import GATModel
from graph_transformer_tpu_torch.models.gcn import GCNModel
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.ops import sparse as tsp
from graph_transformer_tpu_torch.train.node_trainer import (
    NodeTrainer,
    train_evaluate_node,
)
from graph_transformer_tpu_torch.weights import params_from_jax

TOL = 1e-5
F, NS = 16, 16
MODELS = {"gcn": (JaxGCN, GCNModel), "gat": (JaxGAT, GATModel)}


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread: under the test run's parallel workers
    the default pool is many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, top = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * max(top, 1e-30), (what, err, top)


# ------------------------------------------------------------ sparse ops
def edge_case(seed=0, n=23, e=90, pad=10):
    """A random edge list with repeated edges, nodes 20-22 without edges,
    and ``pad`` padding edges (mask 0, both ends node 0)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, 20, e), np.zeros(pad, int)])
    dst = np.concatenate([rng.integers(0, 20, e), np.zeros(pad, int)])
    mask = np.concatenate([np.ones(e), np.zeros(pad)]).astype(np.float32)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), mask, x


def test_segments_and_segment_sum():
    src, dst, mask, x = edge_case()
    seg = tsp.Segments.of(torch.from_numpy(dst), 23)
    assert seg.lengths.tolist() == np.bincount(dst, minlength=23).tolist()
    v = torch.from_numpy(x[src]).requires_grad_()
    y = tsp.segment_sum(v, seg)
    close(y.detach().numpy(), jax.ops.segment_sum(x[src], dst, 23))
    g = torch.randn(23, 5, generator=torch.Generator().manual_seed(1))
    (y * g).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), g.numpy()[dst])
    xt = torch.from_numpy(x).requires_grad_()
    gathered = tsp.gather(xt, tsp.Segments.of(torch.from_numpy(src), 23))
    np.testing.assert_array_equal(gathered.detach().numpy(), x[src])
    (gathered * torch.from_numpy(x[dst])).sum().backward()
    close(xt.grad.numpy(), jax.ops.segment_sum(x[dst], src, 23))


def test_spmm_and_gcn_norm_match_jax():
    src, dst, mask, x = edge_case(1)
    js, jd, jv = jsp.gcn_norm_edges(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(mask), 23)
    ts, td, tv = tsp.gcn_norm_edges(torch.from_numpy(src),
                                    torch.from_numpy(dst),
                                    torch.from_numpy(mask), 23)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tv.numpy(), jv, "val")

    def jf(x_):
        return jnp.sum(jsp.spmm(js, jd, jv, x_, 23) ** 2)

    xt = torch.from_numpy(x).requires_grad_()
    y = tsp.spmm(tsp.Segments.of(ts, 23), tsp.Segments.of(td, 23), tv, xt)
    close(y.detach().numpy(), jsp.spmm(js, jd, jv, jnp.asarray(x), 23))
    (y ** 2).sum().backward()
    close(xt.grad.numpy(), jax.grad(jf)(jnp.asarray(x)), "dx")


def test_edge_softmax_and_sddmm_match_jax():
    src, dst, mask, x = edge_case(2)
    rng = np.random.default_rng(3)
    scores = rng.normal(size=len(src)).astype(np.float32)
    w = rng.normal(size=len(src)).astype(np.float32)

    def jf(s):
        return jnp.sum(jsp.edge_softmax(s, jnp.asarray(src),
                                        jnp.asarray(mask), 23) * w)

    st = torch.from_numpy(scores).requires_grad_()
    seg = tsp.Segments.of(torch.from_numpy(src), 23)
    att = tsp.edge_softmax(st, seg, torch.from_numpy(mask))
    close(att.detach().numpy(), jsp.edge_softmax(
        jnp.asarray(scores), jnp.asarray(src), jnp.asarray(mask), 23))
    (att * torch.from_numpy(w)).sum().backward()
    close(st.grad.numpy(), jax.grad(jf)(jnp.asarray(scores)), "dscores")
    assert float(att.detach()[-10:].abs().max()) == 0.0  # padding edges
    a, b = x, x[::-1].copy()
    got = tsp.sddmm_dot(seg, tsp.Segments.of(torch.from_numpy(dst), 23),
                        torch.from_numpy(a), torch.from_numpy(b))
    close(got.numpy(), jsp.sddmm_dot(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(a), jnp.asarray(b)))


# ---------------------------------------------------------------- models
def flatten_jax(p):
    tree = {}
    for layer in ("gc1", "gc2_mu", "gc2_sig"):
        for f in dataclasses.fields(getattr(p, layer)):
            tree[f"{layer}.{f.name}"] = np.asarray(getattr(getattr(p, layer),
                                                           f.name))
    tree["ss.weight"] = np.asarray(p.ss.weight)
    tree["ss.bias"] = np.asarray(p.ss.bias)
    return tree


def setup(name, loss_type="default"):
    ds_kw = dict(num_nodes=60, num_classes=3, feature_dim=12, seed=2)
    dj, dt = jax_sbm(**ds_kw), sbm_synthetic(**ds_kw)
    mk = dict(ff_hidden_size=F, sampled_num=NS, loss_type=loss_type)
    jcls, tcls = MODELS[name]
    jm = jcls(dj.feature_dim, dj.num_nodes, JaxModelConfig(**mk))
    jp = jm.init(jax.random.key(4))
    tm = tcls(dt.feature_dim, dt.num_nodes, ModelConfig(**mk))
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    bj = JaxBuilder(dj.graph, 1, 4, pad_multiple=32, seed=4,
                    backend="numpy").build(np.arange(1))
    bt = whole_dataset_batch(dt.graph, 4, pad_multiple=32, seed=4)
    for f in ("x", "edge_src", "edge_dst", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)))
    assert bt.n_pad == 64
    return dt, jm, jp, tm, bj, bt


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_encode_matches_jax(name):
    _, jm, jp, tm, bj, bt = setup(name)
    (mj, sj), (mt, st) = jm.encode(jp, bj, rng=None), tm.encode(bt)
    close(mt.detach().numpy(), mj, "mu")
    close(st.detach().numpy(), sj, "sigma")


@pytest.mark.parametrize("name", ["gcn", "gat"])
@pytest.mark.parametrize("loss_type", ["gae", "contrastive", "default"])
def test_loss_and_grads_match_jax(name, loss_type, monkeypatch):
    dt, jm, jp, tm, bj, bt = setup(name, loss_type)
    V = dt.num_nodes
    key = jax.random.key(7)
    adj = dt.dense_adj(bt.n_pad)
    lj, gj = jax.value_and_grad(lambda p: jm.loss(
        p, bj, key, jm.spec(), rng=None, adj_mask=jnp.asarray(adj)))(jp)
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
    for key_, g in flat.items():
        t = got[key_].grad
        close(np.zeros_like(g) if t is None else t.numpy(), g, key_)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_seeded_dropout_repeats_and_differs(name):
    _, _, _, tm, _, bt = setup(name, "gae")
    adj = torch.ones(64, 64)
    with torch.no_grad():
        a, b = tm.loss(bt, tm.spec(), 5, adj_mask=adj), tm.loss(
            bt, tm.spec(), 5, adj_mask=adj)
        c, d = tm.loss(bt, tm.spec(), 6, adj_mask=adj), tm.loss(
            bt, tm.spec(), adj_mask=adj)
    assert float(a) == float(b) and float(a) != float(c) != float(d)


# --------------------------------------------------------------- trainer
def _cfg(model, loss_type="default", epochs=2, lr=1e-3):
    """``tests/test_node_classification.py``'s configuration."""
    return ExperimentConfig(
        data=DataConfig(num_neighbors=4, pad_multiple=32),
        model=ModelConfig(model=model, num_timesteps=1, num_hidden_layers=1,
                          ff_hidden_size=16, sampled_num=8,
                          loss_type=loss_type),
        train=TrainConfig(num_epochs=epochs, learning_rate=lr))


@pytest.mark.parametrize("name", ["gcn", "gat"])
@pytest.mark.parametrize("loss_type", ["gae", "contrastive"])
def test_baseline_losses_fall_without_dropout(name, loss_type):
    """30 steps at JAX's ``test_node_trainer_gcn_loss_decreases`` rate
    (5e-3) with the dropout off: the last five losses' mean below the first
    five's.  (With dropout and the sampled softmax, as JAX's test runs it,
    the loss of the 2-wide latent hardly moves in 30 steps in either package:
    its ends' means cross at one seed in three, JAX's too.)"""
    ds = sbm_synthetic(num_nodes=60, seed=0)
    cfg = _cfg(name, loss_type, epochs=1, lr=5e-3)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))
    t = NodeTrainer(ds, cfg, device="cpu")
    losses = [t.train_epoch() for _ in range(30)]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert 0.0 <= t.evaluate_masks() <= 1.0


@pytest.mark.parametrize("name,loss_type,mode", [
    ("gat", "contrastive", "masks"), ("gcn", "gae", "kmeans"),
    ("gat", "default", "2fold"), ("gcn", "contrastive", "masks")])
def test_baseline_trainer_cases(name, loss_type, mode):
    ds = karate_club()
    out = train_evaluate_node(ds, _cfg(name, loss_type), eval_mode=mode,
                              log_fn=lambda *_: None, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert 0.0 <= out["best_metric"] <= 1.0
    emb = out["trainer"].node_embeddings()
    assert emb.shape == (34, 2)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_baseline_steps_repeat_for_one_seed(name):
    runs = []
    for _ in range(2):
        t = NodeTrainer(sbm_synthetic(num_nodes=60, seed=1), _cfg(name),
                        device="cpu")
        runs.append(([t.train_epoch() for _ in range(3)],
                     t.node_embeddings()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def _lines(text):
    """The printout without the seconds of each epoch line and the path of
    the saved embeddings."""
    return [line.rsplit("|", 1)[0] if line.startswith("epoch ")
            else line.split(" to ")[0] for line in text.splitlines()]


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_cli_prints_what_jax_prints(name, tmp_path, capsys):
    flags = ["--node_dataset", "karate", "--node_model", name,
             "--num_epochs", "2", "--eval_every", "1", "--ff_hidden_size",
             "8", "--sampled_num", "8"]
    jax_cli.main(flags + ["--save_embeddings", str(tmp_path / "j.npy")])
    out_j = _lines(capsys.readouterr().out)
    metric = train_node.main(flags + ["--device", "cpu", "--save_embeddings",
                                      str(tmp_path / "t.npy")])
    out_t = _lines(capsys.readouterr().out)
    assert 0.0 <= metric <= 1.0
    assert out_t[0] == out_j[0]
    assert [line.split("|")[0].split(":")[0] for line in out_t] == [
        line.split("|")[0].split(":")[0] for line in out_j]
    assert np.load(tmp_path / "t.npy").shape == np.load(
        tmp_path / "j.npy").shape == (34, 2)
