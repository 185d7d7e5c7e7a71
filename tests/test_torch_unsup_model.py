"""The port's ``U2GNNUnsup`` against the JAX package's
(``graph_transformer_tpu/models/u2gnn_unsup.py``), weights carried across by
``params_from_jax``: JAX at ``rng=None`` and the port without a seed
(deterministic, float32), on one batch of every graph of a small dataset
(the fork's head needs the vocabulary's rows in the batch).  ``encode`` at
1 and 2 U2GNN layers, both heads, ``regather`` both ways; ``loss`` in every
``loss_type`` and sampler, ``vocab_perm`` on and off, with JAX's candidates
and negatives: outputs and every gradient leaf within 1e-5 of each leaf's
largest magnitude.  The fused path against the two-pass path on K7's
neighborhoods, and ``permute_graphs`` against JAX's array by array."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.tu import permute_graphs as jax_permute
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu.models.u2gnn_unsup import U2GNNUnsup as JaxUnsup
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu.sampling.neighbors import DeviceCSR as JaxCSR
from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import (
    permute_graphs,
    synthetic_powerlaw_dataset,
)
from graph_transformer_tpu_torch.models.u2gnn_unsup import U2GNNUnsup
from graph_transformer_tpu_torch.ops import sampled_softmax
from graph_transformer_tpu_torch.sampling.neighbors import DeviceCSR
from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer
from graph_transformer_tpu_torch.weights import params_from_jax

K, T, F, NS = 4, 2, 32, 32
DS = dict(num_graphs=8, num_classes=2, mean_nodes=12, seed=0,
          reddit_like=False)
TOL = 1e-5


def flatten_jax(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    tree["ss.weight"] = np.asarray(p.ss.weight)
    tree["ss.bias"] = np.asarray(p.ss.bias)
    if p.cross_attn is not None:
        for f in dataclasses.fields(p.cross_attn):
            tree[f"cross_attn.{f.name}"] = np.asarray(
                getattr(p.cross_attn, f.name))
    if p.weight is not None:
        tree["weight"] = np.asarray(p.weight)
    return tree


def close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, top = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def setup(k, head, seed=0, **model_kw):
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    kw = dict(num_timesteps=T, num_hidden_layers=k, ff_hidden_size=F,
              sampled_num=NS, **model_kw)
    jm = JaxUnsup(dj.feature_dim, dj.num_nodes, JaxModelConfig(**kw), head)
    jp = jm.init(jax.random.key(seed))
    tm = U2GNNUnsup(dt.feature_dim, dt.num_nodes, ModelConfig(**kw), head)
    tm.load_state_dict(params_from_jax(flatten_jax(jp)))
    graphs = np.arange(dj.num_graphs)
    bj = JaxBuilder(dj, len(graphs), K, seed=4, backend="numpy").build(graphs)
    bt = BatchBuilder(dt, len(graphs), K, seed=4,
                      backend="numpy").build(graphs)
    np.testing.assert_array_equal(np.asarray(bj.neigh), bt.neigh.numpy())
    assert bt.n_pad >= dt.num_nodes
    return dj, dt, jm, jp, tm, bj, bt


@pytest.mark.parametrize("k,head,regather", [
    (1, "concat", True), (2, "concat", True), (2, "concat", False),
    (1, "cross_attention", True), (2, "cross_attention", True),
    (2, "cross_attention", False)])
def test_encode_matches_jax(k, head, regather):
    _, _, jm, jp, tm, bj, bt = setup(k, head, seed=k)
    zj = jm.encode(jp, bj, rng=None, regather=regather)
    zt = tm.encode(bt, regather=regather)
    assert zt.dtype == torch.float32
    assert zt.shape == (bt.n_pad, tm.embedding_dim)
    close(zt.detach().numpy(), zj, "z")


def adjacency(b):
    n = b.n_pad
    a = np.zeros((n, n), np.float32)
    m = np.asarray(b.edge_mask) > 0
    a[np.asarray(b.edge_src)[m], np.asarray(b.edge_dst)[m]] = 1.0
    return a


LOSS_CASES = [
    # (k, head, model kwargs, vocab_perm)
    (1, "concat", dict(sampled_softmax_mode="tf"), False),
    (2, "concat", dict(sampled_softmax_mode="tf"), True),
    (1, "concat", dict(sampled_softmax_mode="reference"), True),
    (2, "cross_attention", dict(sampled_softmax_mode="tf"), False),
    (1, "concat", dict(sampler_type="neighbor"), False),
    (1, "concat", dict(loss_type="contrastive"), False),
    (2, "cross_attention", dict(loss_type="contrastive"), False),
    (1, "concat", dict(loss_type="gae"), False),
    (1, "cross_attention", dict(loss_type="gae"), False),
]


@pytest.mark.parametrize("k,head,kw,perm", LOSS_CASES)
def test_loss_and_grads_match_jax(k, head, kw, perm, monkeypatch):
    dj, dt, jm, jp, tm, bj, bt = setup(k, head, seed=10 + k, **kw)
    V = dj.num_nodes
    key = jax.random.key(7)
    spec_j = jm.spec()
    vp = np.random.default_rng(3).permutation(V) if perm else None
    adj = adjacency(bt)
    jcsr = JaxCSR.from_dataset(dj)

    def loss_j(p):
        return jm.loss(p, bj, key, spec_j, rng=None, adj_mask=jnp.asarray(adj),
                       csr=jcsr, vocab_perm=None if vp is None
                       else jnp.asarray(vp, jnp.int32))

    lj, gj = jax.value_and_grad(loss_j)(jp)
    ids = np.array(jlu.sample_log_uniform_unique(key, V, NS))
    deg = np.asarray(jcsr.degrees)[np.asarray(bj.node_gidx)]
    r = np.array(jax.random.randint(key, (bt.n_pad, NS), 0,
                                    jnp.maximum(deg, 1)[:, None],
                                    dtype=jnp.int32))
    # the tf mode reads JAX's float32 P(k) table, as JAX's candidates
    # (tests/test_torch_log_uniform.py holds the port's table to it)
    table = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    monkeypatch.setattr(sampled_softmax, "probs_table", lambda v, d: table)
    lt = tm.loss(bt, tm.spec(), candidates=(torch.from_numpy(ids), None),
                 negatives=torch.from_numpy(r), csr=DeviceCSR.from_dataset(dt),
                 adj_mask=torch.from_numpy(adj),
                 vocab_perm=None if vp is None else torch.from_numpy(vp))
    lt.backward()
    assert np.isfinite(float(lt.detach()))
    close(float(lt.detach()), float(lj), "loss")
    flat = flatten_jax(gj)
    got = dict(tm.named_parameters())
    assert set(flat) == set(got)
    for name, g in flat.items():
        t = got[name].grad
        close(np.zeros_like(g) if t is None else t.numpy(), g, name)
    emb_j = jm.node_embeddings(jp, None if vp is None else jnp.asarray(vp))
    close(tm.node_embeddings(None if vp is None else torch.from_numpy(vp))
          .detach().numpy(), emb_j, "node_embeddings")


def test_quirks_of_the_jax_model():
    """One stored timestep only with ``share_timestep_weights`` (unlike
    ``U2GNNSup``), and a non-basic recurrence trains the basic encoder, as
    JAX's ``encode`` passes none."""
    _, _, jm, jp, tm, bj, bt = setup(1, "concat", seed=2, recurrence="gru")
    assert tm.encoders[0].w_in.shape[0] == T
    assert not [n for n, _ in tm.named_parameters() if n.startswith("rec")]
    close(tm.encode(bt).detach().numpy(), jm.encode(jp, bj, rng=None), "z")
    tied = U2GNNUnsup(9, 50, ModelConfig(num_timesteps=3,
                                         share_timestep_weights=True,
                                         ff_hidden_size=F))
    assert tied.encoders[0].w_in.shape[0] == 1


def test_seeded_loss_trains():
    """With a seed the loss draws dropout and candidates: it repeats for one
    seed and differs from another's."""
    _, dt, _, _, tm, _, bt = setup(2, "concat", seed=5)
    spec = tm.spec()
    a = tm.loss(bt, spec, seed=11)
    assert float(a) == float(tm.loss(bt, spec, seed=11))
    assert float(a) != float(tm.loss(bt, spec, seed=12))
    with pytest.raises(ValueError):
        tm.loss(bt, spec)


def codebook_dataset():
    ds = synthetic_powerlaw_dataset("S", num_graphs=12, mean_nodes=20,
                                    seed=0, reddit_like=False)
    tags = np.random.default_rng(0).integers(0, 5, ds.num_nodes)
    ds.node_feat = np.random.default_rng(1).standard_normal(
        (5, 7)).astype(np.float32)[tags]
    return ds


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fused_path_against_two_pass(rate, monkeypatch):
    """One U2GNN layer on a 5-row codebook in bf16: the fused path (K13 and
    its recompute backward) and the two-pass path (K7's neighborhoods, K4t,
    K8s/K8) draw the same neighborhoods for one seed and give the same z
    once the fused z is rounded to bf16 as the two-pass path rounds it;
    the losses agree to bf16 rounding and every gradient leaf at cosine
    > 0.99 (the bf16 residuals, ``tests/test_torch_two_pass.py``)."""
    from graph_transformer_tpu_torch.models import u2gnn_unsup as mu

    monkeypatch.setattr(mu, "ENCODER_DROPOUT", rate)
    ds = codebook_dataset()
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=8),
        model=ModelConfig(num_timesteps=T, ff_hidden_size=F, sampled_num=NS,
                          compute_dtype="bfloat16", dropout=rate),
        train=TrainConfig(seed=3))
    fused_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, use_fused_sampler=True, use_pallas=True,
        use_pallas_whole_encoder=True))
    two, fused = (UnsupTrainer(ds, c, device="cpu") for c in (cfg, fused_cfg))
    assert fused.fused and not two.fused
    batch = two.builder.sample()
    seed = 4242
    zs, losses, grads = [], [], []
    for t in (fused, two):
        captured = []
        enc = t.model.encode
        monkeypatch.setattr(t.model, "encode", lambda *a, **kw: captured.append(
            enc(*a, **kw)) or captured[-1])
        loss = t.loss(batch, seed)
        zs.append(captured[0].detach())
        losses.append(float(loss))
        ps = list(t.model.parameters())
        grads.append(torch.autograd.grad(loss, ps, allow_unused=True))
    torch.testing.assert_close(zs[0].to(torch.bfloat16).float(), zs[1],
                               rtol=0, atol=0)
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1])
    for a, b in zip(*grads):
        a, b = a.flatten().double(), b.flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) > 0.99


def test_permute_graphs_matches_jax():
    dj, dt = jax_synthetic("S", **DS), synthetic_powerlaw_dataset("S", **DS)
    for seed in (0, 5):
        a, b = permute_graphs(dt, seed), jax_permute(dj, seed)
        assert a.name == b.name and a.num_classes == b.num_classes
        for f in ("node_feat", "nbr_offsets", "nbr_ids", "graph_offsets",
                  "labels"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y)
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    np.testing.assert_array_equal(permute_graphs(dt, perm=perm).labels,
                                  dt.labels[perm])
