"""The port's sampled softmax, neighbor-negative loss, SupCon and GAE
losses against the JAX package's (``ops/sampled_softmax.py``,
``ops/sampled_neighbor.py``, ``ops/losses.py``).

The candidates are JAX's own, drawn with the loss's key and handed to the
port's ``loss_given``, as are JAX's ``randint`` negatives; the ``tf`` mode
gets JAX's float32 P(k) table (``test_torch_log_uniform.py`` holds the
port's table to it).  Per-example losses and the gradients of a random
weighting of them (inputs, weight, bias) agree within 1e-5 of each
quantity's largest magnitude, in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_transformer_tpu.ops.sampled_softmax as jss
from graph_transformer_tpu.data.tu import GraphDataset as JaxGraphDataset
from graph_transformer_tpu.ops.losses import gae_loss as jax_gae
from graph_transformer_tpu.ops.losses import supcon_loss as jax_supcon
from graph_transformer_tpu.ops.sampled_neighbor import (
    sampled_neighbor_loss as jax_neighbor_loss,
)
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu.sampling.neighbors import DeviceCSR as JaxCSR
from graph_transformer_tpu_torch.data.tu import GraphDataset
from graph_transformer_tpu_torch.ops import sampled_neighbor, sampled_softmax
from graph_transformer_tpu_torch.ops.losses import gae_loss, supcon_loss
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec
from graph_transformer_tpu_torch.sampling.neighbors import DeviceCSR

TOL = 1e-5


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), (
        np.abs(a - b).max(), np.abs(b).max())


def case(V, B, D, seed):
    r = np.random.default_rng(seed)
    inputs = r.standard_normal((B, D)).astype(np.float32)
    weight = (r.standard_normal((V, D)) * 0.3).astype(np.float32)
    bias = (r.standard_normal(V) * 0.1).astype(np.float32)
    # small ids, which the sampler nearly always draws: accidental hits
    labels = np.r_[np.arange(6), r.integers(0, V, B - 6)].astype(np.int32)
    mask = (np.arange(B) < B - 3).astype(np.float32)
    cot = r.standard_normal(B).astype(np.float32)
    return inputs, weight, bias, labels, mask, cot


def port_grads(fn, inputs, weight, bias, cot):
    ti, tw, tb = (torch.tensor(a, requires_grad=True)
                  for a in (inputs, weight, bias))
    out = fn(ti, tw, tb)
    (out * torch.from_numpy(cot)).sum().backward()
    return (out.detach().numpy(),) + tuple(
        np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        for t in (ti, tw, tb))


@pytest.mark.parametrize("mode", ["tf", "reference"])
@pytest.mark.parametrize("V,invalid", [(3000, False), (40_000, False),
                                       (40_000, True)])
def test_sampled_softmax_matches_jax(mode, V, invalid, monkeypatch):
    """Both modes below the fast sampler's threshold (exact Gumbel-top-k
    candidates) and above it (oversample-and-dedup, with ``valid``), also
    with unfilled slots forced, which both modes send to -inf."""
    B, D, NS = 24, 8, 64
    inputs, weight, bias, labels, mask, cot = case(V, B, D, V + invalid)
    key = jax.random.key(V)
    if V > jss._FAST_SAMPLER_VOCAB_THRESHOLD:
        ids, valid = jlu.sample_log_uniform_fast(key, V, NS)
        if invalid:
            valid = valid.at[::5].set(False)
            monkeypatch.setattr(jss, "sample_log_uniform_fast",
                                lambda *a: (ids, valid))
        valid_t = torch.from_numpy(np.array(valid))
    else:
        ids, valid_t = jlu.sample_log_uniform_unique(key, V, NS), None
    jspec = jlu.LogUniformSpec.create(V, NS)
    spec = LogUniformSpec.create(V, NS)

    def loss_j(x, w, b):
        return jss.sampled_softmax_loss(
            jss.SampledSoftmaxParams(weight=w, bias=b), key, x,
            jnp.asarray(labels), jspec, mode=mode, mask=jnp.asarray(mask))

    out_j, vjp = jax.vjp(loss_j, *map(jnp.asarray, (inputs, weight, bias)))
    grads_j = vjp(jnp.asarray(cot))
    probs = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    got = port_grads(lambda x, w, b: sampled_softmax.loss_given(
        w, b, x, torch.from_numpy(labels), torch.from_numpy(
            np.array(ids)), valid_t, spec, mode, torch.from_numpy(mask),
        probs), inputs, weight, bias, cot)
    assert np.all(np.isfinite(got[0]))
    close(got[0], out_j)
    for g, gj in zip(got[1:], grads_j):
        close(g, gj)
    if mode == "reference":
        assert not np.any(got[3])  # no bias in the reference mode
    hits = np.isin(labels[:6], np.asarray(ids)).sum()
    assert hits > 0  # the accidental-hit branch ran


def own_table_reading(mode, V):
    """The port's ``loss_given`` with its own P(k) table (no ``probs=``)
    against JAX's ``sampled_softmax_loss``, on JAX's candidates: (the
    largest gap between the two tables' log expected counts over the ids
    the case reads, the largest per-example loss difference, the largest
    JAX loss)."""
    B, D, NS = 24, 8, 64
    inputs, weight, bias, labels, mask, _ = case(V, B, D, V + 1)
    key = jax.random.key(V + 1)
    if V > jss._FAST_SAMPLER_VOCAB_THRESHOLD:
        ids, valid = jlu.sample_log_uniform_fast(key, V, NS)
        valid_t = torch.from_numpy(np.array(valid))
    else:
        ids, valid_t = jlu.sample_log_uniform_unique(key, V, NS), None
    out_j = jss.sampled_softmax_loss(
        jss.SampledSoftmaxParams(weight=jnp.asarray(weight),
                                 bias=jnp.asarray(bias)),
        key, jnp.asarray(inputs), jnp.asarray(labels),
        jlu.LogUniformSpec.create(V, NS), mode=mode, mask=jnp.asarray(mask))
    spec = LogUniformSpec.create(V, NS)
    ids_t = torch.from_numpy(np.array(ids)).long()
    got = sampled_softmax.loss_given(
        torch.from_numpy(weight), torch.from_numpy(bias),
        torch.from_numpy(inputs), torch.from_numpy(labels), ids_t, valid_t,
        spec, mode, torch.from_numpy(mask))
    read = torch.cat([torch.from_numpy(labels).long(),
                      ids_t if valid_t is None else ids_t[valid_t]])
    jax_table = torch.from_numpy(np.array(jlu.log_uniform_probs(V)))
    gap = (sampled_softmax.log_expected_count(spec, read, jax_table)
           - sampled_softmax.log_expected_count(spec, read)).abs().max()
    out_j = np.asarray(out_j, np.float64)
    return (float(gap), float(np.abs(got.numpy() - out_j).max()),
            float(np.abs(out_j).max()))


@pytest.mark.parametrize("mode", ["tf", "reference"])
@pytest.mark.parametrize("V", [3000, 40_000])
def test_loss_with_own_table_within_table_gap(mode, V):
    """The ``tf`` loss the port trains with reads its own float32 P(k)
    table, which differs from JAX's where the float32 logs cancel.  A loss
    is ``log(1 + sum_s exp(l_s - l_true))``, and each ``l_s - l_true`` moves
    by at most twice the largest gap g between the tables' log expected
    counts over the ids it reads, so the per-example losses may differ by
    at most 2g (plus TOL of the largest loss for float32 rounding).  The
    reference mode reads no table and agrees within TOL."""
    gap, diff, scale = own_table_reading(mode, V)
    bound = (2.0 * gap if mode == "tf" else 0.0) + TOL * scale
    assert diff <= bound, (gap, diff, scale)


@pytest.mark.parametrize("V", [3000, 40_000])
def test_draw_is_the_samplers(V):
    """``draw_candidates`` switches samplers at the threshold and repeats for
    a seed."""
    spec = LogUniformSpec.create(V, 64)
    ids, valid = sampled_softmax.draw_candidates(5, spec)
    assert (valid is None) == (V <= sampled_softmax.FAST_SAMPLER_VOCAB_THRESHOLD)
    again = sampled_softmax.draw_candidates(5, spec)
    assert torch.equal(ids, again[0])
    assert not torch.equal(ids, sampled_softmax.draw_candidates(6, spec)[0])


def csr_dataset():
    """30 nodes in 3 graphs with random edges; nodes 9, 19 and 29 isolated
    (the last node's list position is the end of the id array)."""
    r = np.random.default_rng(4)
    nbrs = [set() for _ in range(30)]
    for g in range(3):
        for _ in range(18):
            a, b = r.integers(g * 10, g * 10 + 9, 2)
            if a != b:
                nbrs[a].add(b)
                nbrs[b].add(a)
    offsets = np.r_[0, np.cumsum([len(s) for s in nbrs])].astype(np.int64)
    ids = np.concatenate([sorted(s) for s in nbrs]).astype(np.int32)
    kw = dict(name="csr", node_feat=np.eye(30, dtype=np.float32),
              nbr_offsets=offsets, nbr_ids=ids,
              graph_offsets=np.array([0, 10, 20, 30], np.int64),
              labels=np.array([0, 1, 0], np.int32), num_classes=2)
    return JaxGraphDataset(**kw), GraphDataset(**kw)


def test_sampled_neighbor_matches_jax():
    """Given JAX's ``randint`` draws, per-example losses and gradients; the
    isolated labels (9, 19, 29) give 0 and no gradient."""
    dj, dt = csr_dataset()
    B, D, NS = 30, 6, 12
    inputs, weight, _, _, mask, cot = case(30, B, D, 8)
    labels = np.arange(30, dtype=np.int32)
    key = jax.random.key(3)
    jcsr = JaxCSR.from_dataset(dj)
    deg = np.asarray(jcsr.degrees)[labels]
    r = jax.random.randint(key, (B, NS), 0, jnp.maximum(deg, 1)[:, None],
                           dtype=jnp.int32)

    def loss_j(x, w):
        return jax_neighbor_loss(jss.SampledSoftmaxParams(w, jnp.zeros(30)),
                                 key, x, jnp.asarray(labels), jcsr, NS,
                                 mask=jnp.asarray(mask))

    out_j, vjp = jax.vjp(loss_j, jnp.asarray(inputs), jnp.asarray(weight))
    gx_j, gw_j = vjp(jnp.asarray(cot))
    csr = DeviceCSR.from_dataset(dt)
    out, gx, gw, _ = port_grads(lambda x, w, b: sampled_neighbor.loss_given(
        w, x, torch.from_numpy(labels), csr, torch.from_numpy(np.array(r)),
        torch.from_numpy(mask)), inputs, weight, np.zeros(30, np.float32),
        cot)
    close(out, out_j)
    close(gx, gx_j)
    close(gw, gw_j)
    iso = np.array([9, 19, 29])
    assert np.all(deg[iso] == 0) and not np.any(out[iso])
    assert not np.any(gx[iso])
    draws = sampled_neighbor.draw_neighbor_negatives(
        7, csr, torch.from_numpy(labels), NS)
    assert draws.shape == (B, NS)
    assert torch.all(draws < torch.clamp(csr.degrees, min=1)[:, None])
    assert torch.equal(draws, sampled_neighbor.draw_neighbor_negatives(
        7, csr, torch.from_numpy(labels), NS))


@pytest.mark.parametrize("valid", [False, True])
def test_supcon_matches_jax(valid):
    r = np.random.default_rng(11)
    N, D = 20, 8
    f = r.standard_normal((N, D)).astype(np.float32)
    adj = (r.random((N, N)) < 0.2).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    v = (np.arange(N) < 16).astype(np.float32) if valid else None
    lj, gj = jax.value_and_grad(lambda x: jax_supcon(
        x, mask=jnp.asarray(adj), valid=None if v is None else jnp.asarray(v),
        temperature=0.5))(jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    lt = supcon_loss(ft, mask=torch.from_numpy(adj),
                     valid=None if v is None else torch.from_numpy(v),
                     temperature=0.5)
    lt.backward()
    close(lt.detach().numpy(), lj)
    close(ft.grad.numpy(), gj)
    labels = r.integers(0, 3, N)
    close(supcon_loss(torch.from_numpy(f),
                      labels=torch.from_numpy(labels)).numpy(),
          jax_supcon(jnp.asarray(f), labels=jnp.asarray(labels)))


def test_gae_matches_jax():
    r = np.random.default_rng(12)
    N, D = 18, 5
    zs = [r.standard_normal((N, D)).astype(np.float32) for _ in range(2)]
    adj = (r.random((N, N, 2)) < 0.3).astype(np.float32)
    w = r.random(N * N * 2).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda a, b: jax_gae(
        [a, b], jnp.asarray(adj), 1.7, jnp.asarray(w)), argnums=(0, 1))(
        *map(jnp.asarray, zs))
    ts = [torch.tensor(z, requires_grad=True) for z in zs]
    lt = gae_loss(ts, torch.from_numpy(adj), 1.7, torch.from_numpy(w))
    lt.backward()
    close(lt.detach().numpy(), lj)
    for t, g in zip(ts, gj):
        close(t.grad.numpy(), g)
