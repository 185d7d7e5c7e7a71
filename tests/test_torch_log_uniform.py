"""The port's log-uniform candidate sampling against
``graph_transformer_tpu/sampling/log_uniform.py`` and its native host
sampler against the JAX package's copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_transformer_tpu.native import log_uniform_native as jax_native
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu_torch.native import build as native_build
from graph_transformer_tpu_torch.native import log_uniform_native as native
from graph_transformer_tpu_torch.sampling import log_uniform as lu


@pytest.mark.parametrize("V", [7, 1000, 40_000])
def test_probs_match_jax(V):
    """float32 P(k) computed as JAX computes it, ``log(k+2) - log(k+1)`` in
    float32 with its cancellation: equal to JAX's within 1e-6 relative
    plus the float32 rounding of the two logs (XLA's float32 log is not
    correctly rounded: it is an ulp off the port's at about 1% of k, which
    the cancellation magnifies), and bit for bit equal where JAX's logs are
    the correctly rounded ones; in float64 a distribution."""
    got = lu.log_uniform_probs(V).numpy()
    want = np.asarray(jlu.log_uniform_probs(V))
    assert got.dtype == np.float32
    k = np.arange(V, dtype=np.float64)
    l2, l1 = np.float32(np.log(k + 2.0)), np.float32(np.log(k + 1.0))
    ulps = (np.spacing(l2) + np.spacing(l1)) / np.log(V + 1.0)
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + ulps)
    kj = jnp.arange(V, dtype=jnp.float32)
    exact = ((np.asarray(jnp.log(kj + 2.0)) == l2)
             & (np.asarray(jnp.log(kj + 1.0)) == l1))
    assert exact.mean() > 0.5
    np.testing.assert_array_equal(got[exact], want[exact])
    p64 = lu.log_uniform_probs(V, torch.float64).numpy()
    assert abs(p64.sum() - 1.0) < 1e-12 and np.all(np.diff(p64) < 0)


@pytest.mark.parametrize("V,S", [(500, 64), (10_000, 512), (40_000, 512)])
def test_expected_count_match_jax(V, S):
    t = lu.expected_num_tries(V, S)
    assert t == jlu.expected_num_tries(V, S)
    assert lu.LogUniformSpec.create(V, S) == lu.LogUniformSpec(V, S, t)
    p = lu.log_uniform_probs(V)
    got = lu.expected_count(t, p).numpy()
    want = np.asarray(jlu.expected_count(t, jnp.asarray(p.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_samplers_unique_in_range_and_repeat(fast):
    V, S = 500, 64
    for seed in range(5):
        if fast:
            ids, valid = lu.sample_log_uniform_fast(seed, V, S)
            again = lu.sample_log_uniform_fast(seed, V, S)
            assert torch.equal(valid, again[1])
            again = again[0]
            ids = ids[valid]
            assert int(valid.sum()) >= S - 2
        else:
            ids = lu.sample_log_uniform_unique(seed, V, S)
            again = lu.sample_log_uniform_unique(seed, V, S)
            assert len(ids) == S
        assert ids.dtype == torch.int64
        assert len(torch.unique(ids)) == len(ids)
        assert int(ids.min()) >= 0 and int(ids.max()) < V
        assert torch.equal(lu.sample_log_uniform_unique(seed, V, S)
                           if not fast else
                           lu.sample_log_uniform_fast(seed, V, S)[0], again)
    assert not torch.equal(lu.sample_log_uniform_unique(0, V, S),
                           lu.sample_log_uniform_unique(1, V, S))


def test_fast_sampler_keeps_draw_order():
    """The fast sampler's ids are the first distinct values of its draws,
    in draw order."""
    V, S = 300, 32
    ids, valid = lu.sample_log_uniform_fast(9, V, S)
    u = lu._uniform64(9, 4 * S, "cpu").numpy()
    vals = np.clip(np.floor(np.exp(u * np.log(V + 1.0))).astype(np.int64) - 1,
                   0, V - 1)
    _, first = np.unique(vals, return_index=True)
    want = vals[np.sort(first)][:S]
    np.testing.assert_array_equal(ids[valid].numpy(), want)


@pytest.mark.parametrize("fast", [False, True])
def test_sampler_distribution(fast):
    """Aggregate frequencies over many seeds match the expected counts of
    the Zipfian head within 15% on average
    (``tests/test_sampling.py:41-57``)."""
    V, S, R = 2000, 32, 300
    counts = np.zeros(V)
    for r in range(R):
        if fast:
            ids, valid = lu.sample_log_uniform_fast(r, V, S)
            ids = ids[valid]
        else:
            ids = lu.sample_log_uniform_unique(r, V, S)
        counts[ids.numpy()] += 1
    p = lu.log_uniform_probs(V, torch.float64)
    expect = lu.expected_count(lu.expected_num_tries(V, S), p).numpy() * R
    head = expect > 30
    assert head.sum() > 5
    rel = np.abs(counts[head] - expect[head]) / expect[head]
    assert rel.mean() < 0.15


def test_native_sampler_equals_jax_copy():
    """Same seed, same draws: ids, tries, expected counts and accidental
    matches of the port's build equal the JAX package's bit for bit."""
    for V, seed in ((1000, 1111), (50_000, 7)):
        a, b = native.LogUniformSampler(V, seed), jax_native.LogUniformSampler(
            V, seed)
        for _ in range(3):
            (ia, ta), (ib, tb) = a.sample_unique(64), b.sample_unique(64)
            np.testing.assert_array_equal(ia, ib)
            assert ta == tb
        np.testing.assert_array_equal(a.sample_iid(100), b.sample_iid(100))
        labels = np.arange(0, 40, 3)
        for x, y in zip(a.sample(32, labels), b.sample(32, labels)):
            np.testing.assert_array_equal(x, y)
        ids = a.sample_iid(50)
        np.testing.assert_array_equal(a.expected_count(71.5, ids),
                                      b.expected_count(71.5, ids))
        assert a.probability(3) == b.probability(3)
        ra = a.accidental_matches(labels, ids)
        rb = b.accidental_matches(labels, ids)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)
    assert native.LogUniformSampler(10).probability(0) == pytest.approx(
        np.log(2) / np.log(11))


def test_native_expected_count_matches_device_formula():
    V, S = 5000, 64
    s = native.LogUniformSampler(V)
    ids, tries = s.sample_unique(S)
    p = lu.log_uniform_probs(V, torch.float64)[torch.from_numpy(ids)]
    np.testing.assert_allclose(s.expected_count(tries, ids),
                               lu.expected_count(float(tries), p).numpy(),
                               rtol=1e-12)


def test_native_library_lives_under_build():
    path = native._load()._name
    assert path.startswith(str(native_build.BUILD_DIR))
    assert "graph_transformer_tpu/native" not in path
