"""The port's clustering metrics (``utils/metrics.py``, numpy only) against
the JAX package's, which take NMI, ARI and k-means from sklearn: every
metric within 1e-12 over label pairs (random, permuted, one cluster,
singletons, more clusters than classes); ``_kmeans`` at most 1.001 times
sklearn's inertia on overlapping blobs and the same partition, up to
relabelling, on well-separated ones; the evaluation helpers end to end."""

import numpy as np
import pytest
from sklearn.cluster import KMeans

from graph_transformer_tpu.utils import metrics as jm
from graph_transformer_tpu_torch.utils import metrics as tm


def label_pairs():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 4, 60)
    out = {
        "random": (y, rng.integers(0, 4, 60)),
        "permuted": (y, (y + 1) % 4),
        "equal": (y, y.copy()),
        "noisy": (y, np.where(rng.random(60) < 0.2, rng.integers(0, 4, 60),
                              y)),
        "more-clusters": (y, rng.integers(0, 7, 60)),
        "one-cluster": (y, np.zeros(60, int)),
        "both-one": (np.zeros(9, int), np.full(9, 3)),
        "singletons": (y[:20], np.arange(20)),
        "gapped-ids": (y * 3 + 1, rng.integers(0, 3, 60) * 5),
    }
    return out


PAIRS = label_pairs()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_metrics_equal_jax(name):
    y_true, y_pred = PAIRS[name]
    want = jm.all_metrics(y_true, y_pred)
    got = tm.all_metrics(y_true, y_pred)
    assert set(got) == set(want) == {"purity", "accuracy", "avg_error",
                                     "nmi", "ari"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def blobs(centers, n, spread, seed):
    rng = np.random.default_rng(seed)
    c = np.asarray(centers, np.float64)
    y = rng.integers(0, len(c), n)
    return (c[y] + rng.standard_normal((n, c.shape[1])) * spread), y


def inertia(x, labels):
    return sum(((x[labels == j] - x[labels == j].mean(0)) ** 2).sum()
               for j in np.unique(labels))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_inertia_within_sklearns(seed):
    """Overlapping blobs (5 in 6 dimensions): the port's best of 10 starts
    reaches at most 1.001 times sklearn's inertia."""
    rng = np.random.default_rng(100 + seed)
    x, _ = blobs(rng.standard_normal((5, 6)) * 2.0, 300, 1.0, seed)
    x = x.astype(np.float32)
    ref = KMeans(n_clusters=5, n_init=10, random_state=seed).fit(x)
    got = tm._kmeans(x, 5, seed)
    assert len(np.unique(got)) == 5
    assert inertia(x.astype(np.float64), got) <= 1.001 * ref.inertia_


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_partition_on_separated_blobs(seed):
    """Well-separated blobs: the same partition as sklearn's (and the
    JAX package's) k-means, up to relabelling."""
    x, y = blobs([[0, 0, 0], [10, 0, 0], [0, 10, 0], [0, 0, 10]], 200, 0.5,
                 seed)
    got = tm._kmeans(x, 4, seed)
    want = jm._kmeans(x, 4, seed)
    assert tm.ari(want, got) == 1.0 and tm.ari(y, got) == 1.0


def test_eval_helpers_end_to_end():
    """``eval_from_embeddings`` and ``spectral_eval_from_laplacian`` on
    separated data: every metric of the port equal to the JAX package's
    (the same partition), perfect clustering."""
    x, y = blobs([[0, 0], [8, 0], [0, 8]], 90, 0.3, 7)
    got = tm.eval_from_embeddings(x, y, 3)
    want = jm.eval_from_embeddings(x, y, 3)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got["accuracy"] == 1.0
    # a block-diagonal graph Laplacian: three cliques of 10
    adj = np.kron(np.eye(3), np.ones((10, 10))) - np.eye(30)
    lap = np.diag(adj.sum(1)) - adj
    labels = np.repeat(np.arange(3), 10)
    got = tm.spectral_eval_from_laplacian(lap, labels, 3)
    want = jm.spectral_eval_from_laplacian(lap, labels, 3)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got["nmi"] == 1.0
