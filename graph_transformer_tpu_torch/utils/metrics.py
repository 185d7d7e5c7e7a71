"""Clustering and embedding metrics — port of
``graph_transformer_tpu/utils/metrics.py``.

Purity, the best label-permutation accuracy (Hungarian assignment, scipy),
the majority-vote clustering error, spectral evaluation from a Laplacian and
k-means evaluation of embeddings, as the JAX package has them.  The JAX
package takes NMI, ARI and k-means from sklearn, which the card's machine
does not have; here they are numpy:

- :func:`nmi`: sklearn's ``normalized_mutual_info_score`` with the
  ``arithmetic`` normalisation, from the contingency table (1.0 when both
  labelings are one cluster, 0.0 when the mutual information is 0);
- :func:`ari`: sklearn's ``adjusted_rand_score`` from the pair confusion
  matrix, in integers;
- :func:`_kmeans`: k-means++ seeding as sklearn draws it (the first center
  uniformly, then ``2 + ln k`` candidates a center drawn by squared
  distance, the one that lowers the potential most kept), Lloyd iterations
  to sklearn's tolerance (1e-4 times the mean feature variance) on the
  centred data, 10 starts from one ``RandomState(seed)``, the best inertia
  kept.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

N_INIT = 10
MAX_ITER = 300
TOL = 1e-4


def purity(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Σ over clusters of the largest class count, over N."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    total = 0
    for c in np.unique(y_pred):
        members = y_true[y_pred == c]
        if len(members):
            total += np.bincount(members).max()
    return total / len(y_true)


def _contingency(y_true, y_pred) -> np.ndarray:
    """[classes, clusters] int64 counts."""
    _, ti = np.unique(np.asarray(y_true), return_inverse=True)
    _, pi = np.unique(np.asarray(y_pred), return_inverse=True)
    c = np.zeros((ti.max(initial=-1) + 1, pi.max(initial=-1) + 1), np.int64)
    np.add.at(c, (ti.ravel(), pi.ravel()), 1)
    return c


def clustering_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Accuracy under the best one-to-one map of clusters to classes."""
    from scipy.optimize import linear_sum_assignment

    w = _contingency(y_true, y_pred).T  # [clusters, classes]
    ri, ci = linear_sum_assignment(-w)
    return w[ri, ci].sum() / len(np.asarray(y_true))


def clustering_error_majority(y_true: np.ndarray,
                              y_pred: np.ndarray) -> float:
    """Mean over clusters of the error of labelling each by its majority."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    errs = []
    for c in np.unique(y_pred):
        members = y_true[y_pred == c]
        if len(members):
            errs.append(1.0 - np.bincount(members).max() / len(members))
    return float(np.mean(errs)) if errs else 1.0


def _entropy(labels) -> float:
    if len(labels) == 0:
        return 1.0
    pi = np.bincount(np.unique(labels, return_inverse=True)[1].ravel()
                     ).astype(np.float64)
    pi = pi[pi > 0]
    if pi.size == 1:
        return 0.0
    s = np.sum(pi)
    return float(-np.sum((pi / s) * (np.log(pi) - np.log(s))))


def _mutual_info(c: np.ndarray) -> float:
    nzx, nzy = np.nonzero(c)
    nz = c[nzx, nzy].astype(np.float64)
    total = c.sum()
    pi, pj = c.sum(axis=1), c.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    cnm = nz / total
    mi = cnm * (np.log(nz) - np.log(total)) + cnm * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def nmi(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Normalised mutual information, arithmetic-mean normalisation."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    nt, npred = len(np.unique(y_true)), len(np.unique(y_pred))
    if nt == npred == 1 or nt == npred == 0:
        return 1.0
    mi = _mutual_info(_contingency(y_true, y_pred))
    if mi == 0:
        return 0.0
    return float(mi / ((_entropy(y_true) + _entropy(y_pred)) / 2))


def ari(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Adjusted Rand index from the pair confusion matrix."""
    c = _contingency(y_true, y_pred)
    n = int(c.sum())
    n_c, n_k = c.sum(axis=1), c.sum(axis=0)
    sq = int((c.astype(np.int64) ** 2).sum())
    tp = sq - n
    fp = int((c @ n_k).sum()) - sq
    fn = int((c.T @ n_c).sum()) - sq
    tn = n * n - fp - fn - sq
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def _sq_dist(a: np.ndarray, x: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """[len(a), len(x)] squared distances, clipped at 0."""
    d = (a * a).sum(1)[:, None] - 2.0 * (a @ x.T) + x_sq[None, :]
    return np.maximum(d, 0.0)


def _plusplus(x: np.ndarray, x_sq: np.ndarray, k: int,
              rs: np.random.RandomState) -> np.ndarray:
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    first = rs.choice(n, p=np.full(n, 1.0 / n))
    centers[0] = x[first]
    closest = _sq_dist(x[first:first + 1], x, x_sq)[0]
    pot = closest.sum()
    for c in range(1, k):
        vals = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(closest), vals)
        np.clip(cand, None, n - 1, out=cand)
        d = np.minimum(closest, _sq_dist(x[cand], x, x_sq))
        pots = d.sum(1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best]
        centers[c] = x[cand[best]]
    return centers


def _lloyd(x: np.ndarray, x_sq: np.ndarray, centers: np.ndarray, tol: float):
    """(labels, inertia) of Lloyd's iterations from ``centers``."""
    k = centers.shape[0]
    labels = None
    for _ in range(MAX_ITER):
        new = _sq_dist(centers, x, x_sq).argmin(0)
        moved = np.stack([x[new == j].mean(0) if np.any(new == j)
                          else centers[j] for j in range(k)])
        shift = ((moved - centers) ** 2).sum()
        same = labels is not None and np.array_equal(new, labels)
        labels, centers = new, moved
        if same or shift <= tol:
            break
    labels = _sq_dist(centers, x, x_sq).argmin(0)
    inertia = float(((x - centers[labels]) ** 2).sum())
    return labels, inertia


def _kmeans(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Cluster labels of the rows of ``x``: the best inertia of
    ``N_INIT`` k-means++ starts."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean(0)
    x_sq = (x * x).sum(1)
    tol = float(np.mean(np.var(x, axis=0))) * TOL
    rs = np.random.RandomState(seed)
    best, best_inertia = None, np.inf
    for _ in range(N_INIT):
        labels, inertia = _lloyd(x, x_sq, _plusplus(x, x_sq, k, rs), tol)
        if inertia < best_inertia:
            best, best_inertia = labels, inertia
    return best


def all_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    return {"purity": purity(y_true, y_pred),
            "accuracy": clustering_accuracy(y_true, y_pred),
            "avg_error": clustering_error_majority(y_true, y_pred),
            "nmi": nmi(y_true, y_pred), "ari": ari(y_true, y_pred)}


def spectral_eval_from_laplacian(lap: np.ndarray, y_true: np.ndarray,
                                 num_clusters: int, seed: int = 0
                                 ) -> Dict[str, float]:
    """eigh, the ``num_clusters`` smallest eigenvectors, k-means, metrics."""
    _, vecs = np.linalg.eigh(lap)
    pred = _kmeans(vecs[:, :num_clusters], num_clusters, seed)
    return all_metrics(y_true, pred)


def eval_from_embeddings(emb: np.ndarray, y_true: np.ndarray,
                         num_clusters: int, seed: int = 0
                         ) -> Dict[str, float]:
    """k-means on the embeddings, metrics."""
    return all_metrics(y_true, _kmeans(np.asarray(emb), num_clusters, seed))
