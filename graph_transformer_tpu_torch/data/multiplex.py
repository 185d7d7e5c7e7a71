"""Multiplex (multilayer) graph datasets — port of
``graph_transformer_tpu/data/multiplex.py``.

Every loader returns one :class:`MultiplexDataset` (dense per-view adjacency
and Laplacian stacks, per-view features, node labels, train/test masks), the
arrays the JAX package's loader returns for the same files:

- synthetic 4-layer gaussian clusters (:func:`gaussian_multiplex`)
- Vickers-Chan 7th-graders multiplex edges (:func:`vickers_chan`)
- Congress votes, mammographic masses, balance-scale: one coincidence layer
  per attribute (:func:`congress_votes`, :func:`mammographic`,
  :func:`balance_scale`)
- Leskovec-Ng as an edge list or as .mat adjacency files
- UCI mfeat's six kNN-similarity views (:func:`uci_mfeat`)
- generic multi-view .mat (:func:`mat_multiview`)
- a single graph with a kNN feature-similarity layer
  (:func:`single_graph_with_similarity_layer`)

The card's machine has neither sklearn nor pandas, so what the JAX module
takes from them is numpy here, held to sklearn 1.9 by the tests:

- :func:`scale`: ``sklearn.preprocessing.scale`` (mean removed, divided by
  the ddof-0 std, a std below ten epsilons taken as 1; float32 input stays
  float32, as in sklearn).  The JAX
  module skips scaling where sklearn is missing; the port always scales.
- :func:`pca`: ``PCA(n_components=k, svd_solver="full")``: an exact SVD of
  the centred data, each component's largest-|.| entry made positive
  (``svd_flip(u_based_decision=False)``), the data projected on the first
  k.  sklearn's default ``svd_solver="auto"`` takes an unseeded randomized
  SVD where D > 1,000 or N < 10 D, max(N, D) > 500 and k < 0.8 min(N, D)
  (UCI mfeat's fac and pix views at N = 2,000): there the JAX loader does
  not repeat itself, and the port gives the exact projection.
- :func:`kneighbors_graph`: ``sklearn.neighbors.kneighbors_graph`` in
  connectivity mode, cosine or euclidean.  Neighbors are ranked by
  (distance, index).  sklearn ranks ties in the order its selection
  (``np.argpartition``, or a KD tree for euclidean data of few columns)
  returns them, which need not be by index, so where a tie straddles the
  k-th place the two can keep different neighbors.
- the table readers (:func:`read_table`): ``pandas.read_csv``'s columns,
  each typed int, else float, else kept as strings; category codes are the
  sorted-unique codes of ``pd.Categorical``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Dict, List, Sequence

import numpy as np

KNN_CHUNK_ROWS = 1024


@dataclasses.dataclass
class MultiplexDataset:
    """One node set observed through S graph views."""

    name: str
    x: np.ndarray  # [N, D, S] float32 per-view node features
    adj: np.ndarray  # [N, N, S] float32 per-view adjacency
    lap: np.ndarray  # [N, N, S] float64 per-view unnormalized Laplacian
    labels: np.ndarray  # [N] int32
    train_mask: np.ndarray  # [N] bool
    test_mask: np.ndarray  # [N] bool

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_views(self) -> int:
        return self.adj.shape[2]

    @property
    def num_classes(self) -> int:
        return len(np.unique(self.labels))

    @property
    def feature_dim(self) -> int:
        return self.x.shape[1]


# ------------------------------------------------- sklearn's parts, in numpy
def _float_array(x) -> np.ndarray:
    """A copy of ``x`` in float32 if it is float32, else float64, as
    sklearn's estimators take their input."""
    x = np.asarray(x)
    return np.array(x, dtype=np.float32 if x.dtype == np.float32
                    else np.float64)


def scale(x: np.ndarray) -> np.ndarray:
    """``sklearn.preprocessing.scale``: columns to zero mean and unit ddof-0
    std (in float32 for float32 input, else float64), with sklearn's
    re-centring where a first pass leaves means that are not ``allclose``
    to 0."""
    x = _float_array(x)
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    x -= mean
    mean1 = x.mean(axis=0)
    if not np.allclose(mean1, 0):
        x -= mean1
    std[std < 10 * np.finfo(std.dtype).eps] = 1.0
    x /= std
    mean2 = x.mean(axis=0)
    if not np.allclose(mean2, 0):
        x -= mean2
    return x


def pca(x: np.ndarray, k: int) -> np.ndarray:
    """``PCA(n_components=k, svd_solver="full").fit_transform(x)``: the
    centred data's first k principal coordinates by LAPACK's SVD (scipy's,
    as sklearn calls it), signs by sklearn's rule (each component's entry of
    largest magnitude positive)."""
    import scipy.linalg

    x = _float_array(x)
    xc = x - x.mean(axis=0)
    u, s, vt = scipy.linalg.svd(xc, full_matrices=False)
    top = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), top])
    return (u[:, :k] * signs[:k]) * s[:k]


def _distances(x: np.ndarray, rows: slice, metric: str) -> np.ndarray:
    """[rows, N] distances of rows ``rows`` of ``x`` to every row, as
    sklearn computes them: cosine 1 - the rows' normalised products clipped
    to [0, 2] (each row's own distance 0); euclidean from the
    differences."""
    if metric == "cosine":
        norms = np.sqrt(np.einsum("ij,ij->i", x, x))
        norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
        xn = x / norms[:, None]
        d = 1.0 - xn[rows] @ xn.T
        np.clip(d, 0.0, 2.0, out=d)
        idx = np.arange(rows.start, rows.stop)
        d[idx - rows.start, idx] = 0.0
        return d
    if metric in ("minkowski", "euclidean"):
        diff = x[rows, None, :] - x[None, :, :]
        return np.sqrt(np.einsum("ijk,ijk->ij", diff, diff))
    raise ValueError(f"unknown kNN metric {metric!r} (cosine | euclidean)")


def kneighbors_graph(x: np.ndarray, n_neighbors: int,
                     metric: str = "minkowski",
                     include_self: bool = False) -> np.ndarray:
    """``sklearn.neighbors.kneighbors_graph(x, k, metric=...,
    include_self=...).toarray()``: row i has a 1 at each of its k nearest
    rows, ranked by (distance, index); without ``include_self`` row i itself
    is left out of its ranking.  Distances in float32 for float32 input,
    else float64, as sklearn computes them.  Dense [N, N] float64."""
    x = _float_array(x)
    n = x.shape[0]
    if metric == "euclidean" or metric == "minkowski":
        step = max(1, KNN_CHUNK_ROWS * 64 // max(1, x.shape[1]))
    else:
        step = KNN_CHUNK_ROWS
    a = np.zeros((n, n), dtype=np.float64)
    for start in range(0, n, step):
        rows = slice(start, min(n, start + step))
        d = _distances(x, rows, metric)
        own = np.arange(rows.start, rows.stop)
        if not include_self:
            d[own - rows.start, own] = np.inf
        order = np.argsort(d, axis=1, kind="stable")[:, :n_neighbors]
        a[own[:, None], order] = 1.0
    return a


def _parse_column(values: List[str]) -> np.ndarray:
    """A column as pandas types it: int64 where every entry is an integer,
    else float64 where every entry is a number, else the strings."""
    for kind in (int, float):
        try:
            return np.array([kind(v) for v in values])
        except ValueError:
            continue
    return np.array(values, dtype=object)


def read_table(path: str, sep: str) -> List[np.ndarray]:
    """The columns of a headerless delimited file (``pandas.read_csv(path,
    sep=sep, header=None)``), each typed by :func:`_parse_column`."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=sep) if r]
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError(f"{path}: rows of unequal width")
    return [_parse_column([r[j] for r in rows]) for j in range(width)]


def columns_to_numpy(cols: Sequence[np.ndarray]) -> np.ndarray:
    """``DataFrame.to_numpy()`` of the columns: int64 or float64 where every
    column is numeric (float64 where any is), else an object array."""
    if all(c.dtype != object for c in cols):
        dtype = (np.int64 if all(c.dtype.kind == "i" for c in cols)
                 else np.float64)
        return np.stack([c.astype(dtype) for c in cols], axis=1)
    out = np.empty((len(cols[0]), len(cols)), dtype=object)
    for j, c in enumerate(cols):
        out[:, j] = list(c)
    return out


def category_codes(values: np.ndarray) -> np.ndarray:
    """``pd.Categorical(values).codes``: each value's rank among the sorted
    distinct values."""
    return np.unique(np.asarray(values), return_inverse=True)[1].reshape(-1)


def _read_edges(path: str, width: int) -> np.ndarray:
    """[E, width] int64 of a space-separated integer edge list."""
    cols = read_table(path, " ")
    if len(cols) != width or any(c.dtype.kind != "i" for c in cols):
        raise ValueError(f"{path}: expected {width} integer columns")
    return np.stack(cols, axis=1)


# ------------------------------------------------------------------- helpers
def raw_laplacian(w: np.ndarray) -> np.ndarray:
    """Unnormalized Laplacian L = D - W_offdiag of a (possibly directed)
    weight matrix, row degrees taken on Wᵀ (``sgwt_raw_laplacian``)."""
    b = np.asarray(w, dtype=np.float64).T
    degrees = b.sum(axis=1)
    off = b.copy()
    np.fill_diagonal(off, 0.0)
    return np.diag(degrees - np.diag(b)) - off


def knn_graph(x: np.ndarray, n_neighbors: int, metric: str = "minkowski",
              include_self: bool = False,
              symmetrize: str = "avg_binary") -> np.ndarray:
    """kNN adjacency: ``symmetrize='avg_binary'`` gives (A+Aᵀ)/2 > 0
    (``build_kneighbors``), ``'none'`` the directed graph."""
    a = kneighbors_graph(x, n_neighbors, metric=metric,
                         include_self=include_self)
    if symmetrize == "avg_binary":
        return ((a + a.T) / 2 > 0).astype(np.float64)
    if symmetrize == "none":
        return a
    raise ValueError(f"unknown symmetrize {symmetrize!r} (avg_binary | none)")


def make_symmetric(a: np.ndarray) -> np.ndarray:
    """((A+Aᵀ)/2 > 0) as int."""
    return (((a + a.T) / 2) > 0).astype(int)


def train_test_masks(n: int, fraction: float = 0.6, rng=None):
    """Random disjoint train/test masks."""
    rng = rng or np.random.default_rng(0)
    order = rng.permutation(n)
    k = int(fraction * n)
    train = np.zeros(n, bool)
    test = np.zeros(n, bool)
    train[order[:k]] = True
    test[order[k:]] = True
    return train, test


def shape_features(feats: np.ndarray, size_x: int, do_scale: bool = True,
                   rng=None) -> np.ndarray:
    """The reference's feature shaping: standardize, then PCA down to
    ``size_x`` if wider, random-normal pad (from ``rng``) if narrower."""
    rng = rng or np.random.default_rng(0)
    f = scale(feats) if do_scale else np.asarray(feats, float)
    n, d = f.shape
    if size_x < d:
        return pca(f, size_x)
    if size_x > d:
        return np.concatenate([f, rng.normal(size=(n, size_x - d))], axis=1)
    return f


def coincidence_digraph(values: Sequence) -> np.ndarray:
    """Directed attribute-coincidence graph: edge i→j iff value_i ==
    value_j, self pairs included."""
    v = np.asarray(values)
    return (v[:, None] == v[None, :]).astype(int)


def _edge_list_adj(src, dst, n) -> np.ndarray:
    a = np.zeros((n, n), dtype=int)
    a[np.asarray(src), np.asarray(dst)] = 1
    return a


def _stack_views(adj_list: List[np.ndarray]):
    adj = np.stack(adj_list, axis=2).astype(np.float32)
    lap = np.stack([raw_laplacian(a) for a in adj_list], axis=2)
    return adj, lap


def _random_features(n: int, size_x: int, n_views: int, rng) -> np.ndarray:
    x = rng.normal(size=(n, size_x)).astype(np.float32)
    return np.stack([x] * n_views, axis=2)


# ------------------------------------------------------------------- loaders
def gaussian_multiplex(n: int = 200, num_clusters: int = 5, size_x: int = 8,
                       seed: int = 100, knn: int = 10) -> MultiplexDataset:
    """Synthetic 4-view gaussian-cluster multiplex: per view, clusters drawn
    from random gaussians; a kNN(10) graph on the per-view 2-d signals;
    features = the signals (max-normalized) and a shared random block."""
    rng = np.random.default_rng(seed)
    per = n // num_clusters
    n = per * num_clusters
    views = 4
    sig_list, adj_list = [], []
    for _ in range(views):
        sigs = []
        for _c in range(num_clusters):
            mean = 3 * rng.standard_normal(2)
            cov = np.zeros((2, 2))
            for _ in range(5):
                m = (3 / 5) * rng.standard_normal((2, 2))
                cov += m.T @ m
            sigs.append(rng.multivariate_normal(mean, cov, per))
        sig = np.concatenate(sigs, axis=0)
        sig_list.append(sig)
        adj_list.append(knn_graph(sig, knn))
    signals = np.stack(sig_list, axis=2)  # [N, 2, S]
    signals = signals / signals.max()
    pad = _random_features(n, size_x, views, rng)
    x = np.concatenate([signals, pad], axis=1).astype(np.float32)
    adj, lap = _stack_views(adj_list)
    labels = np.repeat(np.arange(num_clusters), per).astype(np.int32)
    train, test = train_test_masks(n, rng=rng)
    return MultiplexDataset("gaussian", x, adj, lap, labels, train, test)


def vickers_chan(edges_path: str, size_x: int = 8,
                 train_fraction: float = 0.6, seed: int = 0
                 ) -> MultiplexDataset:
    """Vickers-Chan 7th-graders: 3 directed layers from a "layerId src dst
    weight" edge list, 1-indexed; nodes 0-11 boys, 12+ girls."""
    e = _read_edges(edges_path, 4)
    layer, src, dst = e[:, 0], e[:, 1] - 1, e[:, 2] - 1
    n = int(src.max()) + 1
    adj_list = [_edge_list_adj(src[layer == v], dst[layer == v], n)
                for v in (1, 2, 3)]
    rng = np.random.default_rng(seed)
    adj, lap = _stack_views(adj_list)
    labels = np.zeros(n, np.int32)
    labels[12:] = 1
    train, test = train_test_masks(n, train_fraction, rng)
    x = _random_features(n, size_x, 3, rng)
    return MultiplexDataset("vickers_chan", x, adj, lap, labels, train, test)


def _attribute_layers_dataset(name: str, table: np.ndarray,
                              labels: np.ndarray, attach_features: bool,
                              size_x: int, train_fraction: float,
                              seed: int) -> MultiplexDataset:
    """Shared core of the congress/mammographic/balance loaders: one graph
    view per attribute column, edges = value coincidence."""
    rng = np.random.default_rng(seed)
    n, n_views = table.shape
    adj_list = [coincidence_digraph(table[:, j]) for j in range(n_views)]
    adj, lap = _stack_views(adj_list)
    rand = _random_features(n, size_x, n_views, rng)
    if attach_features:
        missing = (table == "?") if table.dtype == object else False
        numeric = np.where(missing, -1, table).astype(float)
        feat = np.stack([scale(numeric)] * n_views, axis=2).astype(np.float32)
        x = np.concatenate([feat, rand], axis=1)
    else:
        x = rand
    train, test = train_test_masks(n, train_fraction, rng)
    return MultiplexDataset(name, x, adj, lap, labels.astype(np.int32), train,
                            test)


def congress_votes(data_path: str, size_x: int = 8,
                   train_fraction: float = 0.6, seed: int = 0
                   ) -> MultiplexDataset:
    """UCI house-votes-84: 16 vote-coincidence layers; label = party
    (random features only)."""
    cols = read_table(data_path, ",")
    labels = (cols[0] == "republican").astype(np.int32)
    return _attribute_layers_dataset("congress", columns_to_numpy(cols[1:]),
                                     labels, False, size_x, train_fraction,
                                     seed)


def mammographic(data_path: str, size_x: int = 8,
                 train_fraction: float = 0.6, seed: int = 0
                 ) -> MultiplexDataset:
    """UCI mammographic masses: 5 attribute layers; features = scaled
    attributes + random pad."""
    cols = read_table(data_path, ",")
    labels = cols[-1].astype(np.int32)
    return _attribute_layers_dataset("mammographic",
                                     columns_to_numpy(cols[:-1]), labels,
                                     True, size_x, train_fraction, seed)


def balance_scale(data_path: str, size_x: int = 8,
                  train_fraction: float = 0.6, seed: int = 0
                  ) -> MultiplexDataset:
    """UCI balance-scale: label in column 0, 4 attribute layers."""
    cols = read_table(data_path, ",")
    labels = category_codes(cols[0]).astype(np.int32)
    return _attribute_layers_dataset("balance_scale",
                                     columns_to_numpy(cols[1:]), labels, True,
                                     size_x, train_fraction, seed)


def leskovec_ng(edges_path: str, labels_path: str, size_x: int = 8,
                train_fraction: float = 0.6, seed: int = 0
                ) -> MultiplexDataset:
    """Leskovec-Ng co-authorship, edge-list form: 4 layers of "layerId src
    dst", 0-indexed."""
    e = _read_edges(edges_path, 3)
    layer, src, dst = e[:, 0], e[:, 1], e[:, 2]
    labels = np.loadtxt(labels_path).astype(np.int32)
    n = int(max(src.max(), dst.max())) + 1
    adj_list = [_edge_list_adj(src[layer == v], dst[layer == v], n)
                for v in (0, 1, 2, 3)]
    rng = np.random.default_rng(seed)
    adj, lap = _stack_views(adj_list)
    train, test = train_test_masks(n, train_fraction, rng)
    x = _random_features(n, size_x, len(adj_list), rng)
    return MultiplexDataset("leskovec_ng", x, adj, lap, labels, train, test)


def leskovec_ng_mat(data_folder: str, size_x: int = 8,
                    train_fraction: float = 0.6, seed: int = 0
                    ) -> MultiplexDataset:
    """Leskovec-Ng from per-era .mat adjacency files A1..A4 and the
    ``LN_true.mat`` labels."""
    import scipy.io

    files = ["LN_1995_1999.mat", "LN_2000_2004.mat", "LN_2005_2009.mat",
             "LN_2010_2014.mat"]
    adj_list = []
    for i, f in enumerate(files):
        m = scipy.io.loadmat(os.path.join(data_folder, f))
        adj_list.append((np.asarray(m[f"A{i + 1}"]) > 0).astype(int))
    labels = (np.asarray(scipy.io.loadmat(
        os.path.join(data_folder, "LN_true.mat"))["s_LNG"]).flatten()
        .astype(np.int32) - 1)
    rng = np.random.default_rng(seed)
    adj, lap = _stack_views(adj_list)
    n = adj.shape[0]
    train, test = train_test_masks(n, train_fraction, rng)
    x = _random_features(n, size_x, len(files), rng)
    return MultiplexDataset("leskovec_ng_mat", x, adj, lap, labels, train,
                            test)


def multiview_features_dataset(name: str, view_feats: List[np.ndarray],
                               labels: np.ndarray, size_x: int = 8,
                               num_similarity_neighbors: int = 10,
                               scale_features: bool = True,
                               train_fraction: float = 0.6, seed: int = 0
                               ) -> MultiplexDataset:
    """Core of the multi-view loaders: per view, a cosine-kNN graph on the
    raw features (self included, not symmetrized) and the features shaped
    to ``size_x``; the Laplacians of the symmetrized graphs."""
    rng = np.random.default_rng(seed)
    n = view_feats[0].shape[0]
    adj_list, feat_list = [], []
    for feats in view_feats:
        adj_list.append(knn_graph(feats, num_similarity_neighbors,
                                  metric="cosine", include_self=True,
                                  symmetrize="none"))
        feat_list.append(shape_features(feats, size_x, scale_features, rng)
                         .astype(np.float32))
    adj = np.stack(adj_list, axis=2).astype(np.float32)
    lap = np.stack([raw_laplacian(make_symmetric(a)) for a in adj_list],
                   axis=2)
    x = np.stack(feat_list, axis=2)
    train, test = train_test_masks(n, train_fraction, rng)
    return MultiplexDataset(name, x, adj, lap, labels.astype(np.int32), train,
                            test)


MFEAT_VIEWS = ("mfeat-fac", "mfeat-fou", "mfeat-kar", "mfeat-mor",
               "mfeat-pix", "mfeat-zer")


def uci_mfeat(data_folder: str, size_x: int = 8,
              num_similarity_neighbors: int = 10, train_fraction: float = 0.6,
              seed: int = 0) -> MultiplexDataset:
    """UCI multiple-features digits: 6 whitespace-separated views
    (fac/fou/kar/mor/pix/zer), 2,000 samples, labels in 10 blocks of 200."""
    views = []
    for f in MFEAT_VIEWS:
        with open(os.path.join(data_folder, f)) as fh:
            views.append(np.array([line.split() for line in fh.readlines()],
                                  dtype=float))
    labels = np.repeat(np.arange(10), 200)
    return multiview_features_dataset("uci_mfeat", views, labels, size_x,
                                      num_similarity_neighbors, True,
                                      train_fraction, seed)


def mat_multiview(mat_path: str, size_x: int = 8,
                  num_similarity_neighbors: int = 10,
                  scale_features: bool = True, train_fraction: float = 0.6,
                  seed: int = 0) -> MultiplexDataset:
    """Generic multi-view .mat with a ``data`` cell array of per-view [D, N]
    features and ``truelabel``."""
    import scipy.io
    import scipy.sparse

    m = scipy.io.loadmat(mat_path)
    num_views = m["data"].shape[1]
    labels = np.asarray(m["truelabel"][0, 0]).squeeze().astype(np.int32)
    labels = labels - labels.min()
    views = []
    for i in range(num_views):
        feats = m["data"][0, i].T
        if scipy.sparse.issparse(feats):
            feats = np.asarray(feats.todense())
        views.append(np.asarray(feats, dtype=float))
    name = os.path.splitext(os.path.basename(mat_path))[0]
    return multiview_features_dataset(name, views, labels, size_x,
                                      num_similarity_neighbors,
                                      scale_features, train_fraction, seed)


def single_graph_with_similarity_layer(
        adj: np.ndarray, feats: np.ndarray, labels: np.ndarray,
        size_x: int = 8, create_similarity_layer: bool = True,
        num_similarity_neighbors: int = 10, scale_features: bool = True,
        train_fraction: float = 0.6, seed: int = 0,
        name: str = "graph+sim") -> MultiplexDataset:
    """A single graph, optionally with a cosine-kNN feature-similarity view
    (self left out, not symmetrized): the adapter that lifts a node-
    classification graph into the multiplex pipeline."""
    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    shaped = shape_features(feats, size_x, scale_features, rng).astype(
        np.float32)
    adj_list = [np.asarray(adj, float)]
    lap_list = [raw_laplacian(make_symmetric(adj_list[0]))]
    feat_list = [shaped]
    if create_similarity_layer:
        sim = knn_graph(feats, num_similarity_neighbors, metric="cosine",
                        include_self=False, symmetrize="none")
        adj_list.append(sim)
        lap_list.append(raw_laplacian(make_symmetric(sim)))
        feat_list.append(shaped)
    train, test = train_test_masks(n, train_fraction, rng)
    return MultiplexDataset(name, np.stack(feat_list, axis=2),
                            np.stack(adj_list, axis=2).astype(np.float32),
                            np.stack(lap_list, axis=2),
                            np.asarray(labels, np.int32), train, test)


# ------------------------------------------------------------------ registry
MULTIPLEX_LOADERS: Dict[str, Callable[..., MultiplexDataset]] = {
    "gaussian": gaussian_multiplex,
    "vickers_chan": vickers_chan,
    "congress": congress_votes,
    "mammographic": mammographic,
    "balance_scale": balance_scale,
    "leskovec_ng": leskovec_ng,
    "leskovec_ng_mat": leskovec_ng_mat,
    "uci_mfeat": uci_mfeat,
    "mat_multiview": mat_multiview,
}


def load_multiplex(name: str, **kwargs) -> MultiplexDataset:
    """The loader named ``name`` with ``kwargs``."""
    if name not in MULTIPLEX_LOADERS:
        raise KeyError(f"unknown multiplex dataset {name!r}; have "
                       f"{sorted(MULTIPLEX_LOADERS)}")
    return MULTIPLEX_LOADERS[name](**kwargs)
