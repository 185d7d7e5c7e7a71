"""Single-graph node-classification datasets (transductive) — port of
``graph_transformer_tpu/data/citation.py``.

The citation graphs (cora / citeseer / pubmed) are parsed from the standard
Planetoid files ``ind.<name>.*``, Zachary's karate club is held here as
constants (the card's machine has no networkx), and the planted-partition
generator is self-contained.  Every loader returns a
:class:`NodeGraphDataset`: a one-graph :class:`GraphDataset` (node ids
0..N-1, so the batching, sampling and model code apply as they are, with
the node vocabulary equal to the node count) plus per-node labels and
train/val/test masks.  The arrays equal the JAX package's loader for loader.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from graph_transformer_tpu_torch.data.tu import GraphDataset

# Zachary's karate club (networkx.karate_club_graph): the 78 undirected
# edges, and each member's club, 0 for "Mr. Hi" and 1 for "Officer"
KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33))
KARATE_CLUBS = (0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0,
                1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1)


@dataclasses.dataclass
class NodeGraphDataset:
    """A single graph with per-node labels for transductive classification."""

    name: str
    graph: GraphDataset  # exactly one graph; node ids are 0..N-1
    node_labels: np.ndarray  # [N] int32
    num_classes: int
    train_mask: np.ndarray  # [N] bool
    val_mask: np.ndarray  # [N] bool
    test_mask: np.ndarray  # [N] bool

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feature_dim(self) -> int:
        return self.graph.feature_dim

    # dense_adj materialises O(n²) floats: citation-scale graphs only
    DENSE_ADJ_MAX_NODES = 65536

    def dense_adj(self, n_pad: Optional[int] = None) -> np.ndarray:
        """Dense [n_pad, n_pad] 0/1 float32 adjacency, the mask of the
        contrastive and GAE losses; padding rows and columns stay zero."""
        n = n_pad if n_pad is not None else self.num_nodes
        if n > self.DENSE_ADJ_MAX_NODES:
            raise ValueError(
                f"dense_adj would materialize a {n}x{n} float32 matrix "
                f"({4 * n * n / 2**30:.1f} GiB); the dense-mask loss heads "
                "are citation-graph-scale only")
        a = np.zeros((n, n), dtype=np.float32)
        src, dst = self.graph.edge_arrays()
        a[src, dst] = 1.0
        return a

    def to_multiplex(self, **kw):
        """Lift into the multiplex pipeline: the graph and, by default, a
        cosine-kNN feature-similarity view
        (``data/multiplex.single_graph_with_similarity_layer``)."""
        from graph_transformer_tpu_torch.data.multiplex import (
            single_graph_with_similarity_layer,
        )

        return single_graph_with_similarity_layer(
            self.dense_adj(), self.graph.node_feat, self.node_labels,
            name=self.name + "+sim", **kw)


def _graph_from_edges(name: str, src: np.ndarray, dst: np.ndarray,
                      node_feat: np.ndarray, label: int = 0) -> GraphDataset:
    """A one-graph :class:`GraphDataset` from a directed edge list: self
    loops dropped, pairs deduplicated and symmetrised, CSR sorted by
    (source, target)."""
    n = node_feat.shape[0]
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    s = np.concatenate([pairs[:, 0], pairs[:, 1]])
    d = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    counts = np.bincount(s, minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return GraphDataset(
        name=name, node_feat=np.asarray(node_feat, dtype=np.float32),
        nbr_offsets=offsets, nbr_ids=d.astype(np.int32),
        graph_offsets=np.array([0, n], dtype=np.int64),
        labels=np.array([label], dtype=np.int32), num_classes=1)


def _masks_from_counts(n: int, n_train: int, n_val: int, test_idx: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    train = np.zeros(n, dtype=bool)
    val = np.zeros(n, dtype=bool)
    test = np.zeros(n, dtype=bool)
    train[:n_train] = True
    val[n_train:n_train + n_val] = True
    test[test_idx] = True
    return train, val, test


def _split_masks(n: int, train_fraction: float, seed: int):
    """(train, test): a random ``train_fraction`` of the nodes, the rest."""
    perm = np.random.default_rng(seed).permutation(n)
    train = np.zeros(n, dtype=bool)
    train[perm[:int(round(train_fraction * n))]] = True
    return train, ~train


# ----------------------------------------------------------------- planetoid
def _pickle_load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_planetoid(name: str, data_dir: Optional[str] = None
                   ) -> NodeGraphDataset:
    """Parse the Planetoid files ``ind.<name>.{x,y,tx,ty,allx,ally,graph,
    test.index}`` (cora / citeseer / pubmed).  ``data_dir`` defaults to
    ``$GT_TPU_CITATION``.  Citeseer's isolated test nodes, missing from
    ``tx``, get zero rows and class 0 (outside every mask)."""
    import scipy.sparse as sp

    name = name.lower()
    d = data_dir or os.environ.get("GT_TPU_CITATION", "")
    if not d or not os.path.exists(os.path.join(d, f"ind.{name}.x")):
        raise FileNotFoundError(
            f"planetoid files for {name!r} not found under {d!r}; "
            "set GT_TPU_CITATION or pass data_dir")

    def obj(suffix):
        return _pickle_load(os.path.join(d, f"ind.{name}.{suffix}"))

    x, y = obj("x"), obj("y")
    tx, ty = obj("tx"), obj("ty")
    allx, ally = obj("allx"), obj("ally")
    graph = obj("graph")  # dict node -> [neighbors]
    with open(os.path.join(d, f"ind.{name}.test.index")) as f:
        test_idx = np.array([int(line) for line in f if line.strip()],
                            dtype=np.int64)
    test_sorted = np.sort(test_idx)
    full_range = np.arange(test_sorted[0], test_sorted[-1] + 1)
    tx_full = sp.lil_matrix((len(full_range), x.shape[1]), dtype=np.float32)
    ty_full = np.zeros((len(full_range), y.shape[1]), dtype=np.float32)
    pos = test_idx - test_sorted[0]
    tx_full[pos] = tx
    ty_full[pos] = ty
    feats = sp.vstack([sp.csr_matrix(allx), sp.csr_matrix(tx_full)]).toarray()
    labels_1hot = np.vstack([ally, ty_full])
    n = feats.shape[0]
    labels = np.where(labels_1hot.sum(axis=1) > 0,
                      labels_1hot.argmax(axis=1), 0).astype(np.int32)
    src = np.concatenate(
        [np.full(len(vs), u, dtype=np.int64) for u, vs in graph.items()]
        or [np.zeros(0, dtype=np.int64)])
    dst = np.concatenate(
        [np.asarray(vs, dtype=np.int64) for vs in graph.values()]
        or [np.zeros(0, dtype=np.int64)])
    inside = (dst < n) & (src < n)
    g = _graph_from_edges(name, src[inside], dst[inside], feats)
    train, val, test = _masks_from_counts(n, y.shape[0], 500, test_idx)
    return NodeGraphDataset(name=name, graph=g, node_labels=labels,
                            num_classes=labels_1hot.shape[1],
                            train_mask=train, val_mask=val, test_mask=test)


# -------------------------------------------------------------------- karate
def karate_club(train_fraction: float = 0.5, seed: int = 0
                ) -> NodeGraphDataset:
    """Zachary's karate club with the two clubs as labels and identity
    one-hot features; a random ``train_fraction`` of the members trains,
    the rest tests."""
    n = len(KARATE_CLUBS)
    edges = np.asarray(KARATE_EDGES, dtype=np.int64)
    gd = _graph_from_edges("karate", edges[:, 0], edges[:, 1],
                           np.eye(n, dtype=np.float32))
    train, test = _split_masks(n, train_fraction, seed)
    return NodeGraphDataset(
        name="karate", graph=gd,
        node_labels=np.asarray(KARATE_CLUBS, dtype=np.int32), num_classes=2,
        train_mask=train, val_mask=np.zeros(n, dtype=bool), test_mask=test)


# ----------------------------------------------------------------- synthetic
def sbm_synthetic(num_nodes: int = 120, num_classes: int = 3,
                  p_in: float = 0.15, p_out: float = 0.01,
                  feature_dim: int = 16, feature_scale: float = 1.0,
                  train_fraction: float = 0.6, seed: int = 0
                  ) -> NodeGraphDataset:
    """Planted-partition graph with per-class gaussian features."""
    rng = np.random.default_rng(seed)
    labels = np.sort(rng.integers(0, num_classes, size=num_nodes)
                     ).astype(np.int32)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((num_nodes, num_nodes)) < prob, k=1)
    src, dst = np.nonzero(upper)
    centers = rng.normal(0, feature_scale, size=(num_classes, feature_dim))
    feats = centers[labels] + rng.normal(0, 0.5,
                                         size=(num_nodes, feature_dim))
    gd = _graph_from_edges("sbm", src, dst, feats.astype(np.float32))
    perm = rng.permutation(num_nodes)
    train = np.zeros(num_nodes, dtype=bool)
    train[perm[:int(round(train_fraction * num_nodes))]] = True
    return NodeGraphDataset(
        name="sbm", graph=gd, node_labels=labels, num_classes=num_classes,
        train_mask=train, val_mask=np.zeros(num_nodes, dtype=bool),
        test_mask=~train)


def from_arrays(name: str, src: np.ndarray, dst: np.ndarray,
                features: np.ndarray, labels: np.ndarray,
                train_mask: Optional[np.ndarray] = None,
                val_mask: Optional[np.ndarray] = None,
                test_mask: Optional[np.ndarray] = None,
                train_fraction: float = 0.6, seed: int = 0
                ) -> NodeGraphDataset:
    """A dataset from raw arrays; 2-d (multi-label) labels reduce to their
    argmax class.  Without ``train_mask``, a random ``train_fraction``
    trains and the rest tests."""
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels.argmax(axis=1)
    labels = labels.astype(np.int32)
    n = np.asarray(features).shape[0]
    g = _graph_from_edges(name, src, dst, features)
    if train_mask is None:
        train_mask, test_mask = _split_masks(n, train_fraction, seed)
        val_mask = np.zeros(n, dtype=bool)

    def mask(m):
        return np.zeros(n, bool) if m is None else np.asarray(m, bool)

    return NodeGraphDataset(
        name=name, graph=g, node_labels=labels,
        num_classes=int(labels.max()) + 1,
        train_mask=np.asarray(train_mask, bool), val_mask=mask(val_mask),
        test_mask=mask(test_mask))


def load_ppi(data_dir: Optional[str] = None, split: str = "train",
             graph_index: int = 0) -> NodeGraphDataset:
    """Graph ``graph_index`` of a split of the standard PPI download
    (``{split}_graph.json`` node-link graph, ``{split}_feats.npy``,
    ``{split}_labels.npy`` [N, 121], ``{split}_graph_id.npy``), re-split
    transductively; ``data_dir`` defaults to ``$GT_TPU_PPI``."""
    import json

    d = data_dir or os.environ.get("GT_TPU_PPI", "")
    gpath = os.path.join(d, f"{split}_graph.json")
    if not d or not os.path.exists(gpath):
        raise FileNotFoundError(
            f"PPI files for split {split!r} not found under {d!r}; "
            "set GT_TPU_PPI or pass data_dir (expects the standard "
            "ppi.zip contents)")
    with open(gpath) as f:
        gjson = json.load(f)
    feats = np.load(os.path.join(d, f"{split}_feats.npy"))
    labels = np.load(os.path.join(d, f"{split}_labels.npy"))
    graph_ids = np.load(os.path.join(d, f"{split}_graph_id.npy"))
    want = np.unique(graph_ids)[graph_index]
    keep = np.nonzero(graph_ids == want)[0]
    remap = np.full(len(graph_ids), -1, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    src = np.array([e["source"] for e in gjson["links"]], dtype=np.int64)
    dst = np.array([e["target"] for e in gjson["links"]], dtype=np.int64)
    inside = (remap[src] >= 0) & (remap[dst] >= 0)
    return from_arrays(f"ppi-{split}{graph_index}", remap[src[inside]],
                       remap[dst[inside]], feats[keep], labels[keep])


def load_npz(path: str, name: Optional[str] = None) -> NodeGraphDataset:
    """:func:`from_arrays` inputs from an ``.npz`` with keys ``src, dst,
    features, labels`` (and optionally ``train_mask, val_mask,
    test_mask``)."""
    z = np.load(path)

    def opt(k):
        return z[k] if k in z.files else None

    return from_arrays(
        name or os.path.splitext(os.path.basename(path))[0],
        z["src"], z["dst"], z["features"], z["labels"],
        train_mask=opt("train_mask"), val_mask=opt("val_mask"),
        test_mask=opt("test_mask"))


NODE_DATASETS: Dict[str, Callable[..., NodeGraphDataset]] = {
    "karate": karate_club,
    "sbm": sbm_synthetic,
    "cora": lambda **kw: load_planetoid("cora", **kw),
    "citeseer": lambda **kw: load_planetoid("citeseer", **kw),
    "pubmed": lambda **kw: load_planetoid("pubmed", **kw),
    "ppi": load_ppi,
}


def load_node_dataset(name: str, **kwargs) -> NodeGraphDataset:
    if name not in NODE_DATASETS:
        raise KeyError(
            f"unknown node dataset {name!r}; have {sorted(NODE_DATASETS)}")
    return NODE_DATASETS[name](**kwargs)
