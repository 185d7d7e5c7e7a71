"""TU graph-classification dataset core — a copy of
``graph_transformer_tpu/data/tu.py`` (numpy only).

Parses the powerful-gnns text format into a flat struct-of-arrays
representation (global CSR adjacency + per-graph node ranges) that is the
single substrate for batching, neighborhood sampling, SpMM/SDDMM and pooling.

Format (one file per dataset; behavioral spec from the reference loader,
``U2GNN_pytorch/util.py:54-158``):

    line 0:            n_graphs
    per graph line:    "<n_nodes> <graph_label>"
    per node line:     "<tag> <degree> <nbr_1> ... <nbr_degree> [attr...]"

Semantics reproduced from the reference:

- graph labels are remapped to contiguous ints in first-encounter order
  (``util.py:75-77,127``);
- node tags are remapped through a first-encounter ``feat_dict``
  (``util.py:92-95``);
- adjacency is treated as an undirected simple graph (networkx ``Graph``
  semantics: parallel edges deduplicated) and each edge contributes both
  directions to the neighbor lists (``util.py:116-120,129-130``);
- ``degree_as_tag`` replaces tags with node degrees (COLLAB/IMDB*,
  ``util.py:136-138``);
- node features are the one-hot encoding of the tag over the dataset-wide tag
  set (``util.py:148-150``).  (The reference's continuous-attribute branch at
  ``util.py:97-98`` is dead code — the guard ``tmp > len(row)`` never fires —
  so one-hot tags are the only feature source, which we reproduce.)
- REDDIT datasets use constant 4-dim features scaled by 0.01
  (``train_pytorch_U2GNN_Sup.py:55-56,93-95``) — applied here at load time so
  downstream code is uniform.

One deliberate deviation: the dataset-wide tag set is sorted before one-hot
indexing (the reference relies on Python ``set`` iteration order,
``util.py:141-146``); this permutes one-hot columns but is deterministic.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

# Dataset root: ``data_dir`` when given, else $GT_TPU_DATA.
DEFAULT_DATA_DIRS = (os.environ.get("GT_TPU_DATA", ""),)

# Datasets where the reference forces degree-as-tag
# (train_pytorch_U2GNN_Sup.py:46-48).
DEGREE_AS_TAG_DATASETS = frozenset({"COLLAB", "IMDBBINARY", "IMDBMULTI"})


@dataclasses.dataclass
class GraphDataset:
    """Flat struct-of-arrays graph-classification dataset.

    All node ids are *global* (dataset-wide).  Graph ``g`` owns the node range
    ``[graph_offsets[g], graph_offsets[g+1])``.
    """

    name: str
    node_feat: np.ndarray  # [N, D] float32 — one-hot tag features
    nbr_offsets: np.ndarray  # [N+1] int64 — CSR row pointers (both directions)
    nbr_ids: np.ndarray  # [2E] int32 — CSR column ids (global)
    graph_offsets: np.ndarray  # [G+1] int64
    labels: np.ndarray  # [G] int32
    num_classes: int

    @property
    def num_graphs(self) -> int:
        return len(self.labels)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_directed_edges(self) -> int:
        return int(self.nbr_ids.shape[0])

    @property
    def feature_dim(self) -> int:
        return self.node_feat.shape[1]

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.nbr_offsets).astype(np.int32)

    @property
    def graph_num_nodes(self) -> np.ndarray:
        return np.diff(self.graph_offsets).astype(np.int32)

    @property
    def graph_of_node(self) -> np.ndarray:
        """[N] int32 — graph id owning each node.

        ``np.repeat`` over the per-graph node counts is correct even with
        empty graphs (the old set-1-at-offsets + cumsum trick collapsed
        duplicate offsets and miscounted — VERDICT r3 weak-item 5)."""
        return np.repeat(
            np.arange(self.num_graphs, dtype=np.int32), self.graph_num_nodes
        )

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 arrays of all directed edges (CSR expansion)."""
        deg = np.diff(self.nbr_offsets)
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), deg)
        return src, self.nbr_ids

    def max_graph_nodes(self) -> int:
        return int(self.graph_num_nodes.max())


def permute_graphs(
    ds: GraphDataset, seed: int = 0, perm: Optional[np.ndarray] = None
) -> GraphDataset:
    """Reorder the dataset's graphs by a fixed random permutation,
    renumbering all global node ids accordingly.

    **Why this exists (round-4 finding):** the TU text files list graphs
    sorted by class — the graph *index alone* predicts the label at ~100%
    on PTC/IMDBBINARY/MUTAG.  The reference's transductive unsupervised
    protocol (sampled softmax over global node ids,
    ``train_pytorch_U2GNN_UnSup.py``, ``gcn_baseline/train_unsup_gcn.py``)
    trains one output-embedding row per node, and the log-uniform candidate
    distribution P(k) = log(1+1/(k+1))/log(N+1) makes each row's update
    statistics a strong function of its numeric id — so pooled graph
    embeddings encode file position, which *is* the label.  Training on a
    graph-permuted dataset cuts that channel (position becomes independent
    of the label) while leaving the actual representation-learning problem
    identical.  See ``scripts/unsup_leak_control.py`` for measurements.
    """
    g = (np.random.default_rng(seed).permutation(ds.num_graphs)
         if perm is None else np.asarray(perm))
    sizes = ds.graph_num_nodes.astype(np.int64)
    deg = ds.degrees.astype(np.int64)
    # new-position -> old-node-id, grouped by permuted graphs
    starts = ds.graph_offsets[g]
    old_order = np.repeat(starts, sizes[g]) + _ragged_arange(sizes[g])
    new_of_old = np.empty(ds.num_nodes, dtype=np.int64)
    new_of_old[old_order] = np.arange(ds.num_nodes)
    d_new = deg[old_order]
    row_idx = np.repeat(ds.nbr_offsets[old_order], d_new) + _ragged_arange(
        d_new
    )
    return GraphDataset(
        name=ds.name + f"+perm{seed}",
        node_feat=ds.node_feat[old_order],
        nbr_offsets=np.concatenate([[0], np.cumsum(d_new)]).astype(np.int64),
        nbr_ids=new_of_old[ds.nbr_ids[row_idx]].astype(np.int32),
        graph_offsets=np.concatenate(
            [[0], np.cumsum(sizes[g])]
        ).astype(np.int64),
        labels=ds.labels[g],
        num_classes=ds.num_classes,
    )


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for the given counts."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    return np.arange(total) - np.repeat(ends - counts, counts)


def _resolve_path(dataset: str, data_dir: Optional[str]) -> str:
    candidates = [data_dir] if data_dir else [d for d in DEFAULT_DATA_DIRS if d]
    for d in candidates:
        p = os.path.join(d, dataset, dataset + ".txt")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"dataset {dataset!r} not found under {candidates}; set GT_TPU_DATA"
    )


def load_tu_dataset(
    dataset: str,
    degree_as_tag: Optional[bool] = None,
    data_dir: Optional[str] = None,
    use_node_attributes: bool = False,
) -> GraphDataset:
    """Load a TU dataset from its text file into a :class:`GraphDataset`.

    ``use_node_attributes``: load continuous per-node attributes from a
    ``<dataset>_node_attributes.txt`` sidecar (one whitespace/comma-separated
    line per node, dataset-global order) and use them AS the node features —
    the behavior the reference's dead attribute branch intended
    (``util.py:97-98,116-130``: when per-node attrs exist they replace the
    one-hot tag features).  ENZYMES/PROTEINS/NCI are tag-only in this
    checkout (the sidecar is not shipped), so this is off by default and a
    no-op-with-warning when the sidecar is absent."""
    path = _resolve_path(dataset, data_dir)
    if degree_as_tag is None:
        degree_as_tag = dataset in DEGREE_AS_TAG_DATASETS

    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(k: int) -> List[str]:
        nonlocal pos
        out = tokens[pos : pos + k]
        pos += k
        return out

    n_graphs = int(take(1)[0])
    label_dict = {}
    feat_dict = {}

    graph_offsets = np.zeros(n_graphs + 1, dtype=np.int64)
    labels = np.zeros(n_graphs, dtype=np.int32)
    all_tags: List[int] = []
    # per-graph neighbor sets, accumulated as (local_src, local_dst) pairs
    src_chunks: List[np.ndarray] = []
    dst_chunks: List[np.ndarray] = []

    for g in range(n_graphs):
        n, raw_label = int(take(1)[0]), int(take(1)[0])
        if raw_label not in label_dict:
            label_dict[raw_label] = len(label_dict)
        labels[g] = label_dict[raw_label]
        base = graph_offsets[g]
        graph_offsets[g + 1] = base + n

        edge_set = set()
        for j in range(n):
            raw_tag = int(take(1)[0])
            deg = int(take(1)[0])
            if raw_tag not in feat_dict:
                feat_dict[raw_tag] = len(feat_dict)
            all_tags.append(feat_dict[raw_tag])
            nbrs = take(deg)
            for w in nbrs:
                k = int(w)
                # undirected simple-graph semantics (networkx Graph dedup)
                e = (j, k) if j <= k else (k, j)
                edge_set.add(e)
        if edge_set:
            e = np.array(sorted(edge_set), dtype=np.int64)
            a, b = e[:, 0], e[:, 1]
            src = np.concatenate([a, b]) + base
            dst = np.concatenate([b, a]) + base
            src_chunks.append(src)
            dst_chunks.append(dst)

    num_nodes = int(graph_offsets[-1])
    if src_chunks:
        src = np.concatenate(src_chunks)
        dst = np.concatenate(dst_chunks)
    else:
        src = np.zeros(0, dtype=np.int64)
        dst = np.zeros(0, dtype=np.int64)

    # Build CSR: sort by (src, dst) so neighbor lists are ordered.
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=num_nodes)
    nbr_offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=nbr_offsets[1:])
    nbr_ids = dst.astype(np.int32)

    tags = np.asarray(all_tags, dtype=np.int64)
    if degree_as_tag:
        tags = counts.astype(np.int64)

    # Sorted dataset-wide tag set → one-hot columns (deterministic ordering).
    tagset = np.unique(tags)
    tag_index = np.searchsorted(tagset, tags)
    node_feat = np.zeros((num_nodes, len(tagset)), dtype=np.float32)
    node_feat[np.arange(num_nodes), tag_index] = 1.0

    if use_node_attributes:
        attr_path = os.path.join(
            os.path.dirname(path), dataset + "_node_attributes.txt"
        )
        if os.path.exists(attr_path):
            with open(attr_path) as f:
                rows = [
                    [float(v) for v in line.replace(",", " ").split()]
                    for line in f
                    if line.strip()
                ]
            attrs = np.asarray(rows, dtype=np.float32)
            if attrs.shape[0] != num_nodes:
                raise ValueError(
                    f"{attr_path}: {attrs.shape[0]} rows != {num_nodes} nodes"
                )
            node_feat = attrs
        else:
            import warnings

            warnings.warn(
                f"use_node_attributes: no sidecar at {attr_path}; "
                "falling back to one-hot tag features"
            )

    if "REDDIT" in dataset:
        # constant low-magnitude 4-dim features
        # (train_pytorch_U2GNN_Sup.py:55-56,93-95)
        node_feat = np.full((num_nodes, 4), 0.01, dtype=np.float32)

    return GraphDataset(
        name=dataset,
        node_feat=node_feat,
        nbr_offsets=nbr_offsets,
        nbr_ids=nbr_ids,
        graph_offsets=graph_offsets,
        labels=labels,
        num_classes=len(label_dict),
    )


def synthetic_powerlaw_dataset(
    name: str = "SYNTH",
    num_graphs: int = 128,
    num_classes: int = 5,
    mean_nodes: int = 300,
    attach_edges: int = 2,
    seed: int = 0,
    reddit_like: bool = True,
    heavy_tail: bool = False,
) -> GraphDataset:
    """Generate a REDDIT-like power-law dataset.

    The REDDIT TU files are stripped from the reference checkout
    (``dataset/.MISSING_LARGE_BLOBS``), so throughput benchmarks targeting
    REDDITMULTI5K-scale batches use Barabási–Albert-style graphs with matching
    statistics (REDDITMULTI5K: ~5k graphs, ~509 nodes and ~595 undirected edges
    per graph on average).

    ``heavy_tail=True`` models the part of real REDDIT the plain BA
    process misses: discussion threads have a root post most replies
    attach to, so the max degree is ~graph size (≫ the 128-lane width),
    not the BA ~sqrt(n·m).  Each node then attaches to the graph's root
    with probability 0.4 (else preferentially), and graph sizes get a
    lognormal tail (a few multi-thousand-node graphs), driving max degree
    past 1000 — the regime the hub-subsample sampler rows exist for.
    """
    rng = np.random.default_rng(seed)
    graph_offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    labels = rng.integers(0, num_classes, size=num_graphs).astype(np.int32)
    src_chunks, dst_chunks = [], []
    if heavy_tail:
        # lognormal with the requested mean: median ~0.6×mean, p99 ~6×mean
        sizes = np.maximum(
            3, (mean_nodes * rng.lognormal(-0.5, 1.0, num_graphs))
        ).astype(np.int64)
    else:
        sizes = np.maximum(
            3, rng.poisson(mean_nodes, size=num_graphs)
        ).astype(np.int64)
    for g in range(num_graphs):
        n = int(sizes[g])
        base = graph_offsets[g]
        graph_offsets[g + 1] = base + n
        # preferential attachment: node j attaches to `attach_edges` targets
        # drawn (approximately) proportional to degree — sample from the edge
        # endpoint list, which is degree-biased.
        endpoints = [0, 1]
        srcs, dsts = [1], [0]
        root_p = rng.random(n) if heavy_tail else None
        for j in range(2, n):
            m = min(attach_edges, j)
            if heavy_tail and root_p[j] < 0.4:
                targets = {0}  # reply-to-root: degree(root) ~ 0.4·n
            else:
                picks = rng.choice(len(endpoints), size=m)
                targets = {endpoints[p] for p in picks}
            for t in targets:
                srcs.append(j)
                dsts.append(t)
                endpoints.extend((j, t))
        a = np.asarray(srcs, dtype=np.int64)
        b = np.asarray(dsts, dtype=np.int64)
        src_chunks.append(np.concatenate([a, b]) + base)
        dst_chunks.append(np.concatenate([b, a]) + base)

    num_nodes = int(graph_offsets[-1])
    src = np.concatenate(src_chunks)
    dst = np.concatenate(dst_chunks)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=num_nodes)
    nbr_offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=nbr_offsets[1:])

    if reddit_like:
        node_feat = np.full((num_nodes, 4), 0.01, dtype=np.float32)
    else:
        # degree-bucket one-hot features
        deg = counts.astype(np.int64)
        tagset = np.unique(deg)
        idx = np.searchsorted(tagset, deg)
        node_feat = np.zeros((num_nodes, len(tagset)), dtype=np.float32)
        node_feat[np.arange(num_nodes), idx] = 1.0

    return GraphDataset(
        name=name,
        node_feat=node_feat,
        nbr_offsets=nbr_offsets,
        nbr_ids=dst.astype(np.int32),
        graph_offsets=graph_offsets,
        labels=labels,
        num_classes=num_classes,
    )
