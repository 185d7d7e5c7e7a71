"""The port's multiplex loaders (``data/multiplex.py``) against the JAX
package's, and its numpy stand-ins for sklearn against sklearn 1.9.

1. ``scale``, ``pca`` and ``kneighbors_graph`` against sklearn within 1e-10
   (float64): a constant column, PCA where sklearn's ``svd_solver="auto"``
   takes its randomized SVD (held to ``svd_solver="full"``), cosine and
   euclidean kNN with ``include_self`` both ways, and a case with tied
   distances (duplicated rows): rows whose k-th place falls in a tie follow
   the port's (distance, index) rule, every other row equals sklearn's.
2. Every loader on small generated files (and the gaussian generator) against
   JAX's loader within 1e-6: features, adjacency, Laplacians, labels and
   masks.  The mfeat files have narrow views (sklearn then takes an exact
   solver in JAX's loader); the table readers see "?" columns, strings,
   ints and category labels.
3. ``NodeGraphDataset.to_multiplex`` on a small Planetoid-format file,
   against JAX's (its binary features tie cosine distances: the similarity
   view is held as the tie case above).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import sklearn
from sklearn.decomposition import PCA
from sklearn.metrics import pairwise_distances
from sklearn.neighbors import kneighbors_graph as sk_kneighbors_graph
from sklearn.preprocessing import scale as sk_scale

from graph_transformer_tpu.data import citation as jcit
from graph_transformer_tpu.data import multiplex as jmp
from graph_transformer_tpu_torch.data import citation as tcit
from graph_transformer_tpu_torch.data import multiplex as tmp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

EXACT = 1e-10
LOADER_TOL = 1e-6
FIELDS = ("x", "adj", "lap", "labels", "train_mask", "test_mask")


def close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(np.abs(b).max() if b.size else 0.0, 1.0), (
        what, err)


def same_dataset(a, b, tol=LOADER_TOL):
    assert a.name == b.name
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        close(x, y, tol, f)
    assert (a.num_nodes, a.num_views, a.num_classes, a.feature_dim) == (
        b.num_nodes, b.num_views, b.num_classes, b.feature_dim)


def test_sklearn_is_the_version_the_port_follows():
    assert sklearn.__version__.startswith("1.9")


# ---------------------------------------------------------------- sklearn
def test_scale_matches_sklearn():
    x = np.random.default_rng(0).normal(3.0, 2.0, (50, 6))
    x[:, 2] = 7.0  # a constant column: its std is taken as 1
    close(tmp.scale(x), sk_scale(x), EXACT)
    assert np.all(tmp.scale(x)[:, 2] == 0.0)


@pytest.mark.parametrize("n,d,k,solver", [(120, 10, 4, "covariance_eigh"),
                                          (60, 30, 5, "full"),
                                          (600, 80, 8, "randomized")])
def test_pca_matches_sklearn_full(n, d, k, solver):
    """The exact projection against ``svd_solver="full"``; at (600, 80)
    sklearn's ``auto`` takes its unseeded randomized SVD instead."""
    x = np.random.default_rng(1).normal(size=(n, d)) @ np.diag(
        np.linspace(3.0, 0.5, d))
    auto = PCA(n_components=k)
    auto.fit(x)
    assert auto._fit_svd_solver == solver
    ref = PCA(n_components=k, svd_solver="full").fit_transform(x)
    close(tmp.pca(x, k), ref, EXACT)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("include_self", [True, False])
def test_kneighbors_graph_matches_sklearn(metric, include_self):
    x = np.random.default_rng(2).normal(size=(70, 7))
    got = tmp.kneighbors_graph(x, 6, metric=metric,
                               include_self=include_self)
    ref = sk_kneighbors_graph(x, 6, metric=metric,
                              include_self=include_self).toarray()
    np.testing.assert_array_equal(got, ref)


def boundary_ties(x, k, metric, include_self):
    """Per row, whether the k-th and (k+1)-th smallest distances (sklearn's
    ``pairwise_distances``, the row itself left out without
    ``include_self``) are equal: a tie that straddles the k-th place."""
    d = pairwise_distances(x, metric=metric)
    if not include_self:
        np.fill_diagonal(d, np.inf)
    part = np.sort(d, axis=1)
    return part[:, k - 1] == part[:, k], d


def check_rows_against_sklearn(got, ref, x, k, metric, include_self):
    """Rows without a boundary tie equal sklearn's; rows with one keep every
    row nearer than the k-th distance and, at it, the lowest indices.
    Returns the number of rows with a boundary tie."""
    ties, d = boundary_ties(x, k, metric, include_self)
    np.testing.assert_array_equal(got[~ties], ref[~ties])
    for i in np.nonzero(ties)[0]:
        order = np.lexsort((np.arange(len(d)), d[i]))[:k]
        assert set(np.nonzero(got[i])[0]) == set(order), i
    return int(ties.sum())


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("include_self", [True, False])
def test_kneighbors_graph_with_tied_distances(metric, include_self):
    """Rows 0-2 are copies of row 3: inside the group the tied rows are
    each other's nearest, and both rankings keep all of them; a row whose
    k-th place falls among the group's copies is ranked by index, where
    sklearn keeps what its selection returns."""
    x = np.random.default_rng(3).normal(size=(40, 5))
    x[:3] = x[3]
    got = tmp.kneighbors_graph(x, 5, metric=metric,
                               include_self=include_self)
    ref = sk_kneighbors_graph(x, 5, metric=metric,
                              include_self=include_self).toarray()
    check_rows_against_sklearn(got, ref, x, 5, metric, include_self)
    np.testing.assert_array_equal(got[:4], ref[:4])
    assert got[:4, :4].sum() == (16 if include_self else 12)


@pytest.mark.parametrize("symmetrize", ["avg_binary", "none"])
def test_knn_graph_matches_jax(symmetrize):
    x = np.random.default_rng(4).normal(size=(50, 9))
    for metric, self_ in (("cosine", True), ("cosine", False),
                          ("minkowski", False)):
        np.testing.assert_array_equal(
            tmp.knn_graph(x, 4, metric, self_, symmetrize),
            jmp.knn_graph(x, 4, metric, self_, symmetrize))


def test_shape_features_matches_jax():
    x = np.random.default_rng(5).normal(size=(40, 12))
    for size_x in (5, 12, 16):
        a = tmp.shape_features(x, size_x, True, np.random.default_rng(9))
        b = jmp.shape_features(x, size_x, True, np.random.default_rng(9))
        close(a, b, EXACT, size_x)


def test_table_readers(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("b,1,2.5,?\na,3,4,x\nb,5,6.0,7\n")
    cols = tmp.read_table(str(p), ",")
    assert [c.dtype.kind for c in cols] == ["O", "i", "f", "O"]
    assert tmp.category_codes(cols[0]).tolist() == [1, 0, 1]
    assert tmp.columns_to_numpy(cols[1:3]).dtype == np.float64
    assert tmp.columns_to_numpy(cols[1:2]).dtype == np.int64
    assert tmp.columns_to_numpy(cols[1:]).dtype == object


# ---------------------------------------------------------------- loaders
def test_gaussian_matches_jax():
    same_dataset(tmp.gaussian_multiplex(n=100, num_clusters=5, size_x=8,
                                        seed=100),
                 jmp.gaussian_multiplex(n=100, num_clusters=5, size_x=8,
                                        seed=100))


def write_edges(path, rows):
    with open(path, "w") as f:
        f.write("".join(" ".join(str(v) for v in r) + "\n" for r in rows))


def test_vickers_chan_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    rows = [(layer, int(rng.integers(1, 30)), int(rng.integers(1, 30)), 1)
            for layer in (1, 2, 3) for _ in range(60)]
    rows.append((1, 29, 3, 1))
    write_edges(tmp_path / "vc.txt", rows)
    same_dataset(tmp.vickers_chan(str(tmp_path / "vc.txt"), size_x=6),
                 jmp.vickers_chan(str(tmp_path / "vc.txt"), size_x=6))


def test_leskovec_ng_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    rows = [(layer, int(rng.integers(0, 25)), int(rng.integers(0, 25)))
            for layer in (0, 1, 2, 3) for _ in range(50)]
    rows.append((2, 24, 0))
    write_edges(tmp_path / "ln.txt", rows)
    np.savetxt(tmp_path / "labels.txt", rng.integers(0, 3, 25), fmt="%d")
    args = (str(tmp_path / "ln.txt"), str(tmp_path / "labels.txt"))
    same_dataset(tmp.leskovec_ng(*args, size_x=5, seed=2),
                 jmp.leskovec_ng(*args, size_x=5, seed=2))


def test_leskovec_ng_mat_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    for i, f in enumerate(["LN_1995_1999.mat", "LN_2000_2004.mat",
                           "LN_2005_2009.mat", "LN_2010_2014.mat"]):
        scipy.io.savemat(tmp_path / f, {f"A{i + 1}": rng.integers(
            0, 3, (20, 20)).astype(float)})
    scipy.io.savemat(tmp_path / "LN_true.mat",
                     {"s_LNG": rng.integers(1, 4, (20, 1)).astype(float)})
    same_dataset(tmp.leskovec_ng_mat(str(tmp_path)),
                 jmp.leskovec_ng_mat(str(tmp_path)))


def write_votes(path, rng, n=40):
    with open(path, "w") as f:
        for _ in range(n):
            party = "republican" if rng.random() < 0.5 else "democrat"
            votes = rng.choice(["y", "n", "?"], 16)
            f.write(",".join([party, *votes]) + "\n")


def test_congress_matches_jax(tmp_path):
    write_votes(tmp_path / "votes.data", np.random.default_rng(9))
    p = str(tmp_path / "votes.data")
    same_dataset(tmp.congress_votes(p, seed=3), jmp.congress_votes(p, seed=3))


def test_mammographic_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    with open(tmp_path / "mammo.data", "w") as f:
        for _ in range(45):
            attrs = [str(int(rng.integers(1, 6))), str(int(rng.integers(
                20, 80))), str(int(rng.integers(1, 5))),
                str(int(rng.integers(1, 5))), str(int(rng.integers(1, 4)))]
            for j in (0, 3):  # "?" in two columns only
                if rng.random() < 0.15:
                    attrs[j] = "?"
            f.write(",".join(attrs + [str(int(rng.integers(0, 2)))]) + "\n")
    p = str(tmp_path / "mammo.data")
    same_dataset(tmp.mammographic(p, size_x=4), jmp.mammographic(p, size_x=4))


def test_balance_scale_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    with open(tmp_path / "balance.data", "w") as f:
        for _ in range(50):
            f.write(",".join([str(rng.choice(["L", "B", "R"]))]
                             + [str(int(rng.integers(1, 6)))
                                for _ in range(4)]) + "\n")
    p = str(tmp_path / "balance.data")
    same_dataset(tmp.balance_scale(p), jmp.balance_scale(p))


NARROW_MFEAT = {"mfeat-fac": 21, "mfeat-fou": 9, "mfeat-kar": 12,
                "mfeat-mor": 6, "mfeat-pix": 24, "mfeat-zer": 7}


def test_uci_mfeat_matches_jax(tmp_path):
    """``chip_smoke.write_mfeat_like`` with narrow views (2,000 rows each:
    the loader's labels are 10 blocks of 200): widths under size_x pad from
    the loader's generator, the rest reduce by PCA, which sklearn then
    solves exactly."""
    labels = chip_smoke.write_mfeat_like(str(tmp_path), widths=NARROW_MFEAT)
    a = tmp.uci_mfeat(str(tmp_path), num_similarity_neighbors=6)
    b = jmp.uci_mfeat(str(tmp_path), num_similarity_neighbors=6)
    same_dataset(a, b)
    np.testing.assert_array_equal(a.labels, labels)
    assert a.x.shape == (2000, 8, 6) and a.adj.shape == (2000, 2000, 6)


def test_write_mfeat_like_writes_the_published_widths(tmp_path):
    chip_smoke.write_mfeat_like(str(tmp_path), rows_per_class=2)
    for name, width in chip_smoke.MFEAT_WIDTHS.items():
        rows = np.loadtxt(tmp_path / name)
        assert rows.shape == (20, width)


def test_mat_multiview_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    n = 60
    data = np.empty((1, 3), dtype=object)
    for i, d in enumerate((15, 6, 10)):
        data[0, i] = rng.normal(size=(d, n))
    truth = np.empty((1, 1), dtype=object)
    truth[0, 0] = rng.integers(1, 4, (1, n)).astype(float)
    p = str(tmp_path / "views.mat")
    scipy.io.savemat(p, {"data": data, "truelabel": truth})
    same_dataset(tmp.mat_multiview(p, num_similarity_neighbors=5),
                 jmp.mat_multiview(p, num_similarity_neighbors=5))


def test_registry_dispatch():
    ds = tmp.load_multiplex("gaussian", n=50, num_clusters=5)
    assert ds.num_views == 4 and set(tmp.MULTIPLEX_LOADERS) == set(
        jmp.MULTIPLEX_LOADERS)
    with pytest.raises(KeyError):
        tmp.load_multiplex("nope")


@pytest.mark.parametrize("sim", [True, False])
def test_to_multiplex_on_planetoid_file_matches_jax(tmp_path, sim):
    """Binary features tie many cosine distances at the k-th place: the
    similarity view's rows without such a tie equal JAX's (sklearn's), the
    others follow the (distance, index) rule; everything else equals JAX's."""
    chip_smoke.write_planetoid_like(
        str(tmp_path), num_feats=150, class_sizes=(30, 20, 25), n_train=12,
        n_val=15, n_test=30, num_edges=140, class_words=20)
    ta = tcit.load_node_dataset("cora", data_dir=str(tmp_path))
    a = ta.to_multiplex(size_x=8, num_similarity_neighbors=4,
                        create_similarity_layer=sim)
    b = jcit.load_node_dataset("cora", data_dir=str(tmp_path)).to_multiplex(
        size_x=8, num_similarity_neighbors=4, create_similarity_layer=sim)
    assert a.name == b.name == "cora+sim" and a.num_views == (2 if sim
                                                              else 1)
    for f in ("x", "labels", "train_mask", "test_mask"):
        close(getattr(a, f), getattr(b, f), LOADER_TOL, f)
    close(a.adj[:, :, 0], b.adj[:, :, 0], 0.0, "graph view")
    close(a.lap[:, :, 0], b.lap[:, :, 0], 0.0, "graph view's Laplacian")
    if sim:
        feats = ta.graph.node_feat
        tied = check_rows_against_sklearn(a.adj[:, :, 1], b.adj[:, :, 1],
                                          feats, 4, "cosine", False)
        assert tied > 0
        close(a.lap[:, :, 1], jmp.raw_laplacian(jmp.make_symmetric(
            a.adj[:, :, 1])), 0.0, "similarity view's Laplacian")
