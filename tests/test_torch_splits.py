"""The port's cross-validation folds equal sklearn's
``StratifiedKFold(shuffle=True)`` fold for fold, with no sklearn in the port
(the card's machine has none)."""

import ast
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import StratifiedKFold

from graph_transformer_tpu_torch.data import splits
from graph_transformer_tpu_torch.data.splits import (
    separate_data_idx,
    stratified_kfold_indices,
)


def label_vectors():
    r = np.random.default_rng(15)
    return {
        "binary-344": r.integers(0, 2, 344),
        "unbalanced-3": np.repeat([2, 0, 1], [90, 25, 12])[r.permutation(127)],
        "strings": np.array(list("cbbacabccbaddd") * 9),
        "six-classes": r.integers(0, 6, 150),
        "ptc-like": np.r_[np.zeros(192, int), np.ones(152, int)],
    }


CASES = [(name, n, seed) for name in label_vectors() for n in (2, 5, 10)
         for seed in (0, 3, 123)]


@pytest.mark.filterwarnings("ignore:The least populated class")
@pytest.mark.parametrize("name,n_splits,seed", CASES)
def test_folds_equal_sklearn(name, n_splits, seed):
    y = label_vectors()[name]
    want = StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(
        np.zeros(len(y)), y)
    got = stratified_kfold_indices(y, n_splits, seed)
    assert len(got) == n_splits
    for (tr, te), (tr_s, te_s) in zip(got, want):
        np.testing.assert_array_equal(te, te_s)
        np.testing.assert_array_equal(tr, tr_s)
    tr, te = separate_data_idx(y, n_splits - 1, n_splits, seed)
    np.testing.assert_array_equal(te, got[-1][1])


def test_splits_import_no_sklearn():
    tree = ast.parse(Path(splits.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "sklearn" not in names
