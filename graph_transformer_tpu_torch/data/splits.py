"""Cross-validation splits — port of ``graph_transformer_tpu/data/splits.py``.

The reference uses ``StratifiedKFold(n_splits=10, shuffle=True,
random_state=0)`` (``U2GNN_pytorch/util.py:160-186``); its ``dataset/*/
10fold_idx/*.txt`` fixture files are unused by code.  The JAX package calls
sklearn; the port has one numpy route that reproduces sklearn's folds fold
for fold (``StratifiedKFold._make_test_folds`` of sklearn 1.9), so that the
card, which has no sklearn, trains on the folds the JAX package trains on.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def assign_test_folds(labels: np.ndarray, n_splits: int = 10,
                      seed: int = 0) -> np.ndarray:
    """[n] the test fold of each example, as sklearn assigns it: classes
    encoded in order of first appearance, each fold's share of every class
    dealt round-robin over the sorted codes, and each class's fold ids
    shuffled by one ``RandomState(seed)``, class after class."""
    y = np.asarray(labels).reshape(-1)
    rng = np.random.RandomState(seed)
    _, first, inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    y_enc = class_perm[inv.reshape(-1)]
    n_classes = len(first)
    if np.all(n_splits > np.bincount(y_enc)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    y_order = np.sort(y_enc)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        per_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(per_class)
        folds[y_enc == k] = per_class
    return folds


def stratified_kfold_indices(
    labels: np.ndarray, n_splits: int = 10, seed: int = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Return [(train_idx, test_idx)] * n_splits, stratified on labels, each
    in index order (sklearn's ``StratifiedKFold(shuffle=True)`` folds)."""
    folds = assign_test_folds(labels, n_splits, seed)
    return [(np.where(folds != f)[0], np.where(folds == f)[0])
            for f in range(n_splits)]


def separate_data_idx(
    labels: np.ndarray, fold_idx: int, n_splits: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) for one fold — API shape of ``util.py:176-186``."""
    assert 0 <= fold_idx < n_splits, f"fold_idx must be in [0, {n_splits})"
    return stratified_kfold_indices(labels, n_splits, seed)[fold_idx]
