"""Evaluation probes of the unsupervised path — port of
``graph_transformer_tpu/train/evaluate.py``.

The reference evaluates unsupervised node embeddings by sum-pooling them to
graph level and fitting 10 logistic-regression folds
(``train_utils.py:173-198``, ``train_pytorch_U2GNN_UnSup.py:164-188``).  The
JAX package calls sklearn's ``LogisticRegression(solver="lbfgs", tol=1e-3,
max_iter=200)``; the card's machine has no sklearn, so the port minimises
sklearn's own objective itself: C = 1 times the summed cross entropy plus
``½‖W‖²``, the intercept unpenalised; the binomial loss with one weight
vector for two classes and the multinomial loss with a row a class for more,
as sklearn 1.9 chooses.  ``torch.optim.LBFGS`` (strong-Wolfe line search)
minimises it in float64 on the given device from zero weights, divided by
the number of examples as sklearn scales it, to a largest gradient entry of
1e-5 (sklearn stops at 1e-3, or after 200 iterations).  The folds are
``data/splits.py``'s, which equal sklearn's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from graph_transformer_tpu_torch.data.splits import stratified_kfold_indices

GRAD_TOL = 1e-5
MAX_ITER = 2000


def pool_node_embeddings(node_emb: np.ndarray,
                         graph_offsets: np.ndarray) -> np.ndarray:
    """Graph embeddings by sum-pooling node embeddings (the ``graph_pool``
    product of ``train_pytorch_U2GNN_UnSup.py:169``), as JAX pools them."""
    return np.add.reduceat(node_emb, graph_offsets[:-1], axis=0)


def logistic_objective(x: torch.Tensor, y: torch.Tensor, coef: torch.Tensor,
                       intercept: torch.Tensor) -> torch.Tensor:
    """sklearn's objective at C = 1, ``Σ loss + ½‖coef‖²``: the binomial
    loss for ``coef`` [1, d] (labels 0/1), else the multinomial one for
    ``coef`` [C, d] (labels 0..C-1)."""
    raw = x @ coef.T + intercept  # [n, 1] or [n, C]
    if coef.shape[0] == 1:
        raw = raw[:, 0]
        loss = torch.nn.functional.softplus(raw) - y * raw
    else:
        loss = torch.logsumexp(raw, dim=1) - raw.gather(1, y[:, None])[:, 0]
    return loss.sum() + 0.5 * (coef * coef).sum()


def fit_logistic(x: np.ndarray, y: np.ndarray, device="cpu") -> tuple:
    """(coef [1 or C, d], intercept [1 or C], classes) minimising
    :func:`logistic_objective` over ``x`` [n, d] and labels ``y`` [n]; the
    tensors are float64 on ``device``."""
    classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
    n, d = x.shape
    rows = 1 if len(classes) == 2 else len(classes)
    dev = torch.device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64), device=dev)
    yt = torch.as_tensor(y_enc.reshape(-1), device=dev)
    if rows == 1:
        yt = yt.to(torch.float64)
    coef = torch.zeros(rows, d, dtype=torch.float64, device=dev,
                       requires_grad=True)
    intercept = torch.zeros(rows, dtype=torch.float64, device=dev,
                            requires_grad=True)
    opt = torch.optim.LBFGS([coef, intercept], lr=1.0, max_iter=MAX_ITER,
                            max_eval=2 * MAX_ITER, tolerance_grad=GRAD_TOL,
                            tolerance_change=1e-15, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        f = logistic_objective(xt, yt, coef, intercept) / n
        f.backward()
        return f

    opt.step(closure)
    return coef.detach(), intercept.detach(), classes


def predict_logistic(x: np.ndarray, coef: torch.Tensor,
                     intercept: torch.Tensor, classes) -> np.ndarray:
    xt = torch.as_tensor(np.asarray(x, np.float64), device=coef.device)
    raw = xt @ coef.T + intercept
    pick = (raw[:, 0] > 0).long() if coef.shape[0] == 1 else raw.argmax(1)
    return np.asarray(classes)[pick.cpu().numpy()]


def logistic_regression_probe(x: np.ndarray, y: np.ndarray,
                              train_idx: np.ndarray, test_idx: np.ndarray,
                              device="cpu") -> float:
    """Accuracy on the test split of a logistic regression fit on the train
    split (``train_utils.py:188-191``)."""
    coef, intercept, classes = fit_logistic(x[train_idx], y[train_idx],
                                            device)
    pred = predict_logistic(x[test_idx], coef, intercept, classes)
    return float(np.mean(pred == np.asarray(y)[test_idx]))


def tenfold_logistic_accuracy(x: np.ndarray, y: np.ndarray,
                              n_splits: int = 10, seed: int = 0,
                              device="cpu") -> Tuple[float, float]:
    """(mean, std) accuracy over stratified folds — the reference's
    unsupervised evaluation metric (``train_pytorch_U2GNN_UnSup.py:171-186``)."""
    accs = [logistic_regression_probe(x, y, tr, te, device)
            for tr, te in stratified_kfold_indices(y, n_splits, seed)]
    return float(np.mean(accs)), float(np.std(accs))
