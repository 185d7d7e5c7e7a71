"""Laplacians and their means over multiplex graph layers — port of
``graph_transformer_tpu/utils/laplacian.py``.

The unnormalized Laplacian (``sgwt_raw_laplacian``), the arithmetic mean
over layers, and the Riemannian (Karcher) geometric mean of regularized
Laplacians, ``mean_riemann([L_i + 10·I])`` of the fork's ``get_gm``
(``util.py:43-52``), as the fixed-point iteration

    M <- M½ exp(mean_i log(M^-½ (L_i + reg·I) M^-½)) M½

from the arithmetic mean, to a tangent norm below ``tol`` or ``max_iter``
iterations.  The JAX package computes it in numpy on the host; here it runs
in float64 torch on the device the caller gives (each iteration is S + 2
symmetric eigendecompositions, ``torch.linalg.eigh``), and returns numpy for
``utils/metrics.spectral_eval_from_laplacian``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

EIG_FLOOR = 1e-18


def unnormalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = D - A."""
    adj = np.asarray(adj, dtype=np.float64)
    return np.diag(adj.sum(axis=1)) - adj


def arithmetic_mean_laplacian(laps: np.ndarray) -> np.ndarray:
    """Mean of [N, N, S] over the layer axis."""
    return np.asarray(laps, dtype=np.float64).mean(axis=2)


def _sqrtm_spd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, vecs = torch.linalg.eigh(a)
    s = torch.sqrt(vals.clamp_min(EIG_FLOOR))
    return (vecs * s) @ vecs.T, (vecs / s) @ vecs.T


def _logm_spd(a: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(a)
    return (vecs * torch.log(vals.clamp_min(EIG_FLOOR))) @ vecs.T


def _expm_sym(a: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh((a + a.T) / 2)
    return (vecs * torch.exp(vals)) @ vecs.T


def geometric_mean_laplacian(laps, reg: float = 10.0, tol: float = 1e-8,
                             max_iter: int = 100, device="cpu",
                             return_iters: bool = False):
    """Karcher (affine-invariant Riemannian) mean of ``L_i + reg·I`` over
    the layers of ``laps`` [N, N, S], in float64 on ``device``; the
    regularized mean is returned as it is (numpy [N, N]), with the number
    of iterations where ``return_iters``."""
    dev = torch.device(device)
    mats = np.asarray(laps, dtype=np.float64).transpose(2, 0, 1)
    mats = torch.as_tensor(np.ascontiguousarray(mats), device=dev)
    n = mats.shape[1]
    mats = mats + reg * torch.eye(n, dtype=torch.float64, device=dev)
    m = mats.mean(dim=0)
    iters = 0
    for _ in range(max_iter):
        iters += 1
        s, s_inv = _sqrtm_spd(m)
        tangent = torch.stack([_logm_spd(s_inv @ a @ s_inv) for a in mats]
                              ).mean(dim=0)
        norm = float(torch.linalg.norm(tangent))
        m = s @ _expm_sym(tangent) @ s
        m = (m + m.T) / 2
        if norm < tol:
            break
    out = m.cpu().numpy()
    return (out, iters) if return_iters else out
