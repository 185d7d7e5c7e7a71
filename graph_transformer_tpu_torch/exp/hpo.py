"""Hyperparameter optimization harness — the port's own copy of
``graph_transformer_tpu/exp/hpo.py`` (numpy only; the same Halton stream,
GP, expected improvement and candidate pool, so the same objective gives
the same trials).

Capability parity with the reference's Ax/BoTorch notebooks
(``find_best_hyperparams_for_dataset.ipynb`` cells 7-9,
``node_embedding_HPO.ipynb``): an ``optimize(parameters,
evaluation_function, ...)`` call over the same parameter-space description
language Ax uses —

    {"name": "num_timesteps", "type": "range",  "bounds": [1, 6]}
    {"name": "learning_rate", "type": "range",  "bounds": [1e-5, 1e-2],
     "log_scale": True}
    {"name": "sampled_num",   "type": "choice", "values": [128, 256, 512]}
    {"name": "use_thing",     "type": "fixed",  "value": True}

The Bayesian loop is numpy: a Gaussian-process surrogate (Matérn-5/2,
marginal-likelihood-fitted lengthscale/noise) with expected-improvement
acquisition over a quasi-random + local candidate pool — the
Sobol-then-GP/EI strategy of Ax's default GenerationStrategy.  The
parameter-space language, trial log and best-arm extraction
(``experiment.fetch_data()``'s equivalent: :func:`best_arm`) follow the Ax
API's shape.  ``strategy='halton'`` keeps the quasi-random baseline.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Trial = Dict[str, Any]


def _sample_param(spec: Dict[str, Any], rng: np.random.Generator, u: float):
    """Draw one value for an Ax-style parameter spec from uniform sample u."""
    t = spec["type"]
    if t == "fixed":
        return spec["value"]
    if t == "choice":
        vals = spec["values"]
        return vals[min(int(u * len(vals)), len(vals) - 1)]
    if t == "range":
        lo, hi = spec["bounds"]
        is_int = isinstance(lo, int) and isinstance(hi, int) and not spec.get(
            "log_scale", False
        )
        if spec.get("log_scale", False):
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        return int(round(v)) if is_int else v
    raise ValueError(f"unknown parameter type {t!r}")


def _halton(index: int, base: int) -> float:
    """Low-discrepancy Halton sequence value (deterministic coverage)."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


# ----------------------------------------------------------------- GP / EI
def _encode(spec: Dict[str, Any], value) -> Optional[float]:
    """Map a parameter value to its unit-cube coordinate (None for fixed)."""
    t = spec["type"]
    if t == "fixed":
        return None
    if t == "choice":
        vals = spec["values"]
        return (vals.index(value) + 0.5) / len(vals)
    lo, hi = spec["bounds"]
    if spec.get("log_scale", False):
        return (math.log(value) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return (value - lo) / (hi - lo)


def _matern52(X: np.ndarray, Y: np.ndarray, ell: float) -> np.ndarray:
    d2 = np.maximum(
        np.sum(X * X, 1)[:, None] + np.sum(Y * Y, 1)[None, :] - 2 * X @ Y.T,
        0.0,
    )
    r = np.sqrt(d2) / ell
    s = math.sqrt(5.0) * r
    return (1.0 + s + s * s / 3.0) * np.exp(-s)


class _GP:
    """Matérn-5/2 GP on the unit cube with hyperparameters chosen by
    marginal likelihood over a small grid (n ≤ ~100 ⇒ O(n³) is trivial)."""

    _ELLS = (0.1, 0.2, 0.35, 0.6, 1.0, 2.0)
    _NOISES = (1e-6, 1e-4, 1e-2, 1e-1)

    def __init__(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.mu = float(y.mean())
        self.sd = float(y.std()) or 1.0
        z = (y - self.mu) / self.sd
        best_ll, best = -math.inf, None
        n = len(z)
        for ell in self._ELLS:
            K0 = _matern52(X, X, ell)
            for noise in self._NOISES:
                K = K0 + noise * np.eye(n)
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, z))
                ll = (
                    -0.5 * float(z @ alpha)
                    - float(np.log(np.diag(L)).sum())
                    - 0.5 * n * math.log(2 * math.pi)
                )
                if ll > best_ll:
                    best_ll, best = ll, (ell, noise, L, alpha)
        self.ell, self.noise, self._L, self._alpha = best

    def posterior(self, Xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = _matern52(Xq, self.X, self.ell)  # [q, n]
        mean = Ks @ self._alpha * self.sd + self.mu
        v = np.linalg.solve(self._L, Ks.T)  # [n, q]
        var = np.maximum(1.0 + self.noise - np.sum(v * v, 0), 1e-12)
        return mean, np.sqrt(var) * self.sd


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    # erf-based; avoids a scipy dependency
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2.0)))


def expected_improvement(
    mean: np.ndarray, std: np.ndarray, best: float, xi: float = 0.01
) -> np.ndarray:
    """EI for maximization."""
    imp = mean - best - xi
    z = imp / std
    return imp * _norm_cdf(z) + std * _norm_pdf(z)


def optimize(
    parameters: Sequence[Dict[str, Any]],
    evaluation_function: Callable[[Dict[str, Any]], float],
    total_trials: int = 20,
    objective_name: str = "objective",
    minimize: bool = False,
    seed: int = 0,
    refine_fraction: float = 0.3,
    strategy: str = "gp",
    n_init: Optional[int] = None,
    log_fn=print,
) -> Tuple[Dict[str, Any], float, List[Trial]]:
    """Run the search; returns (best_parameters, best_value, trials).

    ``strategy='gp'`` (default, the Ax-equivalent loop): ``n_init`` scrambled
    -Halton trials, then GP-EI — fit a Matérn-5/2 GP to all observations,
    maximize expected improvement over a quasi-random + incumbent-local
    candidate pool, evaluate the argmax (skipping duplicates of earlier
    arms).  ``strategy='halton'``: the quasi-random + local-refinement
    baseline.
    """
    if strategy not in ("gp", "halton"):
        raise ValueError(f"unknown strategy {strategy!r} (gp | halton)")
    rng = np.random.default_rng(seed)
    D = len(parameters)
    shifts = rng.random(D)  # Cranley–Patterson rotation
    free = [d for d, s in enumerate(parameters) if s["type"] != "fixed"]
    trials: List[Trial] = []
    best_params: Optional[Dict[str, Any]] = None
    best_us: Optional[List[float]] = None
    best_value = math.inf if minimize else -math.inf
    sign = -1.0 if minimize else 1.0
    n_explore = max(1, int(total_trials * (1.0 - refine_fraction)))
    if n_init is None:
        n_init = max(3, min(8, total_trials // 3))
    us_obs: List[List[float]] = []
    y_obs: List[float] = []
    seen: set = set()

    def halton_us(t: int) -> List[float]:
        return [
            (_halton(t + 1, _PRIMES[d % len(_PRIMES)]) + shifts[d]) % 1.0
            for d in range(D)
        ]

    def decode(us: List[float]) -> Dict[str, Any]:
        return {
            spec["name"]: _sample_param(spec, rng, us[d])
            for d, spec in enumerate(parameters)
        }

    def arm_key(params: Dict[str, Any]):
        return tuple(sorted((k, repr(v)) for k, v in params.items()))

    for t in range(total_trials):
        if strategy == "halton":
            if t < n_explore or best_params is None:
                us = halton_us(t)
            else:
                # refine: jitter the incumbent's unit-cube coordinates
                us = []
                for d, spec in enumerate(parameters):
                    if spec["type"] == "range":
                        u0 = _encode(spec, best_params[spec["name"]])
                        us.append(float(np.clip(u0 + rng.normal(0, 0.1), 0, 1)))
                    elif spec["type"] == "choice":
                        us.append(rng.random())
                    else:
                        us.append(0.0)
        elif t < n_init or len(set(y_obs)) < 2 or not free:
            us = halton_us(t)
        else:
            gp = _GP(
                np.asarray(us_obs, float)[:, free],
                sign * np.asarray(y_obs, float),
            )
            # candidate pool: global quasi-random + incumbent-local
            n_glob, n_loc = 256, 128
            pool = rng.random((n_glob + n_loc, D))
            if best_us is not None:
                pool[n_glob:] = np.clip(
                    np.asarray(best_us)[None, :]
                    + rng.normal(0, 0.1, (n_loc, D)),
                    0.0,
                    1.0,
                )
            mean, std = gp.posterior(pool[:, free])
            ei = expected_improvement(mean, std, sign * best_value)
            order = np.argsort(-ei)
            us = pool[order[0]].tolist()
            for idx in order:
                cand = pool[idx].tolist()
                if arm_key(decode(cand)) not in seen:
                    us = cand
                    break
        params = decode(us)
        value = float(evaluation_function(params))
        trials.append({"trial": t, "params": params, objective_name: value})
        us_obs.append(us)
        y_obs.append(value)
        seen.add(arm_key(params))
        better = value < best_value if minimize else value > best_value
        if better:
            best_params, best_value, best_us = params, value, us
        log_fn(
            f"trial {t:03d} | {objective_name} {value:.5f} | best {best_value:.5f} | {params}"
        )
    return best_params, best_value, trials


def best_arm(trials: List[Trial], objective_name: str = "objective",
             minimize: bool = False) -> Trial:
    """Best trial record — the ``experiment.fetch_data()`` + argmax step of
    the reference notebooks (find_best… cell 14)."""
    key = lambda tr: tr[objective_name]
    return (min if minimize else max)(trials, key=key)
