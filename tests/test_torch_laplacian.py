"""The port's Laplacian means (``utils/laplacian.py``, float64 torch on the
CPU here, on the card in ``chip_smoke.py``) against the JAX package's numpy,
within relative 1e-10: the unnormalized Laplacian, the arithmetic mean, and
the Karcher geometric mean of the regularized Laplacians on the gaussian
loader's views, with its iteration count and the
spectral metrics of both means."""

import numpy as np
import pytest

from graph_transformer_tpu.data.multiplex import gaussian_multiplex
from graph_transformer_tpu.utils import laplacian as jl
from graph_transformer_tpu_torch.utils import laplacian as tl
from graph_transformer_tpu_torch.utils.metrics import (
    spectral_eval_from_laplacian,
)

TOL = 1e-10


def close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


@pytest.fixture(scope="module")
def laps():
    return gaussian_multiplex(n=60, num_clusters=3, size_x=4, seed=7).lap


def test_unnormalized_laplacian():
    a = np.random.default_rng(0).integers(0, 2, (30, 30)).astype(float)
    close(tl.unnormalized_laplacian(a), jl.unnormalized_laplacian(a))


def test_arithmetic_mean(laps):
    close(tl.arithmetic_mean_laplacian(laps),
          jl.arithmetic_mean_laplacian(laps))


@pytest.mark.parametrize("reg,max_iter", [(10.0, 100), (1.0, 100),
                                          (10.0, 2)])
def test_geometric_mean(laps, reg, max_iter):
    got, iters = tl.geometric_mean_laplacian(laps, reg=reg,
                                             max_iter=max_iter,
                                             return_iters=True)
    close(got, jl.geometric_mean_laplacian(laps, reg=reg, max_iter=max_iter))
    assert 1 <= iters <= max_iter
    np.testing.assert_allclose(got, got.T, rtol=0, atol=0)


def test_geometric_mean_of_one_layer_is_that_layer(laps):
    one = laps[:, :, :1]
    close(tl.geometric_mean_laplacian(one), one[:, :, 0] + 10.0 * np.eye(60))


def test_spectral_metrics_of_the_means(laps):
    labels = np.repeat(np.arange(3), 20)
    for a, b in ((tl.arithmetic_mean_laplacian(laps),
                  jl.arithmetic_mean_laplacian(laps)),
                 (tl.geometric_mean_laplacian(laps),
                  jl.geometric_mean_laplacian(laps))):
        assert (spectral_eval_from_laplacian(a, labels, 3)
                == spectral_eval_from_laplacian(b, labels, 3))
