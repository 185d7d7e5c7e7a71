"""OrthoNet: SpectralNet-style learned eigenmaps — port of
``graph_transformer_tpu/models/orthonet.py``.

The reference's ``U2GNN_pytorch/orthonet.py``: a pyramid MLP (hidden →
h/2 → h/3 → h/4 → K, ReLU between, ``orthonet.py:10-27``) trained full-batch
to minimize tr(YᵀLY) with Y = Z · (√m · R⁻¹), R the upper Cholesky factor of
ZᵀZ (the orthogonalization of ``orthonet.py:45-52``).  As the JAX package
does (``:81``), the optimizer is plain Adam (b1 0.9, b2 0.999, eps 1e-8;
``train/optim.ClippedAdam`` without clipping), not the reference's amsgrad;
``fit`` runs ``epochs + 1`` steps, keeps each step's loss before its update
in ``history`` and the trained net's orthogonalizer ``q``.

The products and ``torch.linalg.cholesky``/``inv`` are plain torch: JAX
computes them in XLA, outside any Pallas kernel.  Weights are ``[in, out]``;
the initial ones follow ``nn.Linear``'s rule, U(±1/sqrt(fan_in)) for the
matrix and the bias, drawn from a generator seeded ``seed``; ``fit(...,
params=...)`` starts from given weights instead (``weights.params_from_jax``
of JAX's list of ``{"w", "b"}``).  Runs on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from graph_transformer_tpu_torch.train.optim import ClippedAdam
from graph_transformer_tpu_torch.train.sup_trainer import resolve_device


def pyramid_dims(input_dim: int, hidden_dim: int, output_dim: int
                 ) -> List[int]:
    return [input_dim, hidden_dim, hidden_dim // 2, hidden_dim // 3,
            hidden_dim // 4, output_dim]


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` [in, out] in ``nn.Linear``'s initial law."""

    def __init__(self, din: int, dout: int, gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(din)

        def uniform(*shape):
            return nn.Parameter((torch.rand(shape, generator=gen) * 2.0 - 1.0)
                                * bound)

        self.w = uniform(din, dout)
        self.b = uniform(dout)


def mlp_forward(mlp: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(mlp):
        h = h @ layer.w + layer.b
        if i < len(mlp) - 1:
            h = torch.relu(h)
    return h


def orthogonalizer(z: torch.Tensor, m: float) -> torch.Tensor:
    """√m · R⁻¹ with R the upper Cholesky factor of ZᵀZ."""
    r = torch.linalg.cholesky(z.T @ z, upper=True)
    return m * torch.linalg.inv(r)


@dataclasses.dataclass
class OrthoNet:
    """Learned spectral embedding of a Laplacian (``orthonet.py:29-75``)."""

    input_dim: int
    hidden_dim: int
    output_dim: int
    epochs: int = 2000
    lr: float = 1e-3
    seed: int = 42
    device: str = "cuda"

    def init_mlp(self) -> nn.ModuleList:
        """The pyramid MLP's initial weights (on the CPU), from ``seed``."""
        dims = pyramid_dims(self.input_dim, self.hidden_dim, self.output_dim)
        gen = torch.Generator().manual_seed(int(self.seed))
        return nn.ModuleList(Dense(dims[i], dims[i + 1], gen)
                             for i in range(len(dims) - 1))

    def fit(self, x: np.ndarray, lap: np.ndarray,
            params: Optional[Mapping[str, torch.Tensor]] = None
            ) -> "OrthoNet":
        dev = resolve_device(self.device)
        self.mlp = self.init_mlp().to(dev)
        if params is not None:
            self.mlp.load_state_dict(params)
        l_mat = torch.as_tensor(np.asarray(lap), dtype=torch.float32,
                                device=dev)
        x_in = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)
        m = math.sqrt(lap.shape[0])
        opt = ClippedAdam(self.mlp.parameters(), self.lr,
                          grad_clip_norm=math.inf)
        losses = []
        for _ in range(self.epochs + 1):
            y = mlp_forward(self.mlp, x_in)
            y = y @ orthogonalizer(y, m)
            loss = torch.trace(y.T @ l_mat @ y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        self.history = torch.stack(losses).cpu().numpy()
        with torch.no_grad():
            self.q = orthogonalizer(mlp_forward(self.mlp, x_in), m)
        return self

    @torch.no_grad()
    def predict(self, x: np.ndarray, orthogonal: bool = True) -> np.ndarray:
        q = self.q
        out = mlp_forward(self.mlp, torch.as_tensor(
            np.asarray(x), dtype=torch.float32, device=q.device))
        if orthogonal:
            out = out @ q
        return out.cpu().numpy()
