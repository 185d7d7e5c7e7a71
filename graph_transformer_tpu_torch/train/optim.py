"""Optimizer and learning-rate schedule — port of
``graph_transformer_tpu/train/optim.py``.

:class:`ClippedAdam` applies, in optax's order and to optax's formulas
(``optim.py:41-55``): clip by global norm (``g`` when ``‖g‖ < max``, else
``g / ‖g‖ · max``; no epsilon on the norm, unlike
``torch.nn.utils.clip_grad_norm_``), then Adam (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected moments, ``-lr · m̂ / (sqrt(v̂) + eps)``), then × ``lr_scale``.
Parameters update in place.  The step count and the scale live in device
tensors beside the moments, and the bias corrections are computed from the
count on the device, so that a captured CUDA graph of a training step
(``train/step_graph.py``) replays each step with its own count and the
scale the plateau rule last wrote.  ``state_dict``/``load_state_dict`` carry
optax's state (``count`` an int, ``mu``, ``nu``, the injected ``lr_scale``)
for ``train/checkpoint.py``.  :class:`PlateauStepLR` is the reference's
plateau-gated StepLR, unchanged.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch


class ClippedAdam:
    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 grad_clip_norm: float = 0.5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr = float(learning_rate)
        self.max_norm = float(grad_clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device if self.params else torch.device("cpu")
        # the step count and the scale the update reads, on the device
        self.count_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.scale_t = torch.ones((), dtype=torch.float32, device=dev)
        self._lr_scale = 1.0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def count(self) -> int:
        """Steps taken (read from the device)."""
        return int(self.count_t)

    @count.setter
    def count(self, n: int) -> None:
        self.count_t.fill_(int(n))

    @property
    def lr_scale(self):
        """The scale as last set (a float, or a device scalar where the
        plateau rule runs on the device); setting it writes the device
        scale the update reads."""
        return self._lr_scale

    @lr_scale.setter
    def lr_scale(self, scale) -> None:
        self._lr_scale = scale
        if torch.is_tensor(scale):
            self.scale_t.copy_(scale)
        else:
            self.scale_t.fill_(float(scale))

    def bias_corrections(self) -> tuple:
        """(1 - b1^count, 1 - b2^count), float64 device scalars from the
        device count: the one formula of the eager and the captured step."""
        n = self.count_t.to(torch.float64)
        return 1.0 - self.b1 ** n, 1.0 - self.b2 ** n

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None,
             g_norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (default: the parameters' ``.grad``),
        clipped by ``g_norm`` (default: their global norm; a caller whose
        parameters are slices of larger leaves passes the whole leaves')."""
        if grads is None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
        if g_norm is None:
            g_norm = global_norm(grads)
        clip = g_norm < self.max_norm
        self.count_t.add_(1)
        c1, c2 = self.bias_corrections()
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clip, g, g / g_norm * self.max_norm)
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            u = -self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
            p.add_(u * self.scale_t)

    def state_dict(self) -> dict:
        """``count``, ``mu``, ``nu`` and ``lr_scale`` (a float, or a device
        scalar where the plateau rule runs on the device); the tensors are
        the optimizer's own, so save or copy them before the next step."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu), "lr_scale": self.lr_scale}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in, onto this optimizer's devices."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("the state holds moments of "
                             f"{len(state['mu'])} parameters, not "
                             f"{len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"])
                            + list(state["nu"])):
            dst.copy_(src)
        scale = state["lr_scale"]
        self.lr_scale = (scale.to(self.scale_t.device)
                         if torch.is_tensor(scale) else float(scale))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``grads``, in
    float32 (optax's ``global_norm``)."""
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))


def make_optimizer(params, learning_rate: float,
                   grad_clip_norm: float = 0.5) -> ClippedAdam:
    """clip-by-global-norm -> Adam(lr) -> × lr_scale (plateau decay)."""
    return ClippedAdam(params, learning_rate, grad_clip_norm)


def set_lr_scale(opt: ClippedAdam, scale: float) -> ClippedAdam:
    opt.lr_scale = float(scale)
    return opt


def plateau_lr_step(loss_history: List[float], window: int = 5) -> bool:
    """True iff ``epoch > window`` and ``loss[-1] > mean(loss[-window-1:-1])``
    (the reference's ``scheduler.step()`` trigger)."""
    if len(loss_history) <= window:
        return False
    recent = loss_history[-window - 1: -1]
    return loss_history[-1] > sum(recent) / len(recent)


class PlateauStepLR:
    """Reference LR schedule: ``lr_scale = gamma ** (plateau_steps //
    step_size)`` with one plateau step per epoch whose loss exceeds the mean
    of the previous ``window`` epochs."""

    def __init__(self, step_size: int, gamma: float = 0.1, window: int = 5):
        self.step_size = max(1, int(step_size))
        self.gamma = float(gamma)
        self.window = int(window)
        self.num_steps = 0

    @property
    def scale(self) -> float:
        return self.gamma ** (self.num_steps // self.step_size)

    def update(self, loss_history: List[float]) -> float:
        if plateau_lr_step(loss_history, self.window):
            self.num_steps += 1
        return self.scale
