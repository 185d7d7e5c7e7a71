"""Universal-Transformer recurrences between weight-tied encoder timesteps —
port of ``graph_transformer_tpu/ops/ut_recurrence.py`` (the tensor2tensor
zoo the TF reference vendors, ``universal_transformer_modified_utils.py:
552-1654``), in plain torch:

- ``basic``:   state <- layer(state)
- ``skip``:    state <- layer(state) + x0
- ``highway``: a gate sigma(s Ws + o Wo + b) blends state and layer output
- ``gru``:     a GRU cell with the layer output as its input
- ``lstm``:    an LSTM cell, likewise, with a cell state
- ``dwa``:     depth-wise attention of the output over all earlier states
- ``act``:     Adaptive Computation Time: the halting-weighted average of the
               per-step outputs, and the ponder cost (steps + remainder) that
               t2t adds to the loss as ``act_loss``.

Parameters are ``nn.Module``s with the JAX dataclasses' field names and
``[in, out]`` matrices.  The transitions compute in float32, as the JAX
package's float32 parameters promote a bfloat16 state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from graph_transformer_tpu_torch.ops.attention import xavier_uniform

KINDS = ("basic", "skip", "highway", "gru", "lstm", "dwa", "act")


class HighwayParams(nn.Module):
    def __init__(self, D: int, gen: torch.Generator):
        super().__init__()
        self.w_state = nn.Parameter(xavier_uniform((D, D), gen))
        self.w_out = nn.Parameter(xavier_uniform((D, D), gen))
        self.b = nn.Parameter(torch.zeros(D))


def _packed(D, gen):
    """[2D, D]: the (state; out) halves of a gate's input."""
    return nn.Parameter(torch.cat([xavier_uniform((D, D), gen),
                         xavier_uniform((D, D), gen)]))


class GRUParams(nn.Module):
    def __init__(self, D: int, gen: torch.Generator):
        super().__init__()
        self.w_z, self.b_z = _packed(D, gen), nn.Parameter(torch.zeros(D))
        self.w_r, self.b_r = _packed(D, gen), nn.Parameter(torch.zeros(D))
        self.w_h, self.b_h = _packed(D, gen), nn.Parameter(torch.zeros(D))


class LSTMParams(nn.Module):
    def __init__(self, D: int, gen: torch.Generator):
        super().__init__()
        self.w_i, self.b_i = _packed(D, gen), nn.Parameter(torch.zeros(D))
        # forget bias 1.0 (the standard LSTM init, t2t's default)
        self.w_f, self.b_f = _packed(D, gen), nn.Parameter(torch.ones(D))
        self.w_o, self.b_o = _packed(D, gen), nn.Parameter(torch.zeros(D))
        self.w_c, self.b_c = _packed(D, gen), nn.Parameter(torch.zeros(D))


class DWAParams(nn.Module):
    def __init__(self, D: int, gen: torch.Generator):
        super().__init__()
        self.w_q = nn.Parameter(xavier_uniform((D, D), gen))
        self.w_k = nn.Parameter(xavier_uniform((D, D), gen))
        self.w_v = nn.Parameter(xavier_uniform((D, D), gen))


class ACTParams(nn.Module):
    def __init__(self, D: int, gen: torch.Generator):
        super().__init__()
        self.w_halt = nn.Parameter(xavier_uniform((1, D), gen)[0])
        # t2t initializes the halting bias to 1.0; a 0-d tensor, as in JAX
        self.b_halt = nn.Parameter(torch.tensor(1.0))


_MODULES = {"highway": HighwayParams, "gru": GRUParams, "lstm": LSTMParams,
            "dwa": DWAParams, "act": ACTParams}
# every recurrence parameter's name (the JAX dataclasses' fields)
REC_FIELDS = frozenset({
    "w_state", "w_out", "b", "w_z", "b_z", "w_r", "b_r", "w_h", "b_h",
    "w_i", "b_i", "w_f", "b_f", "w_o", "b_o", "w_c", "b_c", "w_q", "w_k",
    "w_v", "w_halt", "b_halt"})


def init_recurrence_params(kind: str, d_model: int,
                           gen: Optional[torch.Generator] = None
                           ) -> Optional[nn.Module]:
    """The parameters of one recurrence kind; None for basic and skip."""
    if kind not in KINDS:
        raise ValueError(f"unknown recurrence {kind!r}")
    if kind in ("basic", "skip"):
        return None
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return _MODULES[kind](d_model, gen)


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def highway_step(p: HighwayParams, state, out):
    state, out = _f(state), _f(out)
    gate = torch.sigmoid(state @ p.w_state + out @ p.w_out + p.b)
    return gate * out + (1.0 - gate) * state


def gru_step(p: GRUParams, state, out):
    state, out = _f(state), _f(out)
    so = torch.cat([state, out], dim=-1)
    z = torch.sigmoid(so @ p.w_z + p.b_z)
    r = torch.sigmoid(so @ p.w_r + p.b_r)
    cand = torch.tanh(torch.cat([r * state, out], dim=-1) @ p.w_h + p.b_h)
    return (1.0 - z) * state + z * cand


def lstm_step(p: LSTMParams, state, cell, out) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """One LSTM transition; returns (new state, new cell)."""
    so = torch.cat([_f(state), _f(out)], dim=-1)
    i = torch.sigmoid(so @ p.w_i + p.b_i)
    f = torch.sigmoid(so @ p.w_f + p.b_f)
    o = torch.sigmoid(so @ p.w_o + p.b_o)
    c = f * _f(cell) + i * torch.tanh(so @ p.w_c + p.b_c)
    return o * torch.tanh(c), c


def dwa_step(p: DWAParams, history, out):
    """Attention of the layer output (query) over ``history`` [t+1, B, S, D]
    (x0 and every earlier state) along depth; positions stay apart."""
    q = _f(out) @ p.w_q
    k = _f(history) @ p.w_k
    v = _f(history) @ p.w_v
    scores = torch.einsum("bsd,tbsd->tbs", q, k) / math.sqrt(q.shape[-1])
    w = torch.softmax(scores, dim=0)
    return torch.einsum("tbs,tbsd->bsd", w, v)


def act_encoder(layer_fn: Callable[[torch.Tensor, int], torch.Tensor], x,
                p: ACTParams, max_steps: int, epsilon: float = 0.01):
    """ACT over ``max_steps`` timesteps of ``layer_fn(state, t)``: returns
    (the halting-weighted average of the outputs [B, S, D] float32, the
    ponder cost: the mean of steps taken plus remainder)."""
    B, S = x.shape[:2]
    z = dict(dtype=torch.float32, device=x.device)
    halt_sum = torch.zeros(B, S, **z)
    remainder = torch.zeros(B, S, **z)
    n_updates = torch.zeros(B, S, **z)
    still = torch.ones(B, S, **z)
    weighted = torch.zeros(x.shape, **z)
    state = x
    for t in range(max_steps):
        out = layer_fn(state, t)
        h = torch.sigmoid(_f(out) @ p.w_halt + p.b_halt)  # [B, S]
        halting_now = (halt_sum + h * still > 1.0 - epsilon) | (
            t == max_steps - 1)
        rem_here = 1.0 - halt_sum
        use = torch.where(halting_now, rem_here, h) * still
        weighted = weighted + use[..., None] * _f(out)
        remainder = remainder + torch.where(halting_now, rem_here,
                                            torch.zeros_like(h)) * still
        n_updates = n_updates + still
        halt_sum = halt_sum + use
        still = still * (1.0 - halting_now.to(torch.float32))
        state = out
    return weighted, (n_updates + remainder).mean()
