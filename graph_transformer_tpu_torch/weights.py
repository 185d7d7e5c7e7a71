"""Weights from the JAX package — ``params_from_jax``.

The JAX parameters flattened to a dict of numpy arrays keyed by their field
names map one to one onto the port's state dicts: both store matrices
``[in, out]``, so no array is transposed (ACT's ``b_halt`` stays a 0-d
array).

- ``U2GNNSupParams``: ``encoders.<i>.<field>`` for each
  ``TransformerEncoderParams`` field, ``head_w``, ``head_b``, and
  ``rec.<i>.<field>`` for the fields of a recurrence's parameters
  (``ops/ut_recurrence.py``); onto ``U2GNNSup.state_dict()``.
- ``U2GNNUnsupParams``: ``encoders.<i>.<field>``, ``ss.weight``,
  ``ss.bias`` and, for the fork's cross-attention head,
  ``cross_attn.<field>`` (``w_in``, ``b_in``, ``w_out``, ``b_out``) and
  ``weight``; onto ``U2GNNUnsup.state_dict()``.

``model.load_state_dict(params_from_jax(tree))`` makes both packages compute
the same function.  Unknown keys raise.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from graph_transformer_tpu_torch.ops.attention import FIELDS
from graph_transformer_tpu_torch.ops.ut_recurrence import REC_FIELDS

MHA_FIELDS = ("w_in", "b_in", "w_out", "b_out")
SUP_KEYS = ("head_w", "head_b")
UNSUP_KEYS = ("ss.weight", "ss.bias")


def _known(key: str, unsup: bool) -> bool:
    parts = key.split(".")
    if key in (UNSUP_KEYS + ("weight",) if unsup else SUP_KEYS):
        return True
    if unsup and len(parts) == 2 and parts[0] == "cross_attn":
        return parts[1] in MHA_FIELDS
    return (len(parts) == 3 and parts[1].isdigit()
            and ((parts[0] == "encoders" and parts[2] in FIELDS)
                 or (not unsup and parts[0] == "rec"
                     and parts[2] in REC_FIELDS)))


def params_from_jax(tree: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's state dict from the flattened JAX parameters (the unsup
    tree where it has ``ss.weight``)."""
    unsup = "ss.weight" in tree
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if not _known(key, unsup):
            raise KeyError(f"unknown JAX parameter {key!r}")
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    required = UNSUP_KEYS if unsup else SUP_KEYS
    if any(k not in out for k in required):
        raise KeyError(f"{' and '.join(required)} are required")
    return out
