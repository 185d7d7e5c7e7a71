"""Weights from the JAX package — ``params_from_jax``.

The JAX ``U2GNNSupParams`` flattened to a dict of numpy arrays keyed by its
field names (``encoders.<i>.<field>`` for each ``TransformerEncoderParams``
field, ``head_w``, ``head_b``, and ``rec.<i>.<field>`` for the fields of a
recurrence's parameters, ``ops/ut_recurrence.py``) maps one to one onto the
port's ``U2GNNSup.state_dict()``: both store matrices ``[in, out]``, so no
array is transposed (ACT's ``b_halt`` stays a 0-d array).
``model.load_state_dict(params_from_jax(tree))`` makes both packages compute
the same function.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from graph_transformer_tpu_torch.ops.attention import FIELDS
from graph_transformer_tpu_torch.ops.ut_recurrence import REC_FIELDS


def params_from_jax(tree: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's state dict from the flattened JAX parameters."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        parts = key.split(".")
        ok = (key in ("head_w", "head_b")
              or (len(parts) == 3 and parts[1].isdigit()
                  and ((parts[0] == "encoders" and parts[2] in FIELDS)
                       or (parts[0] == "rec" and parts[2] in REC_FIELDS))))
        if not ok:
            raise KeyError(f"unknown JAX parameter {key!r}")
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    if "head_w" not in out or "head_b" not in out:
        raise KeyError("head_w and head_b are required")
    return out
