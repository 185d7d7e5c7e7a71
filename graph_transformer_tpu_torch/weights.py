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
- ``MultilayerParams``: ``encoders.<i>.<field>``, ``cross_attn.<field>``,
  ``weight`` and, with a projection head, ``proj_w`` and ``proj_b``; onto
  ``MultilayerU2GNN.state_dict()``.
- ``GCNParams`` and ``GATParams``: ``gc1``, ``gc2_mu`` and ``gc2_sig``,
  each ``.w``, ``.b`` (and the GAT's ``.a``), and ``ss.weight``,
  ``ss.bias``; onto ``GCNModel.state_dict()`` or ``GATModel``'s.
- ``GCNGraphUnsupParams``: ``layers.<i>.w``, ``layers.<i>.b``,
  ``ss.weight``, ``ss.bias``; onto ``GCNGraphUnsup.state_dict()``.
- OrthoNet's list of ``{"w", "b"}`` dicts: ``<i>.w``, ``<i>.b``; onto
  ``models/orthonet.OrthoNet.mlp``'s state dict.
- ``TransformerEncoderParams`` (one encoder, e.g. from JAX's
  ``utils/torch_compat``): its fields; onto ``EncoderParams.state_dict()``.
  ``MHAParams``: ``w_in``, ``b_in``, ``w_out``, ``b_out``.

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
MULTILAYER_KEYS = ("weight",) + tuple(f"cross_attn.{f}" for f in MHA_FIELDS)
BASELINE_LAYERS = ("gc1", "gc2_mu", "gc2_sig")
BASELINE_KEYS = tuple(f"{layer}.{f}" for layer in BASELINE_LAYERS
                      for f in ("w", "b")) + UNSUP_KEYS


def tree_kind(tree: Mapping[str, np.ndarray]) -> str:
    """Which JAX parameter tree ``tree`` flattens: ``baseline`` (GCN or
    GAT), ``gcn_unsup``, ``orthonet``, ``encoder`` (or MHA), ``unsup``,
    ``sup`` or ``multilayer``."""
    if "gc1.w" in tree:
        return "baseline"
    if "layers.0.w" in tree:
        return "gcn_unsup"
    if "0.w" in tree:
        return "orthonet"
    if "w_in" in tree:
        return "encoder"
    if "ss.weight" in tree:
        return "unsup"
    if "head_w" in tree:
        return "sup"
    return "multilayer"


def _known(key: str, kind: str) -> bool:
    parts = key.split(".")
    if kind == "gcn_unsup":
        return key in UNSUP_KEYS or (
            len(parts) == 3 and parts[0] == "layers" and parts[1].isdigit()
            and parts[2] in ("w", "b"))
    if kind == "orthonet":
        return (len(parts) == 2 and parts[0].isdigit()
                and parts[1] in ("w", "b"))
    if kind == "encoder":
        return key in FIELDS
    if kind == "baseline":
        return key in UNSUP_KEYS or (
            len(parts) == 2 and parts[0] in BASELINE_LAYERS
            and parts[1] in ("w", "b", "a"))
    if kind == "sup" and key in SUP_KEYS:
        return True
    if kind == "unsup" and key in UNSUP_KEYS + ("weight",):
        return True
    if kind == "multilayer" and key in ("weight", "proj_w", "proj_b"):
        return True
    if (kind in ("unsup", "multilayer") and len(parts) == 2
            and parts[0] == "cross_attn"):
        return parts[1] in MHA_FIELDS
    return (len(parts) == 3 and parts[1].isdigit()
            and ((parts[0] == "encoders" and parts[2] in FIELDS)
                 or (kind == "sup" and parts[0] == "rec"
                     and parts[2] in REC_FIELDS)))


REQUIRED = {"sup": SUP_KEYS, "unsup": UNSUP_KEYS,
            "multilayer": MULTILAYER_KEYS, "baseline": BASELINE_KEYS,
            "gcn_unsup": ("layers.0.w", "layers.0.b") + UNSUP_KEYS,
            "orthonet": ("0.w", "0.b"), "encoder": MHA_FIELDS}


def params_from_jax(tree: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's state dict from the flattened JAX parameters, their kind
    read from the keys (:func:`tree_kind`)."""
    kind = tree_kind(tree)
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if not _known(key, kind):
            raise KeyError(f"unknown JAX parameter {key!r}")
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    required = REQUIRED[kind]
    if any(k not in out for k in required):
        raise KeyError(f"{', '.join(required)} are required")
    return out
