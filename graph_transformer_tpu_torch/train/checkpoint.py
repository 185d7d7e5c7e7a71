"""Checkpoints — port of ``graph_transformer_tpu/train/checkpoint.py``.

Orbax becomes ``torch.save``.  The layout is JAX's: one directory
``<ckpt_dir>/step_%08d/`` a save (here holding ``state.pt``, the model's and
the optimizer's state) and the host-side metadata beside it in
``step_%08d.extra.json`` (epoch, loss history, ...).

A save is atomic, as Orbax's is: the state is written into a temporary
directory whose name does not start with ``step_``, the metadata into a
temporary file, and each is moved into place with ``os.replace``, the
metadata first.  A process killed mid-save leaves at most a stray temporary,
which :func:`latest_checkpoint` never picks.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"step_\d{8}")


def _jsonable(v):
    if isinstance(v, (np.ndarray, list, tuple)):
        return np.asarray(v).tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _to_cpu(tree):
    """``tree`` with every tensor copied to the host (so that the saved
    bytes are the state at the time of the call)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save one step's state (``params``: a model's state dict, or a list of
    them; ``opt_state``: an optimizer's ``state_dict()``, or a list of
    them) and the JSON-able ``extra``; returns the checkpoint path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp.step_{step:08d}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state)},
               os.path.join(tmp, STATE_FILE))
    if extra is not None:
        with open(tmp + ".extra.json", "w") as f:
            json.dump({k: _jsonable(v) for k, v in extra.items()}, f)
        os.replace(tmp + ".extra.json", path + ".extra.json")
    if os.path.isdir(path):  # the same step saved again
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path of the highest ``step_%08d`` directory in ``ckpt_dir``, or
    None; temporaries of an interrupted save are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if _STEP_DIR.fullmatch(d)
        and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE)))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


def restore_checkpoint(path: str, params_like: Any = None,
                       opt_state_like: Any = None):
    """``(params, opt_state, extra)`` of a checkpoint; the tensors load onto
    the host (``load_state_dict`` copies them to the model's and the
    optimizer's devices).  Given ``params_like``/``opt_state_like``, the
    loaded trees must have their structure and shapes."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    for name, like in (("params", params_like), ("opt_state", opt_state_like)):
        if like is not None:
            _check_like(state[name], like, name)
    extra = None
    if os.path.exists(path + ".extra.json"):
        with open(path + ".extra.json") as f:
            extra = json.load(f)
    return state["params"], state["opt_state"], extra


def _check_like(tree, like, where: str) -> None:
    if torch.is_tensor(like):
        if not torch.is_tensor(tree) or tree.shape != like.shape:
            raise ValueError(f"checkpoint {where}: shape "
                             f"{getattr(tree, 'shape', None)} against "
                             f"{tuple(like.shape)}")
    elif isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint {where}: keys differ")
        for k in like:
            _check_like(tree[k], like[k], f"{where}.{k}")
    elif isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"checkpoint {where}: length differs")
        for i, (a, b) in enumerate(zip(tree, like)):
            _check_like(a, b, f"{where}[{i}]")
