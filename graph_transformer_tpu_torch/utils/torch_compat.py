"""Import torch-convention weights into the port's parameters — port of
``graph_transformer_tpu/utils/torch_compat.py``.

For the activation-parity harness against the PyTorch reference: torch's
linear layers store weights ``[out, in]`` acting by ``x @ W.T``; the port
stores ``[in, out]`` acting by ``x @ W`` (``ops/attention.py``), so every
matrix is transposed on the way in.  ``nn.MultiheadAttention`` packs q, k, v
as ``in_proj_weight [3D, D]``; the port's ``w_in`` is ``[D, 3D]``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from graph_transformer_tpu_torch.ops.attention import EncoderParams

# one nn.TransformerEncoderLayer's state keys -> EncoderParams fields, and
# whether the tensor is a matrix to transpose
LAYER_KEYS = {
    "in_proj_weight": ("w_in", True), "in_proj_bias": ("b_in", False),
    "out_proj.weight": ("w_out", True), "out_proj.bias": ("b_out", False),
    "linear1.weight": ("w_ff1", True), "linear1.bias": ("b_ff1", False),
    "linear2.weight": ("w_ff2", True), "linear2.bias": ("b_ff2", False),
    "norm1.weight": ("ln1_scale", False), "norm1.bias": ("ln1_bias", False),
    "norm2.weight": ("ln2_scale", False), "norm2.bias": ("ln2_bias", False),
}


def _tensor(v, transpose: bool) -> torch.Tensor:
    t = torch.as_tensor(v).detach().to(torch.float32)
    return t.t().contiguous() if transpose else t


def encoder_params_from_torch_layers(layers: Sequence[dict]
                                     ) -> EncoderParams:
    """:class:`EncoderParams` of ``len(layers)`` timesteps from per-layer
    dicts of tensors or arrays, each the state of one
    ``nn.TransformerEncoderLayer`` under the keys of :data:`LAYER_KEYS`
    (``in_proj_weight [3D, D]``, ``linear1.weight [F, D]``, ...), on the
    device of the first layer's tensors."""
    state = {field: torch.stack([_tensor(layer[key], tr) for layer in layers])
             for key, (field, tr) in LAYER_KEYS.items()}
    T, D, three_d = state["w_in"].shape
    if three_d != 3 * D:
        raise ValueError(f"in_proj_weight of {three_d} rows for d_model {D}")
    enc = EncoderParams(T, D, state["w_ff1"].shape[2]).to(
        state["w_in"].device)
    enc.load_state_dict(state)
    return enc


def encoder_params_from_torch_encoder(encoder) -> EncoderParams:
    """From a live ``torch.nn.TransformerEncoder``: one timestep a layer."""
    layers = []
    for layer in encoder.layers:
        sd = layer.state_dict()
        layers.append({key: sd[("self_attn." + key) if key.startswith(
            ("in_proj", "out_proj")) else key] for key in LAYER_KEYS})
    return encoder_params_from_torch_layers(layers)


def mha_params_from_torch(mha) -> Dict[str, torch.Tensor]:
    """From a live ``torch.nn.MultiheadAttention``: ``w_in`` [D, 3D],
    ``b_in``, ``w_out`` [D, D], ``b_out``, the dict that
    ``ops/attention.multihead_attention`` takes."""
    sd = mha.state_dict()
    return {field: _tensor(sd[key], tr) for key, (field, tr) in
            LAYER_KEYS.items() if key in sd}
