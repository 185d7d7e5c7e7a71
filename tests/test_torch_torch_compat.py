"""The port's ``utils/torch_compat.py`` against ``torch.nn`` and against
the JAX package's ``utils/torch_compat.py``:

1. The port's encoder (``ops/attention.transformer_encoder``, rate 0) fed
   the converted weights of an ``nn.TransformerEncoder`` (eval, ReLU,
   post-norm, batch_first=False: the encoder reads [S, B, E], the port
   [B, S, D]) equals it within 1e-5 at D = 16, ff 32, T = 2, 1 and 2
   heads, as ``tests/test_parity_torch.py:30-40`` holds JAX's; the
   converted ``nn.MultiheadAttention`` likewise through
   ``ops/attention.multihead_attention``.
2. The converted tensors equal JAX's ``encoder_params_from_torch_encoder``
   and ``mha_params_from_torch`` output carried through
   ``weights.params_from_jax``, bit for bit.
3. Per-layer dicts of numpy arrays convert alike, and a malformed
   ``in_proj_weight`` raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_transformer_tpu.utils import torch_compat as jtc
from graph_transformer_tpu_torch.ops.attention import (
    EncoderParams,
    multihead_attention,
    transformer_encoder,
)
from graph_transformer_tpu_torch.utils import torch_compat as tc
from graph_transformer_tpu_torch.weights import params_from_jax

D, FF, T = 16, 32, 2
TOL = 1e-5


def torch_encoder(nhead, seed=0):
    torch.manual_seed(seed)
    layer = torch.nn.TransformerEncoderLayer(
        d_model=D, nhead=nhead, dim_feedforward=FF, dropout=0.5)
    enc = torch.nn.TransformerEncoder(layer, T, enable_nested_tensor=False)
    return enc.eval()


@pytest.mark.parametrize("nhead", [1, 2])
def test_encoder_matches_torch(nhead):
    enc = torch_encoder(nhead, seed=nhead)
    p = tc.encoder_params_from_torch_encoder(enc)
    assert isinstance(p, EncoderParams) and p.w_in.shape == (T, D, 3 * D)
    x = torch.from_numpy(np.random.RandomState(0).randn(6, 5, D)
                         .astype(np.float32))
    with torch.no_grad():
        want = enc(x)
        got = transformer_encoder(p.stacked(), x.transpose(0, 1), nhead,
                                  rate=0.0).transpose(0, 1)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("nhead", [1, 2])
def test_mha_matches_torch(nhead):
    torch.manual_seed(1)
    mha = torch.nn.MultiheadAttention(D, num_heads=nhead).eval()
    x = torch.randn(7, 3, D)
    with torch.no_grad():
        want = mha(x, x, x, need_weights=False)[0]
        got = multihead_attention(tc.mha_params_from_torch(mha),
                                  x.transpose(0, 1), nhead).transpose(0, 1)
    assert float((got - want).abs().max()) <= TOL


def jax_tree(params):
    return {f.name: np.asarray(getattr(params, f.name))
            for f in dataclasses.fields(params)}


def test_converted_tensors_equal_jax():
    enc = torch_encoder(2, seed=3)
    got = tc.encoder_params_from_torch_encoder(enc).state_dict()
    want = params_from_jax(jax_tree(jtc.encoder_params_from_torch_encoder(
        enc)))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mha = enc.layers[0].self_attn
    got = tc.mha_params_from_torch(mha)
    want = params_from_jax(jax_tree(jtc.mha_params_from_torch(mha)))
    assert set(got) == set(want) == {"w_in", "b_in", "w_out", "b_out"}
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_layer_dicts_of_arrays_and_shape_check():
    enc = torch_encoder(1, seed=4)
    layers = []
    for layer in enc.layers:
        sd = layer.state_dict()
        layers.append({key: sd[key if key in sd else "self_attn." + key]
                       .numpy() for key in tc.LAYER_KEYS})
    a = tc.encoder_params_from_torch_layers(layers).state_dict()
    b = tc.encoder_params_from_torch_encoder(enc).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    layers[0]["in_proj_weight"] = layers[0]["in_proj_weight"][:-1]
    layers[1]["in_proj_weight"] = layers[1]["in_proj_weight"][:-1]
    with pytest.raises(ValueError, match="in_proj_weight"):
        tc.encoder_params_from_torch_layers(layers)
