"""Counter-based random bits shared by the CUDA kernels and their plain twins.

The JAX kernels draw from the TPU's on-core PRNG, whose bits cannot be
reproduced off the TPU.  The port replaces it with a stateless integer hash
keyed by (seed, stream, element index), where ``stream = 4·layer + site`` for
the four dropout sites of an encoder layer (attention probabilities,
attention output, FFN hidden, FFN output) and fixed constants for the
neighbor sampler and the head dropout.  ``ops/csrc/common.cuh`` computes the
same words in the kernels; the functions here compute them with int64
tensor ops, so a plain version reproduces a kernel's draws and dropout masks
exactly.

The mixer is Wellons' ``lowbias32`` (two xorshift-multiply rounds).  torch has
no uint32 arithmetic: words live in int64 tensors masked to 32 bits, and each
32×32-bit product splits the left factor into 16-bit halves so no int64
product overflows.

Element indices are row-major over the site's logical shape: ``[N, S, S]``
attention, ``[N, S, D]`` attention output and FFN output, ``[N, S, F]`` FFN
hidden (``[N, S]``, ``[N, D]``, ``[N, F]`` in the slot-0 last layer), and
``[N, K]`` for the sampler's draws.

The seed is a 0-d int64 tensor (:func:`device_seed`): every kernel reads it
from device memory at its start, so that a captured CUDA graph
(``train/step_graph.py``) replays each step with the seed its buffer holds
then.  A layer's seed and a stream's key are computed from it with tensor
ops, on its device.  Every function here also takes a Python int, and then
computes with ints (or makes the int into a tensor where bits are drawn):
given the tensor of an int, each draws exactly what it draws from that int.
"""

from __future__ import annotations

import struct

import torch

M32 = 0xFFFFFFFF
SITES = 4  # dropout sites per layer: attn, attn-out, FFN hidden, FFN out
SAMPLER_STREAM = 0x53414D50
HEAD_STREAM = 0x48454144
LAYER_STREAM = 0x4C415952
EPOCH_STREAM = 0x45504F43
SELECT_STREAM = 0x53454C43
FOLD_STREAM = 0x464F4C44


def _mul32(x, c: int):
    """(x · c) mod 2^32 for 0 <= x < 2^32 (int or int64 tensor)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def device_seed(seed, device=None):
    """The seed as the kernels take it: a 0-d int64 tensor, on ``device``
    where one is given (an int becomes such a tensor, filled on the device
    with no copy from the host and no wait; a tensor moves there); None
    stays None."""
    if seed is None:
        return None
    if not torch.is_tensor(seed):
        return torch.full((), int(seed), dtype=torch.int64, device=device)
    if seed.dim() != 0 or seed.dtype != torch.int64:
        raise TypeError(f"a seed is a 0-d int64 tensor, got {seed.dtype} "
                        f"of shape {tuple(seed.shape)}")
    return seed if device is None else seed.to(device)


def _seed_device(seed, device):
    """Where draws from ``seed`` land: ``device``, else the seed's."""
    if device is not None:
        return device
    return seed.device if torch.is_tensor(seed) else "cpu"


def stream_key(seed, stream: int):
    """32-bit key of one stream: a Python int of an int seed, a 0-d int64
    tensor (on the seed's device) of a tensor seed."""
    s = seed if torch.is_tensor(seed) else int(seed)
    k = mix32((s & M32) ^ 0x9E3779B9)
    return mix32((k + _mul32(int(stream) & M32, 0x632BE5AB)) & M32)


def random_bits(seed, stream: int, n: int, device=None) -> torch.Tensor:
    """[n] int64 tensor of 32-bit words for element indices 0..n-1, on
    ``device`` (default: the seed's)."""
    device = _seed_device(seed, device)
    key = stream_key(seed, stream)
    if torch.is_tensor(key):
        key = key.to(device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return mix32((mix32(idx ^ key) + key) & M32)


def keep_threshold(rate: float) -> int:
    """An element is kept iff ``bits >> 8 < keep_threshold(rate)``."""
    return int(round((1.0 - float(rate)) * (1 << 24)))


def keep_mask(seed, stream: int, shape, rate: float,
              device=None) -> torch.Tensor:
    """f32 0/1 keep mask of ``shape`` (row-major element indices)."""
    n = 1
    for s in shape:
        n *= int(s)
    bits = random_bits(seed, stream, n, device)
    return ((bits >> 8) < keep_threshold(rate)).to(torch.float32).view(*shape)


def dropout_stream(layer: int, site: int) -> int:
    return layer * SITES + site


def uniform_draws(seed, n_rows: int, k: int, deg: torch.Tensor,
                  table_width: int = 128) -> torch.Tensor:
    """[n_rows, k] int64 draws ``min(floor(u·deg), deg-1)`` with ``u`` the top
    24 bits of a word over 2^24 and ``deg`` ([n_rows] ints) clamped to
    [1, table_width] — the sampler of ``pallas_folded.py:1117-1124``."""
    bits = random_bits(seed, SAMPLER_STREAM, n_rows * k, deg.device)
    u = (bits >> 8).to(torch.float32).view(n_rows, k) * (1.0 / (1 << 24))
    d = deg.clamp(1, table_width).to(torch.float32).view(n_rows, 1)
    return torch.minimum(torch.floor(u * d), d - 1.0).to(torch.int64)


def layer_seed(seed, layer: int):
    """The seed of U2GNN layer ``layer`` within a training step: layer 0
    keeps the step's seed (so a one-layer model draws what the fused path
    draws), layer i > 0 takes a 31-bit word of stream ``LAYER_STREAM + i``
    (the JAX model splits its key per layer instead).  An int of an int, a
    0-d int64 tensor of a tensor (tensor ops on its device)."""
    if layer == 0:
        return seed if torch.is_tensor(seed) else int(seed)
    return stream_key(seed, LAYER_STREAM + layer) & 0x7FFFFFFF


def fold_seed(seed: int, i: int) -> int:
    """A 31-bit seed for part ``i`` (a rank, a row set) of a computation
    seeded ``seed``, as JAX's ``fold_in``: a word of stream
    ``FOLD_STREAM + i``."""
    return stream_key(seed, (FOLD_STREAM + int(i)) & M32) & 0x7FFFFFFF


def epoch_seed(seed: int, epoch: int) -> int:
    """The 32-bit key of epoch ``epoch`` of a run seeded ``seed``."""
    return stream_key(seed, (EPOCH_STREAM + int(epoch)) & M32)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The 31-bit seed of step ``step`` of epoch ``epoch`` of a run seeded
    ``seed``: a function of absolute indices, so a resumed run draws what
    the uninterrupted one draws with no generator state."""
    return stream_key(epoch_seed(seed, epoch), step) & 0x7FFFFFFF


def select_without_replacement(seed: int, epoch: int, counts, k: int,
                               steps: int, width: int,
                               device="cpu") -> torch.Tensor:
    """[F, steps, k] positions: for each of F sets of ``counts[f]`` items
    and each step of epoch ``epoch``, ``k`` distinct positions below
    ``counts[f]``, the ``k`` of smallest key, where position p's key at step
    i is the word ``(i, p)`` of stream ``SELECT_STREAM`` of the epoch's key
    (ties, which are rare, go to the lower position).  Every k-subset is
    equally likely; the sets share the words, as the JAX CV's folds share
    its key."""
    bits = random_bits(epoch_seed(seed, epoch), SELECT_STREAM, steps * width,
                       device).view(steps, width)
    pos = torch.arange(width, device=device)
    key = bits * width + pos  # unique, < 2**63
    counts = torch.as_tensor(counts, device=device).view(-1, 1, 1)
    key = torch.where(pos < counts, key[None], torch.iinfo(torch.int64).max)
    return torch.topk(key, k, dim=-1, largest=False).indices


def drop_args(rate: float, seed) -> tuple:
    """(seed, keep24, keep, on), the seed as given: ``on`` 0 keeps
    every value (rate 0, or a rate so small that every word is kept and
    keep rounds to 1.0 in float32), 2 marks keep = 0.5 in float32 (a word is
    then kept iff its top bit is 0, and kept values double exactly; the
    D <= 32 forward layer draws the FFN hidden's mask so), 1 any other rate
    (kept values divided by keep)."""
    if rate > 0.0 and seed is None:
        raise ValueError("dropout rate > 0 needs a seed")
    keep24 = keep_threshold(rate)
    keep = struct.unpack("<f", struct.pack("<f", 1.0 - float(rate)))[0]
    on = 0
    if rate > 0.0 and keep24 < 1 << 24:
        on = 2 if keep == 0.5 else 1
    return (seed, keep24, 1.0 - float(rate), on)


def seed_ptr(seed):
    """The address a launch function takes: ``seed``'s, a 0-d int64 tensor
    on the launch's device (:func:`device_seed`) that the caller holds until
    the launch is queued; None for None (nothing drawn)."""
    if seed is None:
        return None
    if not torch.is_tensor(seed):
        raise TypeError("a launch takes the seed as a device tensor "
                        "(ops/random.device_seed), not "
                        f"{type(seed).__name__}")
    return seed.data_ptr()


def drop_launch(rate: float, seed) -> tuple:
    """:func:`drop_args` as a launch function takes them: (the address of
    the device seed ``seed``, keep24, keep, on)."""
    _, keep24, keep, on = drop_args(rate, seed)
    return (seed_ptr(seed), keep24, keep, on)
