"""The launch shape and mask arguments of the thread-per-row forward layer
that the Python side decides: how many neighborhoods a block holds
(``_build.fill_groups``, ``pick_fwd_groups``'s whole waves), the rows a
block holds at most (``_build.FWD_ROWS``, which mirrors the kernels'
``GT_BWD_THREADS`` in ``csrc/common.cuh``), and which rate takes the
layer's half mask (``ops/random.drop_args``), with the mask's rules
emulated.  No card needed."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.ops import _build
from graph_transformer_tpu_torch.ops.attention import dropout
from graph_transformer_tpu_torch.ops.random import drop_args

CSRC = Path(_build.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("S,n,want", [
    (17, 512, 2),     # the MUTAG HPO arm's 16 graphs: 256 blocks
    (9, 512, 2),      # ACT's
    (9, 8832, 14),    # the bench's rows: 128 rows a block
    (17, 0, 7),       # no n: 128 rows a block
    (9, 200, 1),      # fewer neighborhoods than FILL_BLOCKS: one a block
    (32, 100000, 4),  # many: the row cap
])
def test_fill_groups(S, n, want):
    assert _build.fill_groups(S, 128, n) == want


@pytest.mark.parametrize("S", [5, 9, 17, 32])
def test_fill_groups_fill_the_card(S):
    """At every N the grid has N blocks, or at least half of FILL_BLOCKS,
    and a block at most 128 rows."""
    for N in range(1, 6000, 7):
        G = _build.fill_groups(S, 128, N)
        assert 1 <= G and G * S <= max(128, S)
        assert math.ceil(N / G) >= min(N, _build.FILL_BLOCKS // 2)


@pytest.mark.parametrize("S,n,want", [
    (9, 8832, 17),    # the bench's rows: 520 blocks, two waves of 264
    (17, 512, 2),     # the HPO arm's: as fill_groups, one wave
    (9, 512, 2),      # ACT's
    (9, 5462, 21),    # 49,158 rows: one wave of 261 blocks of 189 rows
    (17, 4676, 9),    # 79,492 rows at S=17: 520 blocks
    (32, 100000, 8),  # many: the row cap, 256 rows a block
])
def test_fill_groups_whole_waves(S, n, want):
    assert _build.fill_groups(S, _build.FWD_ROWS, n, whole_waves=True) == want


@pytest.mark.parametrize("S", [5, 9, 17, 32])
def test_whole_waves_are_the_fewest_and_full(S):
    """At every N: blocks of at most FWD_ROWS rows, in the fewest waves of
    FILL_BLOCKS that such blocks allow, and no wave emptier than the last
    one needs to be (one neighborhood fewer a block would take a wave
    more)."""
    cap = _build.FWD_ROWS // S
    for N in range(1, 40000, 37):
        G = _build.fill_groups(S, _build.FWD_ROWS, N, whole_waves=True)
        assert 1 <= G <= cap
        waves = math.ceil(math.ceil(N / G) / _build.FILL_BLOCKS)
        assert waves == math.ceil(N / (cap * _build.FILL_BLOCKS))
        if G > 1:
            assert math.ceil(N / (G - 1)) > waves * _build.FILL_BLOCKS


def test_gate_rows_mirror_the_kernels():
    """The forward layer has one FFN, on the tensor cores at every row
    count: no gate between two branches is left in the kernels or in
    ``_build``, and the rows a block holds at most (FWD_ROWS) are the
    threads of the layer's block (GT_BWD_THREADS), a thread per row."""
    src = (CSRC / "common.cuh").read_text()
    assert "GT_FWD_MMA_ROWS" not in src and "gt_fwd_mma" not in src
    assert not hasattr(_build, "FWD_MMA_ROWS")
    assert not hasattr(_build, "set_fwd_mma_rows")
    m = re.search(r"#define GT_BWD_THREADS (\d+)", src)
    assert m and int(m.group(1)) == _build.FWD_ROWS


@pytest.mark.parametrize("source,launches", [
    ("common.cuh", "gt_encoder_fwd_kernel"),     # K1, K4, K4t, K13, K15-K17
    ("encoder_layer.cu", "gt_layer_fwd_kernel"),  # K9
    ("recompute.cuh", "gt_recompute_fwd_kernel"),  # K8, K8s, K10
    ("mega_bwd.cu", "gt_mega_bwd_kernel"),       # K14
])
def test_every_forward_layer_takes_the_one_gate(source, launches):
    """Each launcher of a kernel that runs gt_fwd_layer launches blocks of
    GT_BWD_THREADS threads and refuses a block of more rows than that, so
    that kernels that must agree bit for bit run the one layer."""
    src = (CSRC / source).read_text()
    assert re.search(launches + r"<[^>]*><<<blocks, GT_BWD_THREADS", src)
    assert "G * S > GT_BWD_THREADS) return cudaErrorInvalidValue" in src


@pytest.mark.parametrize("rate,on", [
    (0.0, 0), (0.5, 2), (0.5 + 2.0 ** -27, 2), (0.75, 1), (0.3, 1), (0.1, 1),
    (2.0 ** -26, 0), (2.0 ** -24, 1),
])
def test_drop_args_marks_the_half_mask(rate, on):
    """``on``: 0 where every word is kept and keep rounds to 1.0 (rate 0, or
    under 2^-25), 2 where keep is 0.5 in float32 (keep24 = 2^23: a word is
    kept iff its top bit is 0, and 1 / keep = 2 is exact), else 1; keep24 <
    2^24 where ``on`` is set, so that ``bits >> 8 < keep24`` equals ``bits
    < keep24 << 8`` in 32 bits."""
    seed, keep24, keep, got = drop_args(rate, 7)
    assert got == on
    if on:
        assert keep24 < 1 << 24
    if on == 2:
        assert keep24 == 1 << 23 and np.float32(keep) == np.float32(0.5)
    if on == 0:
        assert np.float32(keep) == np.float32(1.0)
        v = torch.linspace(-2, 2, 64)
        assert torch.equal(dropout(v, rate, 7, 0, 2), v) or rate == 0.0


def _mul(x, c):
    return (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.75])
def test_shared_head_words_keep_as_the_stream(rate):
    """The kernels' hidden mask where F % 16 == 0 (common.cuh, GT_HID_HALF
    and GT_HID_DIVIDED), emulated in 64-bit numpy: the four columns 2t,
    2t+1, 2t+8, 2t+9 of a 16-column unit take the head of column 2t xor
    {0, 1, 8, 9}; at rate 0.5 a word is kept iff its tail's top bit is 0,
    at any other rate iff the whole word is below keep24 << 8; over a
    [40, 1024] hidden this keeps exactly what ``keep_mask`` keeps."""
    from graph_transformer_tpu_torch.ops import random as rnd

    seed, layer, rows, F = 99, 2, 40, 1024
    _, keep24, _, on = drop_args(rate, seed)
    key = np.uint64(rnd.stream_key(seed, rnd.dropout_stream(layer, 2)))
    q, c0, t = np.meshgrid(np.arange(rows), np.arange(0, F, 16),
                           np.arange(4), indexing="ij")
    b = (q * F + c0 + 2 * t).astype(np.uint64)
    x = b ^ key
    head = x ^ (x >> np.uint64(16))
    keep = np.zeros((rows, F), dtype=bool)
    for o in (0, 1, 8, 9):
        x = _mul(head ^ np.uint64(o), 0x7FEB352D)
        x ^= x >> np.uint64(15)
        x = _mul(x, 0x846CA68B)
        x ^= x >> np.uint64(16)
        x = (x + key) & np.uint64(0xFFFFFFFF)
        x ^= x >> np.uint64(16)
        x = _mul(x, 0x7FEB352D)
        x ^= x >> np.uint64(15)
        x = _mul(x, 0x846CA68B)
        if on == 2:
            kept = (x & np.uint64(0x80000000)) == 0
        else:
            kept = (x ^ (x >> np.uint64(16))) < np.uint64(keep24 << 8)
        keep[q, c0 + 2 * t + o] = kept
    want = rnd.keep_mask(seed, rnd.dropout_stream(layer, 2), (rows, F), rate)
    assert np.array_equal(keep, want.numpy() != 0)
