"""The launch shape of the thread-per-row forward layer that the Python side
decides: how many neighborhoods a block holds (``_build.fill_groups``), and
the rows below which the layer's FFN runs on the tensor cores, which
``_build.FWD_MMA_ROWS`` mirrors from ``csrc/common.cuh`` (the kernels'
launchers decide by it).  No card needed."""

import math
import re
from pathlib import Path

import pytest

from graph_transformer_tpu_torch.ops import _build

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


def test_gate_rows_mirror_the_kernels():
    src = (CSRC / "common.cuh").read_text()
    m = re.search(r"#define GT_FWD_MMA_ROWS (\d+)", src)
    assert m and int(m.group(1)) == _build.FWD_MMA_ROWS
    assert 'extern "C" void gt_set_fwd_mma_rows(int rows)' in src


@pytest.mark.parametrize("source,launches", [
    ("common.cuh", "gt_encoder_fwd_kernel"),     # K1, K4, K4t, K13, K15-K17
    ("encoder_layer.cu", "gt_layer_fwd_kernel"),  # K9
    ("recompute.cuh", "gt_recompute_fwd_kernel"),  # K8, K8s, K10
    ("mega_bwd.cu", "gt_mega_bwd_kernel"),       # K14
])
def test_every_forward_layer_takes_the_one_gate(source, launches):
    """Each launcher of a kernel that runs gt_fwd_layer picks the FFN's
    branch by gt_fwd_mma(N, S), so that kernels that must agree bit for bit
    take the same branch at the same rows."""
    src = (CSRC / source).read_text()
    assert launches in src
    assert re.search(r"gt_fwd_mma\(N, S\)\s*\?", src)
