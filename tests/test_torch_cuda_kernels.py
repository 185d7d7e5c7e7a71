"""The port's CUDA kernels on the card (marker ``cuda``; skipped without an
NVIDIA GPU: the kernels have no CPU mode, and their plain versions are what
the other tests exercise here).  On the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

This file imports no JAX, so it runs where JAX is not installed."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the card's checks and the node step's shapes)

pytestmark = pytest.mark.cuda
# the fused path's gate (use_folded or use_stored_bwd pick among its kernels)
FUSED_FLAGS = dict(use_fused_sampler=True, use_pallas=True,
                   use_pallas_whole_encoder=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


@pytest.mark.parametrize("D,C,stored", [(4, 1, 4), (7, 7, 1)])
def test_kernels_match_plain_versions(cuda, D, C, stored):
    """K1-K4 against their plain versions at rate 0 and 0.5 (2e-2, equal
    draws, gradient cosine > 0.999), with a ragged last block."""
    import chip_smoke

    si, params, x2d = chip_smoke.random_case(
        N=301, S=9, D=D, C=C, F=256, Tn=3, stored=stored, seed=1, dev=cuda)
    chip_smoke.check_kernels(f"D{D}", si, params, x2d, 9, 3, cuda)


def test_eval_kernel_float32_at_ptc_width(cuda):
    """K4 with float32 rows at D=19, where only the order of the sums
    differs from the plain version (1e-4)."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=50, S=9, D=19, C=19, F=256, Tn=3, stored=1, seed=2, dev=cuda)
    chip_smoke.check_k4_f32("D19", params, x2d, 9, 3)


def test_train_steps_launch_every_kernel(cuda):
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=40,
                                    seed=0)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=ModelConfig(num_timesteps=3, ff_hidden_size=64, use_folded=True,
                          **FUSED_FLAGS),
        train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    for fn in (se.sampled_forward, se.layer_backward, se.slot0_backward,
               u2gnn_encoder):
        fn.launches = 0
    losses = tr.train_steps(tr.builder.sample(), 4)
    acc = tr.evaluate()
    assert bool(torch.isfinite(losses).all()) and 0.0 <= acc <= 1.0
    assert (se.sampled_forward.launches, se.layer_backward.launches,
            se.slot0_backward.launches) == (4, 8, 4)
    assert u2gnn_encoder.launches == 1


def test_cuda_tensor_never_takes_the_plain_version(cuda):
    """Past the widest kernel a CUDA tensor raises; it never falls back to
    the plain version."""
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder

    x = torch.zeros(9 * 4, 129, device=cuda)
    params = [torch.zeros(1, 129, 129, device=cuda)] * 12
    with pytest.raises(NotImplementedError):
        u2gnn_encoder(x, params, 9, 1)


@pytest.mark.parametrize("S,D,one_hot", [(9, 65, True), (9, 128, False),
                                         (17, 19, False)])
def test_wide_kernels_match_plain_versions(cuda, S, D, one_hot):
    """K5 and K6 against their plain versions at rate 0 and 0.5 (equal
    draws, forward 2e-2, every gradient leaf at cosine > 0.999), with a
    ragged last block."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=3, stored=3, seed=1, dev=cuda,
        one_hot=one_hot)
    chip_smoke.check_stored(f"S{S}D{D}", si, params, S, 3, cuda)


def test_stored_path_matches_folded_path(cuda):
    """K5/K6 and K1/K2/K3 compute one function at D=7."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=200, S=9, D=7, C=7, F=256, Tn=3, stored=1, seed=2, dev=cuda)
    chip_smoke.check_paths("D7", si, params, 9, 3, cuda)


@pytest.mark.parametrize("D", [65, 128])
def test_wide_eval_kernel_float32(cuda, D):
    """The wide K4 with float32 rows against its plain version (1e-4)."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=50, S=9, D=D, C=D, F=256, Tn=3, stored=1, seed=3, dev=cuda)
    chip_smoke.check_k4_f32(f"D{D}", params, x2d, 9, 3)


def test_train_steps_launch_the_wide_kernels(cuda):
    """With ``use_stored_bwd``, one-hot degree features past D=32 train
    through K5/K6 and evaluate through the wide K4; K1-K4 stay idle."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    import chip_smoke

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=200,
                                    seed=0, reddit_like=False)
    assert 32 < ds.feature_dim <= 128
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=ModelConfig(num_timesteps=3, ff_hidden_size=64,
                          use_stored_bwd=True, **FUSED_FLAGS),
        train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    counters = chip_smoke.launch_counters()
    for c in counters.values():
        c.launches = 0
    losses = tr.train_steps(tr.builder.sample(), 4)
    acc = tr.evaluate()
    assert bool(torch.isfinite(losses).all()) and 0.0 <= acc <= 1.0
    got = {k: c.launches for k, c in counters.items()}
    assert (got["K5"], got["K6"], got["K6s"]) == (4, 8, 4)
    assert got["K4w"] == 1
    assert got["K1"] == got["K2"] == got["K3"] == got["K4"] == 0


def test_sampler_kernel_matches_plain_version(cuda):
    """K7 against its plain version on a heavy-tailed graph (hubs past
    128): equal ids, true neighbors, hub rows drawn from their subsample."""
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    import chip_smoke

    ds = synthetic_powerlaw_dataset("heavy-tail", num_graphs=8,
                                    mean_nodes=300, seed=1, reddit_like=False,
                                    heavy_tail=True)
    for K in (16, 8):
        chip_smoke.check_sampler(f"K{K}", ds, K, 31, cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D,Tn", [(17, 7, 5), (9, 18, 4), (32, 32, 2)])
def test_two_pass_kernels_match_plain_versions(cuda, S, D, Tn, dtype):
    """K4t, K8 and K8s against their plain versions at rate 0 and 0.5, in
    float32 and bf16 (forward 1e-4 or twice the plain version's float32
    error of float64 / the bf16 spread rule; every gradient leaf at cosine
    > 0.999), with a ragged last block."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=Tn, stored=Tn, seed=1, dev=cuda)
    chip_smoke.check_two_pass(f"S{S}D{D}", params,
                              x2d.to(getattr(torch, dtype)), S, Tn, cuda)


def test_two_pass_matches_fused_path(cuda):
    """At one U2GNN layer on a codebook dataset, K7 + gather + K4t + K8/K8s
    and K1-K3 draw the same neighbors and compute one function."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=200, S=9, D=7, C=7, F=256, Tn=3, stored=1, seed=2, dev=cuda)
    chip_smoke.check_two_pass_vs_fused("D7", si, params, 9, 3, cuda)


def test_train_steps_launch_the_two_pass_kernels(cuda):
    """Two U2GNN layers train through K7, K4t, K8s and K8 (per step: one
    sample, per U2GNN layer one K4t, one K8s and T-1 K8) and evaluate
    through K4 per layer; the fused kernels stay idle."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    import chip_smoke

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=40,
                                    seed=0, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=ModelConfig(num_timesteps=3, ff_hidden_size=64,
                          num_hidden_layers=2),
        train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    counters = chip_smoke.launch_counters()
    for c in counters.values():
        c.launches = 0
    losses = tr.train_steps(tr.builder.sample(), 4)
    acc = tr.evaluate()
    assert bool(torch.isfinite(losses).all()) and 0.0 <= acc <= 1.0
    got = {k: c.launches for k, c in counters.items()}
    assert (got["K7"], got["K4t"], got["K8s"], got["K8"]) == (4, 8, 8, 16)
    assert got["K4"] == 2
    assert all(got[k] == 0 for k in chip_smoke.FUSED_KERNELS)


@pytest.mark.parametrize("case", ["hpo-arm", "quickstart", "bf16-d7",
                                  "heavy"])
def test_sampling_stage_matches_plain_version(cuda, tmp_path, case):
    """K7's sampling stage (draws, feature rows and batch slots in one
    launch) against its plain version bit for bit, on three batches each:
    the HPO arm's (16 MUTAG-like graphs, degree tags, K=16, D=6 float32),
    the quickstart's (4 IMDBBINARY-like graphs, K=8, D=68 float32), bf16
    rows of D=7 on MUTAG-like graphs, and the heavy-tailed graph (hubs past
    128) at DD's width (D=89 float32)."""
    from graph_transformer_tpu_torch.data.batching import BatchBuilder
    from graph_transformer_tpu_torch.data.tu import (
        load_tu_dataset, synthetic_powerlaw_dataset)
    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        build_neighbor_table)
    import chip_smoke

    data = str(tmp_path)
    if case == "heavy":
        ds = synthetic_powerlaw_dataset("heavy-tail", num_graphs=8,
                                        mean_nodes=300, seed=1,
                                        reddit_like=False, heavy_tail=True)
        B, K, D, dt = 4, 8, 89, torch.float32
    elif case == "quickstart":
        chip_smoke.write_imdb_like_tu(data)
        ds = load_tu_dataset("IMDBBINARY", data_dir=data)
        B, K, D, dt = 4, 8, 68, torch.float32
    else:
        chip_smoke.write_mutag_like_tu(data)
        ds = load_tu_dataset("MUTAG", data_dir=data, degree_as_tag=True)
        B, K, D, dt = ((16, 16, 6, torch.float32) if case == "hpo-arm"
                       else (16, 8, 7, torch.bfloat16))
    table = torch.from_numpy(build_neighbor_table(ds, hub_seed=0)).to(cuda)
    deg = torch.from_numpy(ds.degrees.astype(np.int32)).to(cuda)
    if D == ds.feature_dim:
        x_global = torch.from_numpy(np.ascontiguousarray(
            ds.node_feat, np.float32)).to(cuda, dt)
    else:
        x_global = torch.randn(ds.num_nodes, D, device=cuda).to(dt)
    builder = BatchBuilder(ds, B, K, seed=0)
    for seed in (1, 2, 3):
        chip_smoke.check_neighborhoods(f"{case} seed {seed}", table, deg,
                                       x_global, builder.sample().to(cuda),
                                       K, seed)


def test_two_pass_step_launches_k7_once(cuda, monkeypatch):
    """A two-pass step at two U2GNN layers launches K7 once, as
    ``sample_neighborhoods`` (``sample_neighbors`` stays idle), and
    re-gathers by K7's slots, never through ``global_regather``."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.models import u2gnn_sup
    from graph_transformer_tpu_torch.sampling import neighbor_table as nt
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    def refuse(*args, **kwargs):
        raise AssertionError("global_regather on the trainer's path")

    monkeypatch.setattr(u2gnn_sup, "global_regather", refuse)
    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=40,
                                    seed=0, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=ModelConfig(num_timesteps=3, ff_hidden_size=64,
                          num_hidden_layers=2),
        train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    before = (nt.sample_neighborhoods.launches, nt.sample_neighbors.launches)
    losses = tr.train_steps(tr.builder.sample(), 3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all())
    assert (nt.sample_neighborhoods.launches - before[0],
            nt.sample_neighbors.launches - before[1]) == (3, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(9, 7), (17, 19), (32, 32)])
def test_encoder_layer_kernels_match_plain_versions(cuda, S, D, dtype):
    """K9 and K10 against their plain versions at rate 0 and 0.5, in
    float32 and bf16 (forward 1e-4 or the float64 rule / the bf16 spread
    rule; dx and every gradient leaf at cosine > 0.999), with a ragged last
    block."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=1, stored=1, seed=1, dev=cuda)
    chip_smoke.check_encoder_layer(f"S{S}D{D}", params,
                                   x2d.to(getattr(torch, dtype)), S, cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [4, 68, 128])
def test_ffn_kernels_match_plain_versions(cuda, D, dtype):
    """K11 and K12 against their plain versions over 1,000 rows (a ragged
    last block) at rate 0 and 0.5, every gradient leaf on its own."""
    import chip_smoke

    chip_smoke.check_ffn(f"D{D}", 1000, D, 256, getattr(torch, dtype), cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 65, 68, 128])
@pytest.mark.parametrize("F", [100, 1024])
def test_ffn_kernels_at_tile_edges(cuda, F, D, dtype):
    """K11 and K12 (tensor-core row products, FF_FC = 128 hidden columns a
    chunk) against their plain versions over 1,000 rows (not a multiple of
    the block's 32) at an FFN width within one chunk or past it, a ragged
    last chunk at F = 100, at rate 0 and 0.5 (chip_smoke.check_ffn)."""
    import chip_smoke

    chip_smoke.check_ffn(f"D{D} F{F}", 1000, D, F, getattr(torch, dtype),
                         cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,M1,N1", [(1000, 68, 1024), (999, 1024, 68),
                                        (333, 37, 100), (70, 130, 3)])
def test_weight_product_matches_float64(cuda, rows, M1, N1, dtype):
    """The split-K weight products alone (``wd_wgrad``: bf16 mma.sync for
    bf16 operands, 3xTF32 for float32 ones) against the float64 product of
    the same values: rows not a multiple of a split's, M1 and N1 not
    multiples of the 64 x 64 tile.  Each entry within 1e-4 of sum |a||b|,
    above float32 accumulation's worst case over 1,000 rows (~6e-5; bf16
    products of bf16 values are exact, 3xTF32 keeps ~22 bits a product) and
    far below a lost or misplaced tile; runs repeat bit for bit."""
    from graph_transformer_tpu_torch.ops import ffn

    gen = torch.Generator(device=cuda).manual_seed(rows + M1)
    dt = getattr(torch, dtype)
    a = torch.randn(rows, M1, device=cuda, generator=gen).to(dt)
    b = torch.randn(rows, N1, device=cuda, generator=gen).to(dt)
    launches = ffn.weight_product.launches
    got = ffn.weight_product(a, b)
    again = ffn.weight_product(a, b)
    torch.cuda.synchronize()
    assert ffn.weight_product.launches == launches + 2
    want = a.double().T @ b.double()
    scale = a.double().abs().T @ b.double().abs()
    assert got.shape == (M1, N1) and torch.equal(got, again)
    assert bool(((got.double() - want).abs() <= 1e-4 * scale).all())


# K18's launches in the slot-0 layer at Cora's shape (the node step's,
# chip_smoke.node_k18_table: N = 2,816 neighborhoods, S = 5, D = 1,433, F =
# 1,024), and dx (nt, add_every = S), which runs where the input's cotangent
# is needed: (name, layout, M, N, K, epilogue); the weight products (tn)
# with their column sums
K18_NODE = [(name, key[0], *key[2:5], epilogue) for name, epilogue, key
            in chip_smoke.node_k18_table(2816, 5, 1433, 1024)] + [
    ("dx nt", "nt", 14080, 1433, 4299, "add_every")]


def k18_case(cuda, layout, M, N, K, epilogue, dtype, seed):
    """Operands of a K18 product (rows randn, weights 0.3 / sqrt(K / 6), as
    the layer's) and the keyword arguments of ``epilogue``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, device=cuda, generator=gen) * sc).to(dt)

    w = 0.3 / (K / 6.0) ** 0.5
    a = rnd(K, M) if layout == "tn" else rnd(M, K)
    b = rnd(N, K, sc=w) if layout == "nt" else rnd(K, N, sc=w)
    f32 = dict(device=cuda, generator=gen)
    kw = {"bias": dict(bias=torch.randn(N, **f32)),
          "relu_drop": dict(bias=torch.randn(N, **f32), relu=True,
                            drop=(0.5, 17, 0, 2)),
          "gate": dict(gate=torch.randn(M, N, **f32), gate_keep=0.5),
          "add": dict(add=torch.randn(M, N, **f32)),
          "add_every": dict(add=torch.randn((M + 4) // 5, N, **f32),
                            add_every=5),
          None: {}}[epilogue]
    return a, b, kw


def check_k18(cuda, label, layout, M, N, K, epilogue, dtype, seed):
    """K18 (``gemm``) against ``gemm_plain`` on the same operands, by
    :func:`check_k18_out`."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    a, b, kw = k18_case(cuda, layout, M, N, K, epilogue, dtype, seed)
    bf = dtype == "bfloat16"
    launches = re.K18.launches
    got = re.gemm(a, b, layout, bf16=bf, **kw)
    want = re.gemm_plain(a, b, layout, bf16=bf, **kw)
    torch.cuda.synchronize()
    assert re.K18.launches == launches + 1
    assert got.shape == (M, N)
    check_k18_out(label, got, want, bf)


def check_k18_out(label, got, want, bf):
    """K18's products against their plain version: float32 by
    ``check_rows_forward``'s rule, bf16 by ``check_k18_bf16_products``."""
    if bf:
        chip_smoke.check_k18_bf16_products(label, got, want)
    else:
        chip_smoke.check_rows_forward(label, got, want, bf)


def check_k18_weight(cuda, M, N, K, dtype, seed):
    """K18's weight product (``weight_grad``: tn, split over the rows, then
    the column sums) against float64, by the rule of
    :func:`test_weight_product_matches_float64`, and in float32 also
    within relative L2 1e-5 (``check_rows_forward``'s rule, which one TF32
    pass misses); runs repeat bit for bit."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    a, b, _ = k18_case(cuda, "tn", M, N, K, None, dtype, seed)
    got, col = re.weight_grad(a, b, bf16=dtype == "bfloat16")
    again, col2 = re.weight_grad(a, b, bf16=dtype == "bfloat16")
    torch.cuda.synchronize()
    want = a.double().T @ b.double()
    scale = a.double().abs().T @ b.double().abs()
    assert got.shape == (M, N) and torch.equal(got, again)
    assert torch.equal(col, col2)
    assert bool(((got.double() - want).abs() <= 1e-4 * scale).all())
    if dtype == "float32":
        assert float((got.double() - want).norm()) <= 1e-5 * float(
            want.norm())
    cw = b.double().sum(0)
    assert bool(((col.double() - cw).abs()
                 <= 1e-5 * b.double().abs().sum(0)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K18_NODE, ids=[c[0] for c in K18_NODE])
def test_k18_at_the_node_step(cuda, case, dtype):
    """K18 at each launch of the slot-0 layer at Cora's shape, with the
    launch's epilogue, against its plain version (products) or float64
    (weight products)."""
    name, layout, M, N, K, epilogue = case
    if layout == "tn":
        check_k18_weight(cuda, M, N, K, dtype, M + N + K)
    else:
        check_k18(cuda, f"K18 {name}", layout, M, N, K, epilogue, dtype,
                  M + N + K)


# the node step's launches whose A is x (bf16 in the bf16 step)
K18_X_ROWS = ("q nn", "kv nn", "dW_in q tn", "dW_in kv tn")


@pytest.mark.parametrize("case", K18_NODE, ids=[c[0] for c in K18_NODE])
def test_k18_bf16_products_of_the_bf16_step(cuda, case):
    """K18's bf16 products with the bf16 node step's operand types (x in
    bf16, the weights and K18's own outputs float32) at each launch of the
    slot-0 layer at Cora's shape: products against ``gemm_plain`` by
    ``check_k18_bf16_products`` (``check_bf16_spread`` and relative L2
    1e-4); weight products (with their column sums) against
    float64 of the bf16-rounded operands, each entry within 1e-4 of sum
    |a||b|, runs repeating bit for bit."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    name, layout, M, N, K, epilogue = case
    a, b, kw = k18_case(cuda, layout, M, N, K, epilogue, "float32",
                        M + N + K)
    if name in K18_X_ROWS:
        a = a.to(torch.bfloat16)
    launches = re.K18.launches
    if layout == "tn":
        got, col = re.weight_grad(a, b, bf16=True)
        again, col2 = re.weight_grad(a, b, bf16=True)
        torch.cuda.synchronize()
        assert re.K18.launches == launches + 2
        ab, bb = (t.to(torch.bfloat16).double() for t in (a, b))
        want, scale = ab.T @ bb, ab.abs().T @ bb.abs()
        assert torch.equal(got, again) and torch.equal(col, col2)
        assert bool(((got.double() - want).abs() <= 1e-4 * scale).all())
        assert bool(((col.double() - b.double().sum(0)).abs()
                     <= 1e-5 * b.double().abs().sum(0)).all())
        return
    got = re.gemm(a, b, layout, bf16=True, **kw)
    want = re.gemm_plain(a, b, layout, bf16=True, **kw)
    torch.cuda.synchronize()
    assert re.K18.launches == launches + 1
    chip_smoke.check_k18_bf16_products(f"K18 bf16 step {name}", got, want)


@pytest.mark.parametrize("case", K18_NODE, ids=[c[0] for c in K18_NODE])
def test_k18_float32_products_repeat(cuda, case):
    """K18's float32 products (3xTF32, untouched by the bf16 kernel) at each
    launch of the slot-0 layer at Cora's shape: two runs on the same
    operands equal bit for bit (the A/B script holds them to a parent
    checkout's bit for bit)."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    name, layout, M, N, K, epilogue = case
    a, b, kw = k18_case(cuda, layout, M, N, K, epilogue, "float32",
                        2 * M + N + K)
    if layout == "tn":
        runs = [re.weight_grad(a, b) for _ in range(2)]
    else:
        runs = [(re.gemm(a, b, layout, **kw),) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert all(bool(torch.isfinite(x).all()) for x in runs[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["bias", "relu_drop", "gate", "add",
                                      "add_every"])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
@pytest.mark.parametrize("M,N,K", [(1001, 517, 333), (77, 130, 1433),
                                   (129, 3, 40), (1, 1, 1)])
def test_k18_ragged_every_epilogue(cuda, M, N, K, layout, epilogue, dtype):
    """K18 on shapes that no tile divides (M, N not multiples of 128, K of
    32), each layout with each epilogue, against its plain version."""
    check_k18(cuda, f"K18 {layout} {M}x{N}x{K} {epilogue}", layout, M, N, K,
              epilogue, dtype, 7 * M + N + K)
    if epilogue == "bias":
        check_k18_weight(cuda, M, N, K, dtype, M + 3 * N + K)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k18_slot0_views_at_cora_shape(cuda, dtype):
    """The slot-0 layer's Q/K/V and dW_in at Cora's shape through views: q
    from x's every S-th row into the QKV buffer's first D columns, k and v
    into the rest; dW_in's q columns from slot 0's rows of x and dq.  Kernel
    against plain on what the layer forms and reads."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    S, D = 5, 1433
    x, w, kw = k18_case(cuda, "nn", 2816 * S, 3 * D, D, "bias", dtype, 3)
    bf = dtype == "bfloat16"
    launches = re.K18.launches
    qkv = re._qkv_rows(x, w, kw["bias"], S, bf, True)
    assert re.K18.launches == launches + 2
    with chip_smoke.plain_pieces():
        qkv_p = re._qkv_rows(x, w, kw["bias"], S, bf, True)
    torch.cuda.synchronize()
    check_k18_out("K18 slot-0 q, k, v", chip_smoke.slot0_qkv(qkv, S),
                  chip_smoke.slot0_qkv(qkv_p, S), bf)
    gen = torch.Generator(device=cuda).manual_seed(4)
    dqkv = torch.randn(2816 * S, 3 * D, device=cuda, generator=gen)
    dqkv.view(2816, S, 3 * D)[:, 1:, :D] = 0.0
    dqkv = dqkv.to(x.dtype).float()  # values the bf16 products keep
    dw, db = re._w_in_grad(x, dqkv, S, bf, True)
    full = x.double().T @ dqkv.double()
    scale = x.double().abs().T @ dqkv.double().abs()
    assert bool(((dw.double() - full).abs() <= 1e-4 * scale).all())
    if not bf:
        assert float((dw.double() - full).norm()) <= 1e-5 * float(
            full.norm())
    assert bool(((db.double() - dqkv.double().sum(0)).abs()
                 <= 1e-5 * dqkv.double().abs().sum(0)).all())


# K19's and K20's backward held directly against their plain versions: 133
# neighborhoods and 1,001 rows are multiples of no block, stage or group
# count the kernels use
ROWS_BWD_N, ROWS_BWD_R = 133, 1001


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("D", [160, 1433])
@pytest.mark.parametrize("slot0", [True, False])
@pytest.mark.parametrize("S", [1, 5, 17, 32])
def test_rows_k19_backward_matches_plain(cuda, S, slot0, D, rate, bf16):
    """K19's backward (``dqkv``) against ``attention_backward_plain`` at S up
    to 32 (past one block's shared memory at D = 1,433: rows staged in
    column chunks), the slot-0 layer (q NaN off slot 0, as the layer leaves
    it unwritten; dq exactly 0 there) and the full one: float32 by
    ``check_rows_forward``'s rule, bf16 products by ``check_bf16_spread``;
    two launches equal bit for bit."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    N = ROWS_BWD_N
    gen = torch.Generator(device=cuda).manual_seed(S * D + slot0)
    qkv = torch.randn(N * S, 3 * D, device=cuda, generator=gen)
    dctx = torch.randn(N if slot0 else N * S, D, device=cuda, generator=gen)
    if slot0:
        qkv.view(N, S, 3 * D)[:, 1:, :D] = float("nan")
    kw = dict(slot0=slot0, rate=rate, seed=77, layer=1, bf16=bf16)
    launches = re.K19.launches
    got = re.attention_backward(qkv, dctx, S, **kw)
    again = re.attention_backward(qkv, dctx, S, **kw)
    want = re.attention_backward_plain(qkv, dctx, S, **kw)
    torch.cuda.synchronize()
    assert re.K19.launches == launches + 2
    assert torch.equal(got, again)
    if slot0:
        assert bool((got.view(N, S, 3 * D)[:, 1:, :D] == 0).all())
    chip_smoke.check_rows_forward(
        f"K19 backward S={S} D={D} {'slot0' if slot0 else 'full'} rate "
        f"{rate} bf16 {bf16}", got, want, bf16)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("every", [1, 5])
@pytest.mark.parametrize("res_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,R", [(160, ROWS_BWD_R), (1433, ROWS_BWD_R),
                                 (3703, ROWS_BWD_R), (13001, 301)])
def test_rows_k20_backward_matches_plain(cuda, D, R, res_dtype, every, rate):
    """K20's backward (du, dv, dγ, dβ) against ``res_ln_backward_plain``: a
    row a warp (D = 160, 1,433), four warps (3,703) and eight with the
    column sums in shared memory (13,001); res in float32 and bf16 (the bf16
    layer's x), every row or every 5th (the slot-0 layer's residual).  K20
    has no bf16 products: its arithmetic is float32 on the values given,
    so every output is held by ``check_rows_forward``'s float32 rule; two
    launches equal bit for bit."""
    from graph_transformer_tpu_torch.ops import rows_encoder as re

    gen = torch.Generator(device=cuda).manual_seed(D + every)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, device=cuda, generator=gen) * sc

    res = rnd((R - 1) * every + 1, D).to(getattr(torch, res_dtype))
    v, g = rnd(R, D), rnd(R, D)
    gamma, beta = 1.0 + rnd(D, sc=0.1), rnd(D, sc=0.1)
    kw = dict(res_every=every, rate=rate, seed=5, layer=1, site=3)
    launches = re.K20.launches
    got = re.res_ln_backward(g, res, v, gamma, beta, **kw)
    again = re.res_ln_backward(g, res, v, gamma, beta, **kw)
    want = re.res_ln_backward_plain(g, res, v, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert re.K20.launches == launches + 2
    for name, a, b, p in zip(("du", "dv", "dgamma", "dbeta"), got, again,
                             want):
        assert torch.equal(a, b), name
        chip_smoke.check_rows_forward(
            f"K20 backward {name} D={D} res {res_dtype} every {every} rate "
            f"{rate}", a, p, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [5760, 5761])
@pytest.mark.parametrize("M1,N1", [(68, 204), (68, 68), (68, 1024),
                                   (1024, 68)])
def test_weight_products_at_quickstart_rows(cuda, M1, N1, rows, dtype):
    """The split-K weight products at the shapes of the wide backward's four
    (x^T dqkv, ctx^T da, y1^T dhpre, h^T dz at D=68, F=1024) over the README
    quickstart's 5,760 rows, and 5,761 (a ragged last chunk), against the
    float64 product by the rule of
    :func:`test_weight_product_matches_float64`; runs repeat bit for bit."""
    from graph_transformer_tpu_torch.ops import ffn

    gen = torch.Generator(device=cuda).manual_seed(rows + M1 + N1)
    dt = getattr(torch, dtype)
    a = torch.randn(rows, M1, device=cuda, generator=gen).to(dt)
    b = torch.randn(rows, N1, device=cuda, generator=gen).to(dt)
    got = ffn.weight_product(a, b)
    again = ffn.weight_product(a, b)
    torch.cuda.synchronize()
    want = a.double().T @ b.double()
    scale = a.double().abs().T @ b.double().abs()
    assert got.shape == (M1, N1) and torch.equal(got, again)
    assert bool(((got.double() - want).abs() <= 1e-4 * scale).all())


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_stored_backward_at_quickstart_batch(cuda, rows):
    """K6 and K6s at the README quickstart's batch (N=640, S=9, D=68,
    F=1024, T=4) against their plain versions at rate 0 and 0.5: on K5's
    bf16 residuals (``chip_smoke.check_stored``: K5's forward by the bf16
    spread, every gradient leaf at cosine > 0.999), and with K17 on float32
    rows (``check_stored_rows_f32`` without its forward checks: dx and every
    leaf within 1e-4 of its max of the plain backward on K17's residuals).
    The test holds K6 alone: at this batch the forward checks of
    ``check_stored_rows`` miss on the bf16 forward layer (the spread rule),
    and the float32 forward rule is the max-based one that no sum order
    passes on every case (PERF.md, Open questions); the K17 + K6 = K5 + K6
    relation is held bit for bit by
    ``test_stored_rows_kernel_matches_k5_and_plain``."""
    import chip_smoke

    si, params, x2d = chip_smoke.random_case(
        N=640, S=9, D=68, C=68, F=1024, Tn=4, stored=4, seed=5, dev=cuda,
        one_hot=True)
    if rows == "bfloat16":
        errs = chip_smoke.check_stored("quickstart", si, params, 9, 4, cuda)
        assert {k[0] for k in errs} == {"K5", "K6", "K6s"}
    else:
        chip_smoke.check_stored_rows_f32("quickstart float32", params,
                                         x2d.float(), 9, 4, cuda,
                                         forward=False)


@pytest.mark.parametrize("N", [512, 8832])
@pytest.mark.parametrize("S,D", [(9, 4), (17, 6), (17, 19), (32, 32)])
def test_two_pass_kernels_at_main_path_batches(cuda, S, D, N):
    """K4t, K8 and K8s against their plain versions at the MUTAG HPO arm's
    512 neighborhoods in float32 (the card filled with blocks of fewer
    neighborhoods) and at the A/B scripts' 8,832 in bf16, F = 1024, at
    rate 0 and 0.5 (chip_smoke.check_two_pass)."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=N, S=S, D=D, C=D, F=1024, Tn=2, stored=2, seed=4, dev=cuda)
    dt = torch.float32 if N == 512 else torch.bfloat16
    chip_smoke.check_two_pass(f"N{N}S{S}D{D}", params, x2d.to(dt), S, 2,
                              cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D,Tn", [(9, 4, 4), (17, 19, 4)])
def test_mega_kernel_repeats_the_chain_bit_for_bit(cuda, S, D, Tn, dtype):
    """K14 gives the K8 chain's dx and gradients bit for bit (its blocks
    hold as many neighborhoods as K8's and K8s's, its sums in the chain's
    order), at rate 0.5, at 301 and 512 neighborhoods."""
    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    import chip_smoke

    for N in (301, 512):
        _, params, x2d = chip_smoke.random_case(
            N=N, S=S, D=D, C=D, F=256, Tn=Tn, stored=Tn, seed=6, dev=cuda)
        x2d = x2d.to(getattr(torch, dtype))
        _, xs = ue.u2gnn_encoder_train(x2d, params, S, Tn, 0.5, 97)
        g = torch.randn(N, D, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(N))
        dx_k, gk = ut.mega_recompute_backward(x2d, xs, g, params, S, Tn, 0.5,
                                              97)
        dx_c, gc = ut.chain_backward(x2d, xs, g, params, S, Tn, 0.5, 97)
        torch.cuda.synchronize()
        assert torch.equal(dx_k, dx_c)
        assert all(torch.equal(a, b) for a, b in zip(gk, gc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_kernels_at_act_batch(cuda, dtype):
    """K9 and K10 against their plain versions at ACT's batch (512 x S=9 =
    4,608 rows, D=7, F=1024: K9's FFN on the tensor cores, the card filled
    with blocks of two neighborhoods), rate 0 and 0.5."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=512, S=9, D=7, C=7, F=1024, Tn=1, stored=1, seed=16, dev=cuda)
    chip_smoke.check_encoder_layer("act", params,
                                   x2d.to(getattr(torch, dtype)), 9, cuda)


# rows where the forward layer's FFN changed branch until it had one (the
# tensor cores at every row count): its tests keep both sides of them
FORMER_GATE_ROWS = 49152


def _gate_side(S, side):
    """Neighborhoods whose N*S rows lie just under or just over
    FORMER_GATE_ROWS."""
    under = (FORMER_GATE_ROWS - 1) // S
    return under if side == "under" else under + 1


@pytest.mark.parametrize("side", ["under", "over"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_layer_kernels_at_the_gate(cuda, dtype, side):
    """K4t, K8, K8s (S=17, D=6, T=2) and K9, K10 (S=9, D=7) against their
    plain versions with rows just under and just over FORMER_GATE_ROWS (one
    wave of the card and two), F=1024, rate 0 and 0.5."""
    import chip_smoke

    dt = getattr(torch, dtype)
    N = _gate_side(17, side)
    _, params, x2d = chip_smoke.random_case(
        N=N, S=17, D=6, C=6, F=1024, Tn=2, stored=2, seed=17, dev=cuda)
    chip_smoke.check_two_pass(f"{side} N{N}", params, x2d.to(dt), 17, 2, cuda)
    N = _gate_side(9, side)
    _, params, x2d = chip_smoke.random_case(
        N=N, S=9, D=7, C=7, F=1024, Tn=1, stored=1, seed=18, dev=cuda)
    chip_smoke.check_encoder_layer(f"{side} N{N}", params, x2d.to(dt), 9,
                                   cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_layer_sums_do_not_depend_on_the_blocks(cuda, dtype):
    """K4t and K9 on the first 100 of 512 neighborhoods (one a block) give
    those neighborhoods' outputs, saved inputs and rows of the run on all
    512 (two a block) bit for bit, at rate 0.5: the forward layer's sums
    run in an order that neither G nor the rows sharing a block change."""
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train)
    import chip_smoke

    dt = getattr(torch, dtype)
    _, params, x2d = chip_smoke.random_case(
        N=512, S=17, D=6, C=6, F=1024, Tn=3, stored=3, seed=21, dev=cuda)
    x2d = x2d.to(dt)
    out, xs = u2gnn_encoder_train(x2d, params, 17, 3, 0.5, 11)
    out_s, xs_s = u2gnn_encoder_train(x2d[:100 * 17], params, 17, 3, 0.5, 11)
    p0 = [a[0] for a in params]
    rows = el.encoder_layer_forward(x2d, p0, 17, 0.5, 11, 1)
    rows_s = el.encoder_layer_forward(x2d[:100 * 17], p0, 17, 0.5, 11, 1)
    torch.cuda.synchronize()
    assert torch.equal(out[:100], out_s)
    assert torch.equal(xs[:, :100 * 17], xs_s)
    assert torch.equal(rows[:100 * 17], rows_s)


@pytest.mark.parametrize("side", ["under", "over"])
def test_fused_and_folded_kernels_bit_equal_at_the_gate(cuda, side):
    """At rows just under and just over FORMER_GATE_ROWS (S=9, D=7): K13 bit
    for bit against K1 and the two-pass path, K15 against K1 and K16
    against K15 (``chip_smoke.check_bit_equal_paths``)."""
    import chip_smoke

    N = _gate_side(9, side)
    si, params, _ = chip_smoke.random_case(
        N=N, S=9, D=7, C=7, F=256, Tn=3, stored=1, seed=19, dev=cuda)
    chip_smoke.check_bit_equal_paths(f"{side} N{N}", si, params, 9, 3, cuda)


# the bench's rows: 8,832 neighborhoods x S=9, D=4, F=1024, T=4, bf16
BENCH_ROWS = dict(N=8832, S=9, D=4, C=4, F=1024, Tn=4, stored=4)


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_sampled_kernels_at_bench_rows(cuda, rate):
    """K1 and K13 at the bench's shape against their plain versions: draws
    equal, outputs within the 2e-2 rule, K13 = K1 bit for bit (draws,
    output, saved inputs).  Rate 0.5 takes the layer's half mask (a word's
    top bit into the value's sign, kept values doubled once), 0.3 the
    division by keep; both hold the hidden's mask to the plain stream: K17,
    which runs K1's layer and stores the hidden, on K1's x0 rows with b1
    raised by 10 (the relu then passes every kept value) is nonzero exactly
    where ``keep_mask`` keeps, every layer, so the kept counts are equal."""
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import random as rnd
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    import chip_smoke

    si, params, _ = chip_smoke.random_case(seed=41, dev=cuda, **BENCH_ROWS)
    N, S, T, seed = 8832, 9, 4, 24680
    out1, res1 = se.sampled_forward(*si, params, S, T, rate, seed)
    outp, resp = se.sampled_forward_plain(*si, params, S, T, rate, seed)
    out13, xs13, draws13 = fs.fused_sampled_forward(*si, params, S, T, rate,
                                                    seed)
    torch.cuda.synchronize()
    assert torch.equal(res1["draws"], resp["draws"])
    err = float((out1 - outp).abs().max())
    assert torch.allclose(out1, outp, rtol=2e-2, atol=2e-2), err
    assert torch.equal(draws13, res1["draws"]) and torch.equal(out13, out1)
    assert torch.equal(xs13, torch.stack(res1["xs"]).reshape(T, N * S, 4))
    hi = [p.clone() for p in params]
    hi[7] = hi[7] + 10.0
    x0 = res1["xs"][0].reshape(N * S, 4)
    _, res17 = st.stored_rows_forward(x0, hi, S, T, rate, seed)
    for t, h in enumerate(res17["h"]):
        keep = rnd.keep_mask(seed, rnd.dropout_stream(t, 2), h.shape, rate,
                             cuda)
        assert torch.equal(h != 0, keep != 0), t


def test_fused_and_folded_kernels_bit_equal_at_bench_rows(cuda):
    """At the bench's shape, rate 0 and 0.5: K13 bit for bit against K1 and
    the two-pass path, K15 against K1 and K16 against K15
    (``chip_smoke.check_bit_equal_paths``), and the gradients of K15 with
    K3 and (T-1) x K2 against K1-K3's."""
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    import chip_smoke

    si, params, _ = chip_smoke.random_case(seed=42, dev=cuda, **BENCH_ROWS)
    chip_smoke.check_bit_equal_paths("bench rows", si, params, 9, 4, cuda)
    w = torch.randn(8832, 4, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    for rate in (0.0, 0.5):
        _, res1 = se.sampled_forward(*si, params, 9, 4, rate, 11)
        x0 = res1["xs"][0].reshape(-1, 4)
        grads = []
        for run in ("k1", "folded"):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = (se.sampled_encoder(*si, ps, 9, 4, rate, 11) if run == "k1"
                   else fe.folded_u2gnn_encoder_grad(x0, ps, 9, 4, rate, 11))
            grads.append(torch.autograd.grad((out * w).sum(), ps))
        assert all(torch.equal(a, b) for a, b in zip(*grads)), rate


def test_per_layer_kernels_match_whole_encoder(cuda):
    """T launches of K9 at rate 0 give K4's slot-0 output in float32."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=200, S=9, D=7, C=7, F=256, Tn=3, stored=3, seed=2, dev=cuda)
    chip_smoke.check_per_layer_vs_whole("D7", params, x2d, 9, 3)


@pytest.mark.parametrize("kw,want", [
    (dict(recurrence="act"), ("K7", "K9", "K10")),
    (dict(attention_axis="node"), ("K7", "K11", "K12"))], ids=["act", "node"])
def test_train_steps_launch_the_per_layer_kernels(cuda, kw, want):
    """ACT trains through K7 and K9/K10 once per timestep; the node axis
    through K7 and K11/K12; evaluation runs K9 or K11; no other kernel
    launches."""
    import dataclasses

    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    import chip_smoke

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=40,
                                    seed=0, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=dataclasses.replace(
            ModelConfig(num_timesteps=3, ff_hidden_size=64), **kw),
        train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    counters = chip_smoke.launch_counters()
    for c in counters.values():
        c.launches = 0
    losses = tr.train_steps(tr.builder.sample(), 4)
    train = {k: c.launches for k, c in counters.items()}
    acc = tr.evaluate()
    assert bool(torch.isfinite(losses).all()) and 0.0 <= acc <= 1.0
    got = {k: c.launches for k, c in counters.items()}
    assert (train[want[0]], train[want[1]], train[want[2]]) == (4, 12, 12)
    assert got[want[1]] > train[want[1]] and got[want[2]] == 12
    assert all(v == 0 for k, v in got.items() if k not in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(9, 40), (9, 65), (9, 68), (9, 128),
                                 (32, 68)])
def test_wide_two_pass_kernels_match_plain_versions(cuda, S, D, dtype):
    """K4tw, K8w and K8ws against their plain versions at rate 0 and 0.5, in
    float32 and bf16 (the rules of the narrow ones), with a ragged last
    block; at S=32 a block holds one neighborhood (32 rows, two full m16
    tiles of the tensor-core products); D=65 takes their 4-byte weight
    copies."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=3, stored=3, seed=1, dev=cuda)
    errs = chip_smoke.check_two_pass(f"S{S} D{D}", params,
                                     x2d.to(getattr(torch, dtype)), S, 3, cuda)
    assert {k[0] for k in errs} == {"K4tw", "K8w", "K8ws"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(9, 40), (9, 65), (9, 68), (9, 128),
                                 (32, 68)])
def test_wide_encoder_layer_kernels_match_plain_versions(cuda, S, D, dtype):
    """K9w and K10w against their plain versions at rate 0 and 0.5, in
    float32 and bf16, with a ragged last block (one neighborhood a block at
    S=32; D=65 takes the products' 4-byte weight copies)."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=1, stored=1, seed=1, dev=cuda)
    errs = chip_smoke.check_encoder_layer(
        f"S{S} D{D}", params, x2d.to(getattr(torch, dtype)), S, cuda)
    assert {k[0] for k in errs} == {"K9w", "K10w"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 68, 128])
def test_wide_forward_kernels_at_quickstart_batch(cuda, D, dtype):
    """K4tw (with K8w/K8ws on its saved inputs) and K9w (with K10w) against
    their plain versions at rate 0 and 0.5 at the README quickstart's
    two-pass batch (N=640, S=9, F=1024, T=4): 214 blocks of 3
    neighborhoods; with bf16 rows at D = 40, 68 the products run on the
    tensor cores, otherwise on the CUDA cores."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=640, S=9, D=D, C=D, F=1024, Tn=4, stored=4, seed=3, dev=cuda)
    x = x2d.to(getattr(torch, dtype))
    errs = chip_smoke.check_two_pass(f"D{D}", params, x, 9, 4, cuda)
    errs.update(chip_smoke.check_encoder_layer(f"D{D}", params, x, 9, cuda))
    assert {k[0] for k in errs} == {"K4tw", "K8w", "K8ws", "K9w", "K10w"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [40, 68, 128])
def test_saved_inputs_are_k9w_layers(cuda, D, dtype):
    """K4tw's saved input of layer t + 1 equals K9w applied to layer t's
    input at timestep t, bit for bit, at rate 0 and 0.5 (every t in
    float32; t = 0 in bf16, where K4tw carries the unrounded output on)."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=640, S=9, D=D, C=D, F=1024, Tn=4, stored=4, seed=4, dev=cuda)
    chip_smoke.check_saved_inputs_are_layers(
        f"D{D}", params, x2d.to(getattr(torch, dtype)), 9, 4, cuda)


@pytest.mark.parametrize("D", [7, 68])
def test_fused_sampled_kernel_matches_plain_and_fused_paths(cuda, D):
    """K13 against its plain version (draws equal, forward, every gradient
    leaf at cosine > 0.999) and bit for bit against K1 (D=7) or K5 (D=68)
    for one seed, its gradients within cosine 0.99 of theirs."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=200, S=9, D=D, C=D, F=256, Tn=3, stored=1 if D == 7 else 3, seed=2,
        dev=cuda, one_hot=D > 32)
    chip_smoke.check_fused_sampled(f"D{D}", si, params, 9, 3, cuda)


def _steps_launches(ds, model_cfg, steps=4):
    """Launches of every kernel over ``steps`` training steps and one
    evaluation on the card."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, TrainConfig)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    import chip_smoke

    cfg = ExperimentConfig(data=DataConfig(batch_size=4, num_neighbors=4),
                           model=model_cfg, train=TrainConfig(num_epochs=1))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    counters = chip_smoke.launch_counters()
    for c in counters.values():
        c.launches = 0
    losses = tr.train_steps(tr.builder.sample(), steps)
    train = {k: c.launches for k, c in counters.items()}
    acc = tr.evaluate()
    assert bool(torch.isfinite(losses).all()) and 0.0 <= acc <= 1.0
    return train, {k: c.launches for k, c in counters.items()}


@pytest.mark.parametrize("mean_nodes,want", [
    (40, ("K13", "K8", "K8s", "K4")), (200, ("K13", "K8w", "K8ws", "K4w"))],
    ids=["narrow", "wide"])
def test_train_steps_launch_the_k13_kernels(cuda, mean_nodes, want):
    """The fused path's three flags without ``use_folded`` or
    ``use_stored_bwd`` train through K13 and its recompute backward (per
    step one K13, one K8s and T-1 K8; K8ws/K8w past D=32) and evaluate
    through K4 or the wide K4; nothing else launches."""
    from graph_transformer_tpu_torch.config import ModelConfig
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=mean_nodes,
                                    seed=0, reddit_like=False)
    train, got = _steps_launches(
        ds, ModelConfig(num_timesteps=3, ff_hidden_size=64, **FUSED_FLAGS))
    assert tuple(train[k] for k in want[:3]) == (4, 8, 4)
    assert got[want[3]] == 1
    assert all(v == 0 for k, v in got.items() if k not in want)


@pytest.mark.parametrize("kw,want", [
    ({}, ("K7", "K4tw", "K8w", "K8ws", "K4w")),
    (dict(num_hidden_layers=2), ("K7", "K4tw", "K8w", "K8ws", "K4w")),
    (dict(recurrence="act"), ("K7", "K9w", "K10w"))],
    ids=["default", "k2", "act"])
def test_train_steps_launch_the_wide_two_pass_kernels(cuda, kw, want):
    """One-hot degree features past D=32 under the default configuration
    (float32) train on the two-pass path through K7, K4tw and K8ws/K8w and
    evaluate through the wide K4, with two U2GNN layers likewise, with ACT
    through K7, K9w and K10w; nothing else launches."""
    from graph_transformer_tpu_torch.config import ModelConfig
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=200,
                                    seed=0, reddit_like=False)
    assert 32 < ds.feature_dim <= 128
    _, got = _steps_launches(
        ds, ModelConfig(num_timesteps=3, ff_hidden_size=64, **kw))
    assert all(got[k] > 0 for k in want)
    assert all(v == 0 for k, v in got.items() if k not in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D,Tn,stored", [
    (9, 4, 4, 4), (9, 4, 4, 1), (17, 19, 4, 1), (9, 40, 3, 3), (9, 68, 3, 1),
    (9, 128, 3, 3)])
def test_mega_kernels_match_plain_and_chain(cuda, S, D, Tn, stored, dtype):
    """K14 (K14w past D=32) against the K8 chain on the same saved inputs
    (float32 within 1e-4 of each leaf's max, bf16 at cosine > 0.999) and
    against its plain version (cosine > 0.999), at rate 0 and 0.5."""
    import chip_smoke

    _, params, x2d = chip_smoke.random_case(
        N=301, S=S, D=D, C=D, F=256, Tn=Tn, stored=stored, seed=3, dev=cuda)
    chip_smoke.check_mega(f"S{S} D{D}", params,
                          x2d.to(getattr(torch, dtype)), S, Tn, cuda)


@pytest.mark.parametrize("D,C", [(4, 1), (7, 7)])
def test_folded_kernels_match_k1(cuda, D, C):
    """K15 fed K1's x0 rows: K1's output, residuals and (with K3/K2)
    gradients bit for bit; K16 K15's output; both against their plain
    versions within 2e-2."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=301, S=9, D=D, C=C, F=256, Tn=3, stored=1, seed=4, dev=cuda)
    chip_smoke.check_folded(f"D{D}", si, params, 9, 3, cuda)


@pytest.mark.parametrize("D,one_hot,F", [
    (4, False, 256), (7, False, 256), (7, False, 100), (19, False, 256),
    (32, False, 256), (68, True, 256)])
def test_stored_rows_kernel_matches_k5_and_plain(cuda, D, one_hot, F):
    """K17 fed K5's x0 rows, by ``chip_smoke.check_stored_rows`` (past D=32
    K5's output, residuals and, with K6, gradients bit for bit; up to it
    K15's bit for bit and K5's within the bf16 spread); with float32 rows,
    its output and residuals against the plain forward's and, with K6, the
    plain backward on its residuals.  F=100 takes the hidden's 4-byte
    stores."""
    import chip_smoke

    si, params, x2d = chip_smoke.random_case(
        N=301, S=9, D=D, C=D, F=F, Tn=3, stored=3, seed=5, dev=cuda,
        one_hot=one_hot)
    chip_smoke.check_stored_rows(f"D{D}", si, params, 9, 3, cuda)
    chip_smoke.check_stored_rows_f32(f"D{D} float32", params, x2d.float(), 9,
                                     3, cuda)


@pytest.mark.parametrize("D,one_hot", [(7, False), (68, True)])
def test_fused_sampled_mega_matches_its_chain(cuda, D, one_hot):
    """K13 with K14 (K14w) against K13 with its chain: cosine > 0.999."""
    import chip_smoke

    si, params, _ = chip_smoke.random_case(
        N=301, S=9, D=D, C=D, F=256, Tn=3, stored=3, seed=6, dev=cuda,
        one_hot=one_hot)
    chip_smoke.check_fused_mega(f"D{D}", si, params, 9, 3, cuda)


def test_encoder_variants_launch_their_kernels(cuda, monkeypatch):
    """The hybrid, mega, folded and stored variants and K16 alone, at 301
    neighborhoods: each launches its kernels as often as its layers ask and
    nothing else; their outputs and gradients agree with each other and
    with their plain versions (``chip_smoke.check_variants``)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "AB_ROWS", dict(N=301, S=9, D=4, Tn=4))
    total, _, _ = chip_smoke.encoder_variants(cuda)
    assert all(total[k] >= 1 for k in ("K14", "K14w", "K15", "K16", "K17"))


def test_host_sampling_launches_no_sampler(cuda):
    """``on_device_sampling=False``: training launches the two-pass encoder
    kernels on the host batch's neighborhoods and never K7."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    import chip_smoke

    ds = synthetic_powerlaw_dataset("S", num_graphs=16, mean_nodes=40,
                                    seed=0, reddit_like=False)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=4, num_neighbors=4),
        model=ModelConfig(num_timesteps=3, ff_hidden_size=64),
        train=TrainConfig(num_epochs=1, on_device_sampling=False))
    tr = SupTrainer(ds, cfg, train_idx=np.arange(12),
                    test_idx=np.arange(12, 16))
    counters = chip_smoke.launch_counters()
    for c in counters.values():
        c.launches = 0
    losses = tr.train_steps(tr.builder.sample(), 3)
    assert bool(torch.isfinite(losses).all())
    got = {k: c.launches for k, c in counters.items()}
    want = ("K4t", "K8", "K8s") if ds.feature_dim <= 32 else (
        "K4tw", "K8w", "K8ws")
    assert got["K7"] == 0 and all(got[k] == 3 for k in want[:1])
    assert all(v == 0 for k, v in got.items() if k not in want)


def test_training_steps_repeat_bit_for_bit(cuda, tmp_path):
    """Two runs of three training steps from the same seeds, on the
    two-pass path at the README's 10-fold width (a PTC-like file, K=16,
    T=3, ff 1024, float32), give equal parameters and Adam moments bit for
    bit: nothing on the path adds with float atomics (the pooling is a
    one-hot product since slice 14, not ``index_add_``)."""
    import chip_smoke
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    chip_smoke.write_ptc_like_tu(str(tmp_path))
    ds = load_tu_dataset("PTC", data_dir=str(tmp_path))
    runs = []
    for _ in range(2):
        tr = SupTrainer(ds, chip_smoke.cv_config(1), device="cuda")
        losses = tr.train_steps(tr.builder.sample(), 3)
        assert bool(torch.isfinite(losses).all())
        runs.append([p.detach().clone() for p in tr.model.parameters()]
                    + [m.clone() for m in tr.opt.mu + tr.opt.nu])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_multiplex_step_kernels_match_plain_versions(cuda):
    """K4t and K8s at the siamese multiplex step's shape (12,000
    neighborhoods of S = 9, D = 8, F = 1,024 in float32, rates 0 and 0.5:
    108,000 rows) against their plain versions (``check_two_pass``'s
    rules)."""
    import chip_smoke

    errs = chip_smoke.check_multiplex_kernels(cuda)
    assert {k[0] for k in errs} == {"K4t", "K8s"}


def _sparse_case(cuda, seed=0, n=2816, e=13000, d=64):
    """A Cora-sized edge list on the card: heavy-tailed targets (node 0
    gets a tenth of the edges), padding edges, random values."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.1, 0, rng.integers(0, n, e))
    mask = (rng.random(e) < 0.95).astype(np.float32)

    def t(a, dt=None):
        return torch.tensor(a, dtype=dt, device=cuda)

    return (t(src), t(dst), t(mask), t(rng.normal(size=(n, d)),
                                        torch.float32),
            t(rng.normal(size=e), torch.float32))


def test_sparse_ops_repeat_bit_for_bit(cuda):
    """``spmm`` and ``edge_softmax`` (and their gradients) on the card: two
    runs equal bit for bit, and within 1e-5 of the CPU's."""
    from graph_transformer_tpu_torch.ops import sparse as sp

    src, dst, mask, x, scores = _sparse_case(cuda)
    n = x.shape[0]

    def run(dev):
        s, d, v = sp.gcn_norm_edges(src.to(dev), dst.to(dev), mask.to(dev),
                                    n)
        xs = x.to(dev).clone().requires_grad_()
        sc = scores.to(dev).clone().requires_grad_()
        y = sp.spmm(sp.Segments.of(s, n), sp.Segments.of(d, n), v, xs)
        seg = sp.Segments.of(src.to(dev), n)
        att = sp.edge_softmax(sc, seg, mask.to(dev))
        msg = sp.segment_sum(att[:, None] * sp.gather(
            xs, sp.Segments.of(dst.to(dev), n)), seg)
        ((y * y).sum() + (msg * msg).sum()).backward()
        return [t.detach() for t in (y, att, msg, xs.grad, sc.grad)]

    a, b = run(cuda), run(cuda)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    for p, q in zip(a, run("cpu")):
        err = float((p.cpu() - q).abs().max())
        assert err <= 1e-5 * max(float(q.abs().max()), 1.0)
