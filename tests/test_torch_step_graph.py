"""JAX's one-dispatch training in the port (``train/step_graph.py``): the
seed in device memory, the stacked epoch and ``train_steps`` against the
eager loop, and against JAX.

1. The device seed (``ops/random.device_seed``): every draw, mask and plain
   kernel version gives, from a 0-d int64 tensor, the bits it gives from
   the same int, so that the kernels reading the seed from device memory
   keep their words.
2. On the CPU the captured step runs eagerly over the same buffers:
   ``train_epoch_stacked`` equals ``train_epoch`` from the same state and
   generators, bit for bit in every loss and every parameter, on each
   training path, and ``train_steps(batch, n)`` equals n ``train_step``\\ s
   with the same seeds.
3. Against JAX: the stacked epoch's batches equal, array for array, those
   JAX's ``train_epoch_stacked`` stacks from a builder of the same seed;
   Adam with its count and scale on the device equals optax over steps with
   a scale change in the middle.
4. On the card (marker ``cuda``; skipped here): 20 replayed steps against
   20 eager steps from one saved state and one seed list, bit for bit, at
   the bench's fused flags, the quickstart's float32 two-pass path and the
   unsupervised step (``chip_smoke.replay_against_eager``).

This file imports JAX only inside its JAX comparisons, so that its card
tests run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_step_graph.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_transformer_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from graph_transformer_tpu_torch.data.batching import BatchBuilder
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.ops import attention, rows_encoder
from graph_transformer_tpu_torch.ops import random as rnd
from graph_transformer_tpu_torch.ops.encoder_layer import fused_encoder_layer
from graph_transformer_tpu_torch.ops.ffn import ffn_residual_ln
from graph_transformer_tpu_torch.ops.folded_encoder import (
    folded_u2gnn_encoder,
    folded_u2gnn_encoder_grad,
)
from graph_transformer_tpu_torch.ops.fused_sampled_encoder import (
    fused_sampled_encoder,
)
from graph_transformer_tpu_torch.ops.sampled_encoder import sampled_encoder
from graph_transformer_tpu_torch.ops.sampled_softmax import draw_candidates
from graph_transformer_tpu_torch.ops.stored_encoder import (
    fused_u2gnn_encoder_stored,
    stored_encoder,
)
from graph_transformer_tpu_torch.ops.u2gnn_train import u2gnn_train_encoder
from graph_transformer_tpu_torch.sampling import log_uniform
from graph_transformer_tpu_torch.sampling.log_uniform import LogUniformSpec
from graph_transformer_tpu_torch.sampling.neighbor_table import (
    sample_neighborhoods,
    sample_neighbors,
)
from graph_transformer_tpu_torch.sampling.neighbors import csr_draws
from graph_transformer_tpu_torch.train import optim, step_graph
from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("x", "neigh", "graph_id", "node_gidx", "node_mask", "edge_src",
          "edge_dst", "edge_mask", "labels")
FUSED = dict(use_fused_sampler=True, use_pallas=True,
             use_pallas_whole_encoder=True)
SEED = 1234567


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, so that the CPU's sums repeat bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- 1. the seed
def params12(rng, T, D, F, stored=None):
    """The 12 stacked encoder tensors in KERNEL_ORDER (scale 0.3, LayerNorm
    scales near 1)."""
    s = stored or T
    ps = [torch.tensor(rng.standard_normal(sh) * 0.3, dtype=torch.float32)
          for sh in [(s, D, 3 * D), (s, 3 * D), (s, D, D), (s, D), (s, D),
                     (s, D), (s, D, F), (s, F), (s, F, D), (s, D), (s, D),
                     (s, D)]]
    ps[4] = ps[4] + 1.0
    ps[10] = ps[10] + 1.0
    return [p.requires_grad_() for p in ps]


def tag_inputs(rng, N, C, D):
    """(tag_rows, deg, self_tag, codebook) of the sampled encoders."""
    return (torch.tensor(rng.integers(0, C, (N, 128)), dtype=torch.int32),
            torch.tensor(rng.integers(0, 300, (N,)), dtype=torch.int32),
            torch.tensor(rng.integers(0, C, (N,)), dtype=torch.int32),
            torch.tensor(rng.standard_normal((C, D)), dtype=torch.float32))


def outputs_and_grads(fn, leaves):
    """``fn()``'s output and, where it takes gradients, those of ``leaves``
    for a fixed cotangent."""
    out = fn()
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if not outs[0].requires_grad:
        return [o.detach() for o in outs]
    w = torch.linspace(-1.0, 1.0, outs[0].numel()).view_as(outs[0])
    grads = torch.autograd.grad((outs[0].float() * w).sum(), leaves,
                                allow_unused=True)
    return [o.detach() for o in outs] + [g for g in grads if g is not None]


def encoder_case(name):
    """(fn(seed), leaves) of one kernel's plain version through its public
    entry point (CPU tensors take the plain versions)."""
    rng = np.random.default_rng(len(name))
    N, S, T, F = 6, 5, 2, 16
    if name in ("K1-K3", "K5/K6", "K13/K8", "K13/K14"):
        D = 6
        si = tag_inputs(rng, N, 4, D)
        ps = params12(rng, T, D, F)
        fn = {"K1-K3": sampled_encoder, "K5/K6": stored_encoder,
              "K13/K8": fused_sampled_encoder,
              "K13/K14": lambda *a, **k: fused_sampled_encoder(
                  *a, mega_bwd=True, **k)}[name]
        return (lambda seed: fn(*si, ps, S, T, 0.5, seed)), ps
    D = {"K4tw/K8w": 40, "K14w": 40, "K9w/K10w": 40}.get(name, 6)
    ps = params12(rng, T, D, F)
    x = torch.tensor(rng.standard_normal((N * S, D)), dtype=torch.float32,
                     requires_grad=True)
    if name in ("K4t/K8", "K4tw/K8w"):
        return (lambda seed: u2gnn_train_encoder(x, ps, S, T, 0.5, seed)), \
            ps + [x]
    if name in ("K14", "K14w"):
        return (lambda seed: u2gnn_train_encoder(x, ps, S, T, 0.5, seed,
                                                 mega_bwd=True)), ps + [x]
    xb = x.detach().to(torch.bfloat16).requires_grad_()
    if name == "K15/K2/K3":
        return (lambda seed: folded_u2gnn_encoder_grad(xb, ps, S, T, 0.5,
                                                       seed)), ps + [xb]
    if name == "K16":
        return (lambda seed: folded_u2gnn_encoder(xb, ps, S, T, 0.5, seed)), []
    if name == "K17/K6":
        return (lambda seed: fused_u2gnn_encoder_stored(x, ps, S, T, 0.5,
                                                        seed)), ps + [x]
    if name in ("K9/K10", "K9w/K10w"):
        one = [p[0].detach().requires_grad_() for p in ps]
        return (lambda seed: fused_encoder_layer(x, *one, seed, S, 0.5,
                                                 layer=1)), one + [x]
    if name == "K11/K12":
        one = [p[0].detach().requires_grad_() for p in ps[6:]]
        return (lambda seed: ffn_residual_ln(x, *one, seed=seed, rate=0.5,
                                             layer=1)), one + [x]
    raise KeyError(name)


ENCODERS = ("K1-K3", "K5/K6", "K13/K8", "K13/K14", "K4t/K8", "K4tw/K8w",
            "K14", "K14w", "K15/K2/K3", "K16", "K17/K6", "K9/K10",
            "K9w/K10w", "K11/K12")


@pytest.mark.parametrize("name", ENCODERS)
def test_plain_encoders_draw_alike_from_a_device_seed(name):
    """Each encoder kernel's plain version (forward and backward) from the
    device seed equals its output from the int, bit for bit."""
    fn, leaves = encoder_case(name)
    a = outputs_and_grads(lambda: fn(SEED), leaves)
    b = outputs_and_grads(lambda: fn(torch.tensor(SEED)), leaves)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def rows_case(name):
    """K18-K20's plain versions with dropout (``ops/rows_encoder``)."""
    rng = np.random.default_rng(7)
    N, S, D = 4, 3, 136

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    qkv, dctx, v, g = t(N * S, 3 * D), t(N * S, D), t(N * S, D), t(N * S, D)
    a, b = t(N * S, 40), t(40, D)
    gamma, beta = t(D) + 1.0, t(D)
    return {
        "K18": lambda s: rows_encoder.gemm(a, b, drop=(0.5, s, 1, 2)),
        "K19 forward": lambda s: rows_encoder.attention_forward(
            qkv, S, rate=0.5, seed=s, layer=1),
        "K19 backward": lambda s: rows_encoder.attention_backward(
            qkv, dctx, S, rate=0.5, seed=s, layer=1),
        "K20 forward": lambda s: rows_encoder.res_ln_forward(
            v, g, gamma, beta, rate=0.5, seed=s, layer=1),
        "K20 backward": lambda s: rows_encoder.res_ln_backward(
            dctx, v, g, gamma, beta, rate=0.5, seed=s, layer=1),
    }[name]


def draw_case(name):
    """A draw of ``ops/random`` and the samplers built on it."""
    deg = torch.tensor([0, 1, 3, 200, 7, 128], dtype=torch.int32)
    table = torch.randint(0, 50, (60, 128), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0))
    x_global = torch.randn(60, 5, generator=torch.Generator().manual_seed(1))
    gidx = torch.tensor([3, 4, 5, 6, 0, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    spec_small = LogUniformSpec.create(500, 20)
    return {
        "random_bits": lambda s: rnd.random_bits(s, 77, 1000),
        "keep_mask": lambda s: rnd.keep_mask(s, 5, (7, 9), 0.3),
        "uniform_draws": lambda s: rnd.uniform_draws(s, 6, 4, deg),
        "stream_key": lambda s: torch.as_tensor(rnd.stream_key(s, 11)),
        "layer_seed": lambda s: torch.as_tensor(
            [int(rnd.layer_seed(s, i)) for i in range(4)]),
        "dropout": lambda s: attention.dropout(torch.ones(5, 7), 0.5, s, 2, 1),
        "K7 neighborhoods": lambda s: sample_neighborhoods(
            s, table, deg.repeat(10), x_global, gidx, mask, 4,
            with_ids=True),
        "K7 neighbors": lambda s: sample_neighbors(s, table[:6], deg, gidx, 4),
        "unique candidates": lambda s: log_uniform.sample_log_uniform_unique(
            s, 500, 20),
        "fast candidates": lambda s: log_uniform.sample_log_uniform_fast(
            s, 5000, 30),
        "draw_candidates": lambda s: draw_candidates(s, spec_small),
        "csr_draws": lambda s: csr_draws(s, deg.to(torch.int64), 5, 99),
    }[name]


DRAWS = ("random_bits", "keep_mask", "uniform_draws", "stream_key",
         "layer_seed", "dropout", "K7 neighborhoods", "K7 neighbors",
         "unique candidates", "fast candidates", "draw_candidates",
         "csr_draws")
ROWS = ("K18", "K19 forward", "K19 backward", "K20 forward", "K20 backward")


def flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [] if out is None else [out]


@pytest.mark.parametrize("name", DRAWS + ROWS)
def test_draws_alike_from_a_device_seed(name):
    """The draws, masks, candidate samplers and K7's and K18-K20's plain
    versions from the device seed equal their outputs from the int."""
    fn = draw_case(name) if name in DRAWS else rows_case(name)
    a, b = flat(fn(SEED)), flat(fn(torch.tensor(SEED)))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_device_seed_and_its_address():
    """An int becomes a 0-d int64 tensor, a tensor stays (moved where
    asked), None stays None; the kernels' argument is its address, and a
    launch refuses an int."""
    s = rnd.device_seed(5)
    assert s.dtype == torch.int64 and s.dim() == 0 and int(s) == 5
    assert rnd.device_seed(s) is s and rnd.device_seed(None) is None
    assert rnd.seed_ptr(None) is None and rnd.seed_ptr(s) == s.data_ptr()
    assert rnd.drop_launch(0.5, s)[1:] == rnd.drop_args(0.5, 5)[1:]
    with pytest.raises(TypeError):
        rnd.device_seed(torch.tensor([1, 2]))
    with pytest.raises(TypeError):  # a launch never takes an int
        rnd.seed_ptr(5)


def test_no_launch_takes_a_seed_by_value():
    """Every launch function's seed is a device pointer: ``const long
    long* seed`` in the sources, a pointer in ``_build.SIGNATURES``."""
    import re

    from graph_transformer_tpu_torch.ops import _build

    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    seen = 0
    for m in re.finditer(r'extern "C" \w+ (\w+)\((.*?)\)\s*\{', src, re.S):
        params = [p.strip() for p in m.group(2).split(",")]
        for i, p in enumerate(params):
            if re.search(r"\bseed$", p):
                seen += 1
                assert p == "const long long* seed", (m.group(1), p)
                assert _build.SIGNATURES[m.group(1)][i] is _build._P
    assert seen == 32
    assert "unsigned int seed" not in src


# ------------------------------------------------ 2. stacked against eager
def small_ds():
    return synthetic_powerlaw_dataset("S", num_graphs=30, num_classes=2,
                                      mean_nodes=10, seed=4,
                                      reddit_like=False)


def sup_cfg(train=None, **model):
    return ExperimentConfig(
        data=DataConfig(batch_size=8, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=32, **model),
        train=TrainConfig(num_epochs=2, learning_rate=5e-3, **(train or {})))


def unsup_cfg(**model):
    return ExperimentConfig(
        data=DataConfig(batch_size=6, num_neighbors=3),
        model=ModelConfig(num_timesteps=2, ff_hidden_size=32, sampled_num=16,
                          **model),
        train=TrainConfig(num_epochs=2, learning_rate=5e-3))


PATHS = {
    "sup fused": lambda ds: SupTrainer(ds, sup_cfg(**FUSED), device="cpu"),
    "sup two-pass": lambda ds: SupTrainer(
        ds, sup_cfg(num_hidden_layers=2), device="cpu"),
    "sup host sampling": lambda ds: SupTrainer(
        ds, sup_cfg(train=dict(on_device_sampling=False)), device="cpu"),
    "sup act": lambda ds: SupTrainer(ds, sup_cfg(recurrence="act"),
                                     device="cpu"),
    "unsup u2gnn": lambda ds: UnsupTrainer(ds, unsup_cfg(), device="cpu"),
    "unsup gcn": lambda ds: UnsupTrainer(ds, unsup_cfg(model="gcn_unsup"),
                                         device="cpu"),
}


def leaves(t):
    return [p.detach() for p in t.model.parameters()] + \
        list(t.opt.mu) + list(t.opt.nu)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_stacked_epoch_equals_eager_epoch(path):
    """Two stacked epochs against two eager epochs of a twin trainer, with a
    plateau-rule scale change between them: every epoch loss and every
    parameter and moment bit for bit, the optimizer's count alike."""
    ds = small_ds()
    a, b = PATHS[path](ds), PATHS[path](ds)
    la, lb = [], []
    for epoch in range(2):
        la.append(a.train_epoch())
        lb.append(b.train_epoch_stacked())
        if epoch == 0:
            for t in (a, b):
                optim.set_lr_scale(t.opt, 0.5)
    assert la == lb and all(np.isfinite(la))
    assert a.opt.count == b.opt.count == 2 * a.num_batches_per_epoch
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert b.epoch_losses == a.epoch_losses


@pytest.mark.parametrize("path", ["sup fused", "sup two-pass"])
def test_train_steps_equal_train_step(path):
    """``train_steps(batch, n)`` (the captured step over the one batch)
    against n ``train_step``\\ s with the seeds it draws."""
    ds = small_ds()
    a, b = PATHS[path](ds), PATHS[path](ds)
    batch = a.builder.sample()
    b.builder.sample()
    n = 3
    seeds = [a.next_seed() for _ in range(n)]
    got = b.train_steps(batch, n)
    want = torch.stack([a.train_step(batch, a.step_inputs(batch), s)
                        for s in seeds])
    assert got.shape == (n,) and torch.equal(got, want)
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_step_graph_buffers():
    """The buffers hold MIN_STEPS steps or more, keep their capture across
    calls that fit, and take another batch shape anew."""
    ds = small_ds()
    t = PATHS["sup two-pass"](ds)
    g = t.step_graph(1)
    t.train_steps(t.builder.sample(), 2)
    assert g.order.shape[0] == step_graph.MIN_STEPS
    seeds = g.seeds
    t.train_steps(t.builder.sample(), 5)
    assert g.seeds is seeds and int(g.counter) == 5
    t.train_steps(t.builder.sample(), step_graph.MIN_STEPS + 1)
    assert g.seeds is not seeds
    assert g.order.shape[0] == step_graph.MIN_STEPS + 1
    with pytest.raises(ValueError):
        g.run(g.batches, [0], [1, 2])


# ------------------------------------------------------ 3. against JAX
def test_stacked_batches_equal_jax_stacking(monkeypatch):
    """The batches ``train_epoch_stacked`` stacks equal, array for array,
    what JAX's ``train_epoch_stacked`` stacks (``[builder.sample() for _ in
    range(n)]``, ``np.stack`` field by field) from a builder of the same
    seed, over two epochs."""
    from graph_transformer_tpu.data import batching as jbatching
    from graph_transformer_tpu.data.tu import (
        synthetic_powerlaw_dataset as jax_synthetic,
    )

    kw = dict(num_graphs=30, num_classes=2, mean_nodes=10, seed=4,
              reddit_like=False)
    dj, dt = jax_synthetic("S", **kw), synthetic_powerlaw_dataset("S", **kw)
    cfg = sup_cfg()
    t = SupTrainer(dt, cfg, device="cpu")
    t.builder = BatchBuilder(dt, cfg.data.batch_size, cfg.data.num_neighbors,
                             pad_multiple=cfg.data.pad_multiple,
                             seed=cfg.data.seed, indices=t.train_idx,
                             backend="numpy")
    jb = jbatching.BatchBuilder(dj, cfg.data.batch_size,
                                cfg.data.num_neighbors,
                                pad_multiple=cfg.data.pad_multiple,
                                seed=cfg.data.seed, indices=t.train_idx,
                                backend="numpy")
    seen = []
    run = step_graph.StepGraph.run

    def spy(self, batches, order, seeds):
        seen.append(batches)
        return run(self, batches, order, seeds)

    monkeypatch.setattr(step_graph.StepGraph, "run", spy)
    n = t.num_batches_per_epoch
    assert n > 1
    for _ in range(2):
        t.train_epoch_stacked()
        want = [jb.sample() for _ in range(n)]
        got = seen.pop()
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.stack([np.asarray(getattr(b, f)) for b in want]),
                err_msg=f)


def test_device_count_adam_equals_optax():
    """Six steps of the clipped Adam, whose count, bias corrections and
    scale live on the device, against optax's (rtol 1e-6, atol 1e-7), with
    the scale set to 0.1 after the third; a state-dict round trip in the
    middle keeps the count an int."""
    import jax.numpy as jnp

    from graph_transformer_tpu.train import optim as jax_optim

    rng = np.random.default_rng(3)
    shapes = [(3, 4), (4,), (2, 5, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grad_seq = [[(rng.standard_normal(s) * sc).astype(np.float32)
                 for s in shapes]
                for sc in (3.0, 0.01, 1.0, 0.02, 0.4, 5.0)]
    jopt = jax_optim.make_optimizer(5e-4, 0.5)
    pj = [jnp.asarray(p) for p in p0]
    state = jopt.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    topt = optim.make_optimizer(pt, 5e-4, 0.5)
    for step, gs in enumerate(grad_seq):
        if step == 3:
            state = jax_optim.set_lr_scale(state, 0.1)
            optim.set_lr_scale(topt, 0.1)
            sd = topt.state_dict()
            assert sd["count"] == 3 and isinstance(sd["count"], int)
            topt.load_state_dict(sd)
        upd, state = jopt.update([jnp.asarray(g) for g in gs], state, pj)
        pj = [p + u for p, u in zip(pj, upd)]
        topt.step([torch.from_numpy(g) for g in gs])
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    assert topt.count == 6 and int(topt.count_t) == 6
    c1, c2 = topt.bias_corrections()
    assert float(c1) == 1.0 - 0.9 ** 6 and float(c2) == 1.0 - 0.999 ** 6
    assert float(topt.scale_t) == pytest.approx(0.1)


# ------------------------------------------------------------ 4. the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


CARD_CASES = ("bench fused", "quickstart float32", "unsup")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_replay_equals_eager_on_the_card(cuda, case, tmp_path):
    """20 replayed steps against 20 eager steps from one saved state and
    one seed list: every loss and every leaf bit for bit."""
    import chip_smoke

    make = chip_smoke.replay_cases(str(tmp_path), small=True)[case]
    chip_smoke.replay_against_eager(case, make, n=20)
