#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds the port's kernels from ``graph_transformer_tpu_torch/ops/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, at
   dropout rate 0 and 0.5 (both draw the same bits from ops/random.py), with
   sampled indices exactly equal and dx and each of the 12 weight gradients
   at cosine > 0.999 on its own:
   - K1-K4 at the benchmark's shapes and at a MUTAG-like shape with a
     random 7-row codebook (the benchmark's constant features make every
     slot equal), forward rtol/atol 2e-2 in bf16; K4 also in float32 at
     PTC's width (D=19) to 1e-4, where bf16 rounding alone moves outputs by
     up to ~0.3;
   - K5 and K6 at N=4096, S=9, F=1024, T=4 with IMDBBINARY's width (D=65,
     one-hot codebook), at D=128 (random codebook) and at PTC's K=16 shape
     (S=17, D=19), the forward by ``check_bf16_spread``;
   - K5/K6 against K1/K2/K3 at the MUTAG-like shape: equal draws, outputs
     within 2e-2, every gradient leaf at cosine > 0.999;
   - the wide K4 in float32 at D=65 and D=128 (``check_k4_f32``);
   - K7 (the two-pass sampler) on a heavy-tailed graph at K=16 and K=8:
     equal ids, every id a neighbor, hub rows drawn from their subsample;
     its sampling stage (``sample_neighborhoods``: draws, feature rows and
     batch slots in one launch) on batches of that graph (float32 D=6,
     bf16 D=7) and on each two-pass path's own batch: features, slots and
     ids equal to the plain version's bit for bit, every slot the batch row
     of its draw (``check_neighborhoods``);
   - K4t, K8 and K8s at N=4096, F=1024 in float32 and bf16 at the MUTAG HPO
     arm's shape (S=17, D=7, T=5), the ENZYMES-attribute shape (S=9, D=18,
     T=4) and the shared-memory edge (S=32, D=32) (``check_two_pass``);
   - the two-pass path (K7, gather, K4t, K8/K8s) against K1-K3 at one layer
     on a codebook (``check_two_pass_vs_fused``);
   - K9/K10 (one encoder layer, every row out; its recompute backward) at
     (S, D) = (9, 7), (17, 19), (32, 32), N=4096, F=1024, and K11/K12 (the
     FFN with residual and LayerNorm; its backward) at D = 4, 68, 128 over
     36,864 rows, in float32 and bf16, every gradient leaf on its own
     (``check_encoder_layer``, ``check_ffn``); T launches of K9 against K4
     in float32 (``check_per_layer_vs_whole``);
   - K14 (the whole-stack backward) against the K8 chain on the same saved
     inputs and against its plain version at (S, D, T) = (9, 4, 4) and
     (17, 19, 4), K14w at D = 40, 68, 128, weight-tied or not, float32 and
     bf16 (``check_mega``); K15 and K16 bit for bit against K1 on K1's rows
     (``check_folded``), K17 against K5 on K5's rows (bit for bit past
     D=32; up to it, where K17 runs K1's layer, bit for bit against K15 and
     within the bf16 spread of K5) and, with float32 rows, with K6 against
     the plain forward and backward
     (``check_stored_rows``, ``check_stored_rows_f32``), K13 with K14 or
     K14w against K13 with its chain (``check_fused_mega``);
   - at D = 40, 68, 128 in float32 and bf16, K4tw's saved layer inputs
     against K9w's layers bit for bit (``check_saved_inputs_are_layers``);
   - K4t, K8 and K8s at the MUTAG HPO arm's own rows (512 x S=17, D=6,
     T=5) and K9/K10 at ACT's (512 x S=9, D=7), F=1024, float32 and bf16;
     then K1 and K13 at the bench's rows timed at rate 0.5 and 0, with the
     integer floor of their dropout words from the SASS of the layer's FFN
     loop and the card's SM clock (``hash_floor``).
3. Drives slice 1's main path: ``SupTrainer(device="cuda")`` on the
   benchmark workload of ``bench.py`` (synthetic REDDITMULTI5K-like, batch
   16, K=8, T=4, ff 1024, bf16): warm-up steps, timed ``train_steps`` on a
   fixed batch (CUDA events), ``evaluate()``; asserts finite losses and
   the launch counts (per step 1 x K1, (T-1) x K2, 1 x K3; K4 at eval), and
   profiles five more steps (device busy share, device time per kernel).
4. Drives slice 2's main path: the README quickstart through the CLI
   (``cli.train_sup.main`` with the README flags, 2 epochs) on a generated
   IMDBBINARY-like TU file, whose forced degree tags give rows past D=32;
   asserts finite losses, an accuracy in [0, 1], K5/K6/wide-K4 launches and
   no K1-K4 launch; then times and profiles steps at that configuration.
5. Drives slice 3's main paths, the two-pass path, through the CLI for 2
   epochs each: the MUTAG HPO best arm (two U2GNN layers, K=16, T=5, degree
   tags) on a generated MUTAG-like file and the ENZYMES row with 18
   continuous node attributes on a generated ENZYMES-like file; asserts
   finite losses and K7/K4t/K8/K8s launches with no fused-path kernel; then
   times and profiles the HPO arm's step at 16 graphs a batch.  Every timed
   two-pass step (quickstart, HPO arm, ACT, node axis) must launch K7 once,
   as ``sample_neighborhoods``, whose batch slots the model re-gathers by.
6. Drives slice 4's main paths, the per-layer encoder, through the CLI for
   2 epochs each: the MUTAG row (``RESULTS.md:20``) with ``--recurrence
   act`` on the MUTAG-like file (K7, K9, K10; nothing else) and the README
   quickstart with ``--attention_axis node`` on the IMDBBINARY-like file
   (K7, K11, K12; nothing else); 3 steps of each other recurrence and of two
   heads; then times and profiles the ACT step at 16 graphs a batch and the
   node-axis quickstart step.
7. Drives slice 5's fused flags through ``SupTrainer`` (K13 with K8/K8w,
   K5/K6), slice 6's host sampling (the quickstart through the CLI with
   ``--host_sampling``: K4tw, K8ws/K8w and the wide K4, no K7), and slice
   6's main path, the encoder variants that the A/B scripts compare at
   their workload (``encoder_variants``: hybrid K4t/K8s/K8, mega K4t/K14,
   folded K15/K3/K2, stored K17/K6, K16 alone; at the quickstart's width
   K4tw/K8w, K4tw/K14w, K17/K6), each with every other kernel idle, then
   holds K14/K14w, K15, K16, K17 and the K6 and K3/K2 backwards against
   their plain versions on those inputs and the stored and folded
   gradients against hybrid's (``check_variants``).
8. Drives slice 14's main paths, the paper's 10-fold protocol, on a
   PTC-like file with labels learnable from class-dependent tag
   distributions (``write_ptc_like_tu``), at the README's 10-fold width
   (batch 4, ff 1024, K=16, T=3, float32; two-pass: K7, K4t, K8s, 2 x K8 a
   step, K4 at evaluation, and nothing else): ``cli.tenfold.main`` for 2
   epochs (fails unless the mean of the folds' best accuracies is at least
   0.75 and every loss is finite); ``TenfoldVmapRunner`` against a
   ``SupTrainer`` a fold on 3 folds x 2 epochs, equal bit for bit;
   ``run_cv_on_device`` on 2 folds x 4 epochs in chunks of 2, killed after
   its first snapshot and resumed under ``run_cv_elastic``, equal bit for
   bit to the uninterrupted run, with its device busy share beside the
   sequential runner's; ``cli.train_sup`` with ``--checkpoint_every 1``
   resumed, equal to a straight run (``cv_phases``).
9. Drives the unsupervised path (``unsup_phases``), after the kernel
   timings and before item 8's phases: on an IMDBBINARY-like
   file at the README's unsup width (batch 2, K=8, T=1, ff 1024, 512
   candidates, float32 degree tags of D=68), K7, K4tw and K8ws held to
   their plain versions on a training batch and K13w with K8ws on the same
   batch with the fused flags (``check_unsup_kernels``); the sampled
   softmax in both modes at that vocabulary and at 40,000 nodes (the fast
   sampler) against a float64 host recomputation, the card's candidates
   equal to the CPU's (``check_unsup_softmax``); ``cli.train_unsup.main``
   for 2 epochs (1,000 steps: finite falling losses, the probe's mean
   printed, exactly K7, K4tw and K8ws once a step); 20 steps each of the
   README's command, the fused flags (K13w, K8ws), two U2GNN layers (K7,
   2 x K4tw, 2 x K8ws) and a 40,000-node vocabulary (K7, K4t, K8s), with a
   profile of 20 steps; two runs of 5 steps equal bit for bit; and the
   probe's best mean on the PTC-like file with learnable labels at least
   0.75 (``unsup_accuracy``).
10. Prints edges/s, one JSON line describing every kernel (its device time
   per launch from torch.profiler, the whole wrapper's time from CUDA
   events, launches on its main path, bound, plain version's time, library
   call's time), the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or the
port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM, dense bf16 tensor cores
F32_FLOP_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
STEPS, WARMUP = 20, 3
BATCH, K, T, FF = 16, 8, 4, 1024


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cosine(a, b) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


LEAVES = ("dx", "w_in", "b_in", "w_out", "b_out", "g1", "c1", "w1", "b1",
          "w2", "b2", "g2", "c2")


FFN_LEAVES = ("dx", "w1", "b1", "w2", "b2", "gamma", "beta")


def check_grads(label, dx_k, gk, dx_p, gp, names=LEAVES) -> tuple:
    """dx and each of the weight gradients on its own: cosine > 0.999 (a
    leaf that is exactly zero in both passes).  Returns the worst leaf's
    (max |k - p|, that over its max |p|) and the lowest cosine."""
    ab, rel, low = 0.0, 0.0, 1.0
    for leaf, a, b in zip(names, (dx_k,) + tuple(gk), (dx_p,) + tuple(gp)):
        err = float((a - b).abs().max())
        ref = float(b.abs().max())
        if err == 0.0 and ref == 0.0:
            continue
        c = cosine(a, b)
        if not c > 0.999:
            fail(f"{label} {leaf}: gradient cosine {c}, max|err| {err}, "
                 f"max|plain| {ref}")
        ab, rel, low = max(ab, err), max(rel, err / max(ref, 1e-30)), min(low, c)
    return (ab, rel), low


def max_err(outs_k, outs_p) -> tuple:
    """(max |k - p|, that over max |p|) across pairs of tensors."""
    ab = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
    ref = max(float(b.abs().max()) for b in outs_p)
    return ab, ab / max(ref, 1e-30)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ kernel checks
def random_case(N, S, D, C, F, Tn, stored, seed, dev, one_hot=False):
    """Random weights (scale 0.3, LayerNorm scales near 1), tag rows, degrees
    up to 300, a C-row codebook (the D x D identity when ``one_hot``) and
    bf16 eval rows."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=dt, device=dev)

    params = [t(rng.standard_normal(s) * 0.3) for s in [
        (stored, D, 3 * D), (stored, 3 * D), (stored, D, D), (stored, D),
        (stored, D), (stored, D), (stored, D, F), (stored, F), (stored, F, D),
        (stored, D), (stored, D), (stored, D)]]
    params[4] = params[4] + 1.0
    params[10] = params[10] + 1.0
    si = (t(rng.integers(0, C, (N, 128)), torch.int32),
          t(rng.integers(0, 300, (N,)), torch.int32),
          t(rng.integers(0, C, (N,)), torch.int32),
          t(np.eye(D) if one_hot else rng.standard_normal((C, D))))
    x2d = t(rng.standard_normal((N * S, D))).to(torch.bfloat16)
    return si, params, x2d


def check_kernels(label, si, params, x2d, S, Tn, dev):
    import torch

    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder, u2gnn_encoder_plain)

    errs = {}
    N = si[0].shape[0]
    D = si[3].shape[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    for rate in (0.0, 0.5):
        seed = 1234567
        out_k, res_k = se.sampled_forward(*si, params, S, Tn, rate, seed)
        out_p, res_p = se.sampled_forward_plain(*si, params, S, Tn, rate, seed)
        torch.cuda.synchronize()
        if not torch.equal(res_k["draws"], res_p["draws"]):
            fail(f"{label} rate {rate}: K1 sampled indices differ")
        lim = si[1].clamp(1, 128).to(torch.int64)[:, None]
        if bool((res_k["draws"] >= lim).any()):
            fail(f"{label}: a draw falls outside min(deg, 128)")
        e1 = max_err([out_k], [out_p])
        if not torch.allclose(out_k, out_p, rtol=2e-2, atol=2e-2):
            fail(f"{label} rate {rate}: K1 forward max err {e1[0]}")
        # K3 (last layer) and K2 (layer 0) on identical residuals
        t3 = Tn - 1
        g3 = torch.randn(N, D, device=dev, generator=gen)
        p3 = [a[t3 % a.shape[0]] for a in params]
        args3 = (res_k["xs"][t3], res_k["qkv"][t3], res_k["attn"][t3],
                 res_k["strip"][t3], g3)
        dx_k, gk = se.slot0_backward(*args3, params, t3, rate, seed)
        dx_p, gp = se.slot0_backward_plain(*args3, p3, layer=t3, rate=rate,
                                           seed=seed)
        e3, c3 = check_grads(f"{label} rate {rate}: K3", dx_k, gk, dx_p, gp)
        errs[("K3", rate)] = e3
        if Tn > 1:
            g2 = torch.randn(N, S, D, device=dev, generator=gen)
            p2 = [a[0] for a in params]
            args2 = (res_k["xs"][0], res_k["qkv"][0], res_k["attn"][0],
                     res_k["strip"][0], g2)
            dx_k, gk = se.layer_backward(*args2, params, 0, rate, seed)
            dx_p, gp = se.layer_backward_plain(*args2, p2, layer=0, rate=rate,
                                               seed=seed)
            e2, c2 = check_grads(f"{label} rate {rate}: K2", dx_k, gk, dx_p,
                                 gp)
            errs[("K2", rate)] = e2
        # K4
        o4k = u2gnn_encoder(x2d, params, S, Tn, rate, seed)
        o4p = u2gnn_encoder_plain(x2d, params, S, Tn, rate, seed)
        e4 = max_err([o4k], [o4p])
        if not torch.allclose(o4k, o4p, rtol=2e-2, atol=2e-2):
            fail(f"{label} rate {rate}: K4 forward max err {e4[0]}")
        errs[("K1", rate)] = e1
        errs[("K4", rate)] = e4
        print(f"# check {label} rate {rate}: max|err| (relative to max|plain|"
              f"; for K2/K3 the worst of dx and the 12 grads, each against its"
              f" own max, and the lowest per-leaf cosine) K1 {e1[0]:.3e} "
              f"({e1[1]:.1e}, draws equal), K2 "
              + ("%.3e (%.1e, cos %.6f)" % (*errs[("K2", rate)], c2)
                 if Tn > 1 else "-")
              + f", K3 {e3[0]:.3e} ({e3[1]:.1e}, cos {c3:.6f}), K4 {e4[0]:.3e}"
              f" ({e4[1]:.1e})", flush=True)
    return errs


def plain_f64(x2d, params, S, Tn, rate, seed, slot0=True):
    """The plain encoder in float64 with unrounded operands: the reference
    that shows how far float32 sum order alone moves an output.  With
    ``slot0`` False the last layer is a full one and every row comes out
    ([N·S, D]: the input of layer Tn, as the training forwards save it)."""
    import torch

    from graph_transformer_tpu_torch.ops.attention import layer_forward

    D = x2d.shape[1]
    h = x2d.double().view(-1, S, D)
    for t in range(Tn):
        p = [a[t % a.shape[0]].double() for a in params]
        h, _ = layer_forward(h, p, layer=t, rate=rate, seed=seed,
                             mm=torch.float32, slot0=slot0 and t == Tn - 1)
    return h if slot0 else h.reshape(-1, D)


def check_k4_f32(label, params, x2d, S, Tn):
    """K4 (the wide K4 past D=32) against its plain version with float32
    rows and products, where only the order of the sums differs: within
    1e-4, or, where float32 sum order alone moves the plain version further
    than that from a float64 reference (D=128 at rate 0.5: 3.4e-4), within
    twice the plain version's own float32 error of that reference.  Prints
    how far bf16 rows move the kernel from the float32 plain version and
    from the bf16 plain version.  Returns the worst float32 (max |err|,
    relative)."""
    import torch

    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder, u2gnn_encoder_plain)

    x32 = x2d.to(torch.float32)
    worst = (0.0, 0.0)
    for rate in (0.0, 0.5):
        o4k = u2gnn_encoder(x32, params, S, Tn, rate, 77)
        o4p = u2gnn_encoder_plain(x32, params, S, Tn, rate, 77)
        e4 = max_err([o4k], [o4p])
        ref = plain_f64(x32, params, S, Tn, rate, 77)
        ek = float((o4k.double() - ref).abs().max())
        ep = float((o4p.double() - ref).abs().max())
        if not (torch.allclose(o4k, o4p, rtol=1e-4, atol=1e-4)
                or ek <= 2.0 * ep):
            fail(f"{label} rate {rate}: K4 float32 max err {e4[0]} "
                 f"(float64 reference: kernel {ek}, plain {ep})")
        worst = max(worst, e4)
        o4b = u2gnn_encoder(x2d, params, S, Tn, rate, 77)
        gap = max_err([o4b], [o4p])
        gap_b = max_err(
            [o4b], [u2gnn_encoder_plain(x2d, params, S, Tn, rate, 77)])
        print(f"# check {label} rate {rate}: K4 float32 max|err| {e4[0]:.3e}"
              f" ({e4[1]:.1e}; vs float64: kernel {ek:.3e}, plain "
              f"{ep:.3e}); K4 bf16 vs plain float32 {gap[0]:.3e}"
              f" ({gap[1]:.1e}), vs plain bf16 {gap_b[0]:.3e}"
              f" ({gap_b[1]:.1e})", flush=True)
    return worst


def check_bf16_spread(label, out_k, out_p) -> tuple:
    """The wide kernels' bf16 forward against its plain version: relative
    L2 error <= 1e-2 and at most 1% of outputs beyond 2e-2 (+ 2e-2 of
    |plain|).  Not elementwise 2e-2: at D >= 19 a product operand that
    rounds to the other bf16 neighbour moves single outputs by up to ~1
    after four layers, and the plain version run on the CPU and on the card
    spreads as far (``scripts/torch_wide_probe.py``).  Returns (max |err|,
    relative)."""
    d = (out_k - out_p).abs()
    rel_l2 = float(d.norm() / out_p.norm().clamp_min(1e-30))
    frac = float((d > 2e-2 + 2e-2 * out_p.abs()).float().mean())
    if not (rel_l2 <= 1e-2 and frac <= 1e-2):
        fail(f"{label}: bf16 forward relative L2 {rel_l2}, share beyond "
             f"2e-2 {frac}, max {float(d.max())}")
    print(f"#   {label}: bf16 relative L2 {rel_l2:.2e}, share beyond 2e-2 "
          f"{frac:.2e}, max {float(d.max()):.3e}", flush=True)
    return max_err([out_k], [out_p])


def check_stored(label, si, params, S, Tn, dev):
    """K5 and K6 against their plain versions at rate 0 and 0.5: sampled
    indices equal, the forward by :func:`check_bf16_spread`, and K6 (the
    slot-0 last layer and layer 0, on K5's residuals) with dx and each of
    the 12 gradients at cosine > 0.999 on its own.  Returns the errors by
    (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import stored_encoder as st

    errs = {}
    N = si[0].shape[0]
    D = si[3].shape[1]
    gen = torch.Generator(device=dev).manual_seed(6)
    for rate in (0.0, 0.5):
        seed = 7654321
        out_k, res_k = st.stored_forward(*si, params, S, Tn, rate, seed)
        out_p, res_p = st.stored_forward_plain(*si, params, S, Tn, rate, seed)
        torch.cuda.synchronize()
        if not torch.equal(res_k["draws"], res_p["draws"]):
            fail(f"{label} rate {rate}: K5 sampled indices differ")
        lim = si[1].clamp(1, 128).to(torch.int64)[:, None]
        if bool((res_k["draws"] >= lim).any()):
            fail(f"{label}: a K5 draw falls outside min(deg, 128)")
        e5 = check_bf16_spread(f"{label} rate {rate}: K5", out_k, out_p)
        errs[("K5", rate)] = e5

        def args(t, g):
            return (res_k["xs"][t], res_k["qkv"][t], res_k["attn"][t],
                    res_k["strip"][t], res_k["h"][t], g)

        def at(t):
            return [a[t % a.shape[0]] for a in params]

        t3 = Tn - 1
        g3 = torch.randn(N, D, device=dev, generator=gen)
        dx_k, gk = st.stored_slot0_backward(*args(t3, g3), params, t3, rate,
                                            seed)
        dx_p, gp = st.stored_layer_backward_plain(
            *args(t3, g3), at(t3), layer=t3, rate=rate, seed=seed, slot0=True)
        errs[("K6s", rate)], c6s = check_grads(
            f"{label} rate {rate}: K6 slot 0", dx_k, gk, dx_p, gp)
        line = (f"# check {label} rate {rate}: K5 max|err| {e5[0]:.3e} "
                f"({e5[1]:.1e}, draws equal); K6 slot-0 worst leaf "
                f"{errs[('K6s', rate)][0]:.3e} ({errs[('K6s', rate)][1]:.1e},"
                f" cos {c6s:.6f})")
        if Tn > 1:
            g2 = torch.randn(N, S, D, device=dev, generator=gen)
            dx_k, gk = st.stored_layer_backward(*args(0, g2), params, 0, rate,
                                                seed)
            dx_p, gp = st.stored_layer_backward_plain(
                *args(0, g2), at(0), layer=0, rate=rate, seed=seed)
            errs[("K6", rate)], c6 = check_grads(
                f"{label} rate {rate}: K6", dx_k, gk, dx_p, gp)
            line += (f"; K6 worst leaf {errs[('K6', rate)][0]:.3e} "
                     f"({errs[('K6', rate)][1]:.1e}, cos {c6:.6f})")
        print(line, flush=True)
    return errs


def check_paths(label, si, params, S, Tn, dev):
    """K5/K6 against K1/K2/K3 on the same inputs and seed, at rate 0 and
    0.5: equal draws, outputs within 2e-2, and each of the 12 parameter
    gradients of the whole encoder at cosine > 0.999 on its own (the two
    training paths compute one function)."""
    import torch

    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st

    N = si[0].shape[0]
    D = si[3].shape[1]
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    for rate in (0.0, 0.5):
        seed = 2468
        draws, outs, grads = [], [], []
        for fwd, enc in ((se.sampled_forward, se.sampled_encoder),
                         (st.stored_forward, st.stored_encoder)):
            draws.append(fwd(*si, params, S, 1, rate, seed)[1]["draws"])
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = enc(*si, ps, S, Tn, rate, seed)
            grads.append(torch.autograd.grad((out * w).sum(), ps))
            outs.append(out.detach())
        torch.cuda.synchronize()
        if not torch.equal(draws[0], draws[1]):
            fail(f"{label} rate {rate}: K1 and K5 draw different neighbors")
        e = max_err([outs[1]], [outs[0]])
        if not torch.allclose(outs[1], outs[0], rtol=2e-2, atol=2e-2):
            fail(f"{label} rate {rate}: K5 vs K1 output max err {e[0]}")
        low = 1.0
        for leaf, a, b in zip(LEAVES[1:], grads[1], grads[0]):
            c = cosine(a, b)
            if not c > 0.999:
                fail(f"{label} rate {rate}: K6 vs K2/K3 {leaf} cosine {c}")
            low = min(low, c)
        print(f"# check {label} rate {rate}: K5/K6 vs K1/K2/K3: draws equal,"
              f" output max|diff| {e[0]:.3e} ({e[1]:.1e}), lowest gradient "
              f"leaf cosine {low:.6f}", flush=True)


def check_sampler(label, ds, K, seed, dev):
    """K7 against its plain version on every node of ``ds``: equal ids, the
    node itself in slot 0, every other id a true neighbor (or the node, when
    it has none), and each draw from the first min(deg, 128) entries of the
    node's table row, so that a hub (deg > 128) draws only from its
    subsample.  Returns (0, 0): the ids are integers and equal."""
    import torch

    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        build_neighbor_table, sample_neighbors, sample_neighbors_plain)

    table = build_neighbor_table(ds, hub_seed=0)
    n = ds.num_nodes
    deg = ds.degrees
    rows = torch.from_numpy(table).to(dev)
    deg_t = torch.from_numpy(deg.astype(np.int32)).to(dev)
    gidx = torch.arange(n, dtype=torch.int32, device=dev)
    ids_k = sample_neighbors(seed, rows, deg_t, gidx, K)
    ids_p = sample_neighbors_plain(seed, rows, deg_t, gidx, K)
    torch.cuda.synchronize()
    if not torch.equal(ids_k, ids_p):
        fail(f"{label}: K7 ids differ from its plain version")
    if not torch.equal(ids_k[:, 0], gidx):
        fail(f"{label}: K7 slot 0 is not the node itself")
    ids = ids_k[:, 1:].to(torch.int64)
    src = np.repeat(np.arange(n), np.diff(ds.nbr_offsets))
    edges = torch.from_numpy(src * n + ds.nbr_ids.astype(np.int64)).to(dev)
    key = torch.arange(n, device=dev)[:, None] * n + ids
    isolated = torch.from_numpy(deg == 0).to(dev)[:, None]
    ok = torch.isin(key, edges) | (isolated & (ids == gidx[:, None].long()))
    if not bool(ok.all()):
        fail(f"{label}: {int((~ok).sum())} K7 ids are not neighbors")
    lim = deg_t.clamp(1, 128).long()
    cols = torch.arange(128, device=dev)[None, None, :]
    in_row = ((rows.long()[:, None, :] == ids[:, :, None])
              & (cols < lim[:, None, None])).any(-1)
    if not bool(in_row.all()):
        fail(f"{label}: a K7 draw falls outside its row's first min(deg, "
             "128) entries")
    hubs = int((deg > 128).sum())
    if hubs == 0:
        fail(f"{label}: the dataset has no hub past 128")
    print(f"# check {label}: K7 ids equal to the plain version's on {n} "
          f"nodes at K={K}; all neighbors of their node, {hubs} hub rows "
          "drew from their subsample", flush=True)
    # the sampling stage of a step on batches of the same graph: float32
    # rows of 6 (8-byte units), bf16 rows of 7 (2-byte units)
    from graph_transformer_tpu_torch.data.batching import BatchBuilder

    gen = torch.Generator(device=dev).manual_seed(seed)
    builder = BatchBuilder(ds, 4, K, seed=seed)
    for D, dt in ((6, torch.float32), (7, torch.bfloat16)):
        x_global = torch.randn(n, D, device=dev, generator=gen).to(dt)
        check_neighborhoods(f"{label} D={D} {dt}", rows, deg_t, x_global,
                            builder.sample().to(dev), K, seed)
    return 0.0, 0.0


def check_neighborhoods(label, table, deg, x_global, batch, K, seed):
    """K7's sampling stage at ``batch``'s rows (``sample_neighborhoods``)
    against its plain version: features, slots and ids equal bit for bit;
    the ids are those K7 draws from the table rows gathered by node id
    (``sample_neighbors``, the unchanged draws); a real row's slots are the
    batch rows of its draws in its own graph, slot 0 itself, a padding
    row's its own row.  Returns (0, 0)."""
    import torch

    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        sample_neighborhoods, sample_neighborhoods_plain, sample_neighbors)

    gidx, mask = batch.node_gidx, batch.node_mask
    got = sample_neighborhoods(seed, table, deg, x_global, gidx, mask, K,
                               with_ids=True)
    want = sample_neighborhoods_plain(seed, table, deg, x_global, gidx, mask,
                                      K, with_ids=True)
    g = gidx.long()
    ids = sample_neighbors(seed, table[g], deg[g], gidx, K)
    torch.cuda.synchronize()
    for name, a, b in zip(("features", "slots", "ids"), got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{label}: K7 {name} differ from its plain version")
    if not torch.equal(got[2], ids):
        fail(f"{label}: K7's batch draws differ from its draws on gathered "
             "rows")
    N = gidx.shape[0]
    slots, real = got[1], mask > 0
    rows = torch.arange(N, device=slots.device)[:, None].expand(N, K + 1)
    if not (torch.equal(g[slots[real]], ids[real].long())
            and torch.equal(batch.graph_id[slots[real]],
                            batch.graph_id[real][:, None].expand(-1, K + 1))
            and torch.equal(slots[real][:, 0], rows[real][:, 0])
            and torch.equal(slots[~real], rows[~real])):
        fail(f"{label}: K7's slots are not the batch rows of its draws")
    print(f"# check {label}: K7 features {tuple(got[0].shape)} "
          f"{got[0].dtype}, slots and ids equal to the plain version's on "
          f"{int(real.sum())} real and {int((~real).sum())} padding rows at "
          f"K={K}; every slot the batch row of its draw", flush=True)
    return 0.0, 0.0


def k7_bytes(table, deg, x_global, batch, K, seed, out) -> int:
    """The bytes K7 must move at ``batch``'s rows for this run's draws: its
    outputs ``out`` (features, slots) written once, and every 32-byte
    sector it reads once: the node ids and the mask, the degrees and the
    drawn table entries at the batch's node ids, and the drawn feature
    rows."""
    import torch

    from graph_transformer_tpu_torch.ops.random import uniform_draws

    g = batch.node_gidx.long()
    N = g.shape[0]
    draws = uniform_draws(seed, N, K, deg[g], table.shape[1])
    ids = out[2].long()
    rb = x_global.shape[1] * x_global.element_size()
    span = torch.arange(-(-rb // 32) + 1, device=g.device)
    first, last = ids * rb // 32, (ids * rb + rb - 1) // 32
    x_sec = (first.reshape(-1, 1) + span).clamp(max=last.reshape(-1, 1))
    sectors = (2 * -(-N * 4 // 32) + torch.unique(g * 4 // 32).numel()
               + torch.unique((g[:, None] * table.shape[1] + draws) * 4
                              // 32).numel()
               + torch.unique(x_sec).numel())
    return nbytes(*out[:2]) + 32 * sectors


def check_two_pass(label, params, x2d, S, Tn, dev):
    """K4t, K8 and K8s (K4tw, K8w and K8ws past D=32) against their plain
    versions at rate 0 and 0.5, with rows and products in ``x2d``'s
    dtype.  The forward (the output and the
    last saved layer input): in float32 within 1e-4, or within twice the
    plain version's own float32 error of a float64 reference (as
    :func:`check_k4_f32`); in bf16 by :func:`check_bf16_spread`.  K8s on the
    last layer and K8 on layer 0, from the kernel's saved inputs: dx and each
    of the 12 gradients at cosine > 0.999 on its own.  Returns the errors by
    (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut

    errs = {}
    f32 = x2d.dtype == torch.float32
    N, D = x2d.shape[0] // S, x2d.shape[1]
    gen = torch.Generator(device=dev).manual_seed(9)

    def at(t):
        return [a[t % a.shape[0]] for a in params]

    for rate in (0.0, 0.5):
        seed = 97531
        out_k, xs_k = ue.u2gnn_encoder_train(x2d, params, S, Tn, rate, seed)
        out_p, xs_p = ue.u2gnn_encoder_train_plain(x2d, params, S, Tn, rate,
                                                   seed)
        pairs = [("out", out_k, out_p)]
        if Tn > 1:
            pairs.append(("saved input", xs_k[-1].float(), xs_p[-1].float()))
        for what, a, b in pairs:
            ref64 = ((lambda: plain_f64(x2d, params, S, Tn, rate, seed))
                     if what == "out" else
                     (lambda: plain_f64(x2d, params, S, Tn - 1, rate, seed,
                                        slot0=False)))
            e = check_forward(f"{label} rate {rate}: K4t {what}", a, b, ref64,
                              bf16=not f32)
            errs[("K4t", rate)] = max(errs.get(("K4t", rate), (0.0, 0.0)), e)
        t3 = Tn - 1
        x3 = (x2d if Tn == 1 else xs_k[t3 - 1]).view(N, S, D)
        g3 = torch.randn(N, D, device=dev, generator=gen)
        dx_k, gk = ut.slot0_recompute_backward(x3, g3, params, t3, rate, seed)
        dx_p, gp = ut.layer_recompute_backward_plain(
            x3, g3, at(t3), layer=t3, rate=rate, seed=seed, mm=x2d.dtype,
            slot0=True)
        errs[("K8s", rate)], c8s = check_grads(
            f"{label} rate {rate}: K8s", dx_k, gk, dx_p, gp)
        line = (f"# check {label} rate {rate}: K4t max|err| "
                f"{errs[('K4t', rate)][0]:.3e} ({errs[('K4t', rate)][1]:.1e});"
                f" K8s worst leaf {errs[('K8s', rate)][0]:.3e} "
                f"({errs[('K8s', rate)][1]:.1e}, cos {c8s:.6f})")
        if Tn > 1:
            x0 = x2d.view(N, S, D)
            g0 = torch.randn(N, S, D, device=dev, generator=gen)
            dx_k, gk = ut.layer_recompute_backward(x0, g0, params, 0, rate,
                                                   seed)
            dx_p, gp = ut.layer_recompute_backward_plain(
                x0, g0, at(0), layer=0, rate=rate, seed=seed, mm=x2d.dtype,
                slot0=False)
            errs[("K8", rate)], c8 = check_grads(
                f"{label} rate {rate}: K8", dx_k, gk, dx_p, gp)
            line += (f"; K8 worst leaf {errs[('K8', rate)][0]:.3e} "
                     f"({errs[('K8', rate)][1]:.1e}, cos {c8:.6f})")
        print(line, flush=True)
    return wide_names(errs, D)


def check_saved_inputs_are_layers(label, params, x2d, S, Tn, dev):
    """K4tw's saved layer inputs against K9w, at rate 0 and 0.5: xs[t], the
    input of layer t + 1, equals K9w applied at timestep t to layer t's
    input, bit for bit (the same layer code on the same dropout streams,
    whatever the block's rows).  With bf16 rows for t = 0 only: K4tw carries
    a layer's output on to the next in float32 and saves it rounded, while
    K9w starts from the rounded copy."""
    import torch

    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue

    for rate in (0.0, 0.5):
        seed = 20240917
        _, xs = ue.u2gnn_encoder_train(x2d, params, S, Tn, rate, seed)
        steps = Tn - 1 if x2d.dtype == torch.float32 else min(1, Tn - 1)
        for t in range(steps):
            p = [a[t % a.shape[0]] for a in params]
            got = el.encoder_layer_forward(x2d if t == 0 else xs[t - 1], p, S,
                                           rate, seed, t)
            if not torch.equal(got, xs[t]):
                fail(f"{label} rate {rate}: K4tw's saved input of layer "
                     f"{t + 1} differs from K9w at timestep {t}: max|diff| "
                     f"{max_err([got.float()], [xs[t].float()])[0]}")
        print(f"# check {label} rate {rate}: K4tw's saved inputs of layers "
              f"1..{steps} equal K9w's layers bit for bit", flush=True)


def wide_names(errs, D):
    """The errors by kernel under the names of the kernels that ran: past
    D=32 the wrappers launch K4tw, K8w, K8ws, K9w and K10w."""
    if D <= 32:
        return errs
    names = {"K4t": "K4tw", "K8": "K8w", "K8s": "K8ws", "K9": "K9w",
             "K10": "K10w"}
    return {(names[k[0]],) + k[1:]: v for k, v in errs.items()}


def check_two_pass_vs_fused(label, si, params, S, Tn, dev):
    """At one U2GNN layer on a codebook dataset, the two-pass path (K7, the
    feature gather, K4t, K8/K8s) against the fused path (K1-K3) on the same
    seed, at rate 0 and 0.5: K7's ids are the table entries K1 draws, the
    outputs agree within 2e-2 (both run bf16 products over bf16 codebook
    rows, the same layer code) and each of the 12 gradient leaves at cosine
    > 0.99.  Not 0.999: K2/K3 read residuals that K1 computed from each
    layer's unrounded input, while K8 recomputes the layer from the bf16
    input K4t saved, as the TPU's kernel 5 does: an extra rounding, which
    on some leaves puts the two-pass gradients farther from float32 than
    the fused ones (ROADMAP Queue C).  Prints both paths'
    lowest leaf cosine against the two-pass path in float32 (K4t, K8/K8s
    with float32 rows and products)."""
    import torch

    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops.u2gnn_train import (
        u2gnn_train_encoder)
    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        sample_neighbors)

    tag_rows, deg, self_tag, codebook = si
    N, C = tag_rows.shape[0], codebook.shape[0]
    D = codebook.shape[1]
    # a global neighbor table whose nodes carry the tags: node v = row v
    gen = torch.Generator(device=dev).manual_seed(11)
    tags = torch.randint(0, C, (N,), device=dev, generator=gen,
                         dtype=torch.int32)
    table = torch.randint(0, N, (N, 128), device=dev, generator=gen,
                          dtype=torch.int32)
    si_f = (tags[table.long()], deg, tags, codebook)
    x_global = codebook[tags.long()].to(torch.bfloat16)
    gidx = torch.arange(N, dtype=torch.int32, device=dev)
    w = torch.randn(N, D, device=dev, generator=gen)
    for rate in (0.0, 0.5):
        seed = 13579
        draws = se.sampled_forward(*si_f, params, S, Tn, rate, seed)[1][
            "draws"]
        neigh = sample_neighbors(seed, table, deg, gidx, S - 1)
        if not (torch.equal(neigh[:, 1:].long(), table.long().gather(1, draws))
                and torch.equal(neigh[:, 0], gidx)):
            fail(f"{label} rate {rate}: K7 and K1 draw different neighbors")
        rows = x_global[neigh.long()].reshape(N * S, D)
        outs, grads = [], []
        for run in ("fused", "two-pass", "two-pass float32"):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            if run == "fused":
                out = se.sampled_encoder(*si_f, ps, S, Tn, rate, seed)
            else:
                x = rows if run == "two-pass" else rows.float()
                out = u2gnn_train_encoder(x, ps, S, Tn, rate, seed)
            grads.append(torch.autograd.grad((out * w).sum(), ps))
            outs.append(out.detach())
        e = max_err([outs[1]], [outs[0]])
        if not torch.allclose(outs[1], outs[0], rtol=2e-2, atol=2e-2):
            fail(f"{label} rate {rate}: two-pass vs fused output max err "
                 f"{e[0]}")
        low = {"vs": 1.0, "fused-f32": 1.0, "two-pass-f32": 1.0}
        for leaf, a, b, r in zip(LEAVES[1:], grads[1], grads[0], grads[2]):
            c = cosine(a, b)
            if not c > 0.99:
                fail(f"{label} rate {rate}: two-pass vs fused {leaf} "
                     f"cosine {c}")
            low["vs"] = min(low["vs"], c)
            low["fused-f32"] = min(low["fused-f32"], cosine(b, r))
            low["two-pass-f32"] = min(low["two-pass-f32"], cosine(a, r))
        print(f"# check {label} rate {rate}: two-pass (K7, K4t, K8/K8s) vs "
              f"fused (K1-K3): draws equal, output max|diff| {e[0]:.3e} "
              f"({e[1]:.1e}), lowest gradient leaf cosine {low['vs']:.6f}; "
              f"against the two-pass path in float32: fused "
              f"{low['fused-f32']:.6f}, two-pass {low['two-pass-f32']:.6f}",
              flush=True)


def check_forward(label, out_k, out_p, ref64, bf16: bool) -> tuple:
    """A forward kernel against its plain version on the same inputs: with
    float32 rows and products within 1e-4 (rtol and atol), or within twice
    the plain version's own float32 error of a float64 reference ``ref64()``
    where one is given (as :func:`check_k4_f32`); with bf16 ones by
    :func:`check_bf16_spread`.  Returns (max |err|, relative)."""
    import torch

    if bf16:
        return check_bf16_spread(label, out_k.float(), out_p.float())
    if not torch.allclose(out_k, out_p, rtol=1e-4, atol=1e-4):
        if ref64 is None:
            fail(f"{label}: float32 max err {max_err([out_k], [out_p])[0]}")
        ref = ref64()
        ek = float((out_k.double() - ref).abs().max())
        ep = float((out_p.double() - ref).abs().max())
        if not ek <= 2.0 * ep:
            fail(f"{label}: float32 max err {max_err([out_k], [out_p])[0]} "
                 f"(float64 reference: kernel {ek}, plain {ep})")
    return max_err([out_k], [out_p])


def check_encoder_layer(label, params, x2d, S, dev, layer=2):
    """K9 and K10 (K9w and K10w past D=32) against their plain versions at
    rate 0 and 0.5 on one layer's tensors, timestep ``layer``'s dropout
    streams, rows and products in ``x2d``'s dtype: the forward (every row)
    by :func:`check_forward`, K10's dx and each of the 12 gradients at
    cosine > 0.999 on its own.  Returns the errors by (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops.attention import layer_forward

    errs = {}
    N, D = x2d.shape[0] // S, x2d.shape[1]
    gen = torch.Generator(device=dev).manual_seed(12)
    p = [a[0] for a in params]

    for rate in (0.0, 0.5):
        seed = 424242

        def ref64():
            return layer_forward(
                x2d.double().view(N, S, D), [a.double() for a in p],
                layer=layer, rate=rate, seed=seed, mm=torch.float32,
                slot0=False)[0].reshape(N * S, D)

        out_k = el.encoder_layer_forward(x2d, p, S, rate, seed, layer)
        out_p = el.encoder_layer_forward_plain(x2d, p, S, rate, seed, layer)
        torch.cuda.synchronize()
        errs[("K9", rate)] = check_forward(
            f"{label} rate {rate}: K9", out_k, out_p, ref64,
            bf16=x2d.dtype == torch.bfloat16)
        g = torch.randn(N * S, D, device=dev, generator=gen)
        dx_k, gk = el.encoder_layer_backward(x2d, g, p, S, rate, seed, layer)
        dx_p, gp = el.encoder_layer_backward_plain(x2d, g, p, S, rate, seed,
                                                   layer)
        errs[("K10", rate)], c10 = check_grads(
            f"{label} rate {rate}: K10", dx_k, gk, dx_p, gp)
        print(f"# check {label} rate {rate}: K9 max|err| "
              f"{errs[('K9', rate)][0]:.3e} ({errs[('K9', rate)][1]:.1e}); "
              f"K10 worst leaf {errs[('K10', rate)][0]:.3e} "
              f"({errs[('K10', rate)][1]:.1e}, cos {c10:.6f})", flush=True)
    return wide_names(errs, D)


def check_ffn(label, M, D, F, dtype, dev, layer=1):
    """K11 and K12 against their plain versions over ``M`` random rows of
    ``D`` features (``dtype`` rows and products), FFN width ``F``, at rate 0
    and 0.5: the forward by :func:`check_forward`, K12's dx and each of the
    six gradients at cosine > 0.999 on its own.  Returns the errors by
    (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import ffn

    rng = np.random.default_rng(D)

    def t(shape, scale=0.3, shift=0.0):
        return torch.tensor(rng.standard_normal(shape) * scale + shift,
                            dtype=torch.float32, device=dev)

    x = t((M, D), 1.0).to(dtype)
    p = [t((D, F)), t((F,)), t((F, D)), t((D,)), t((D,), 0.3, 1.0), t((D,))]
    g = t((M, D), 1.0)
    errs = {}
    for rate in (0.0, 0.5):
        seed = 8642

        def ref64():
            xd = x.double()
            h = torch.relu(xd @ p[0].double() + p[1].double())
            h = ffn.dropout(h, rate, seed, layer, ffn.HIDDEN_SITE)
            y = ffn.dropout(h @ p[2].double() + p[3].double(), rate, seed,
                            layer, ffn.OUT_SITE)
            u = xd + y
            mu = u.mean(-1, keepdim=True)
            var = ((u - mu) ** 2).mean(-1, keepdim=True)
            return ((u - mu) / torch.sqrt(var + 1e-5) * p[4].double()
                    + p[5].double())

        out_k = ffn.ffn_forward(x, *p, rate=rate, seed=seed, layer=layer)
        out_p = ffn.ffn_forward_plain(x, *p, rate=rate, seed=seed,
                                      layer=layer)
        torch.cuda.synchronize()
        errs[("K11", rate)] = check_forward(
            f"{label} rate {rate}: K11", out_k, out_p, ref64,
            bf16=dtype == torch.bfloat16)
        dx_k, gk = ffn.ffn_backward(x, g, *p, rate=rate, seed=seed,
                                    layer=layer)
        dx_p, gp = ffn.ffn_backward_plain(x, g, *p, rate=rate, seed=seed,
                                          layer=layer)
        errs[("K12", rate)], c12 = check_grads(
            f"{label} rate {rate}: K12", dx_k, gk, dx_p, gp, FFN_LEAVES)
        print(f"# check {label} rate {rate}: K11 max|err| "
              f"{errs[('K11', rate)][0]:.3e} ({errs[('K11', rate)][1]:.1e}); "
              f"K12 worst leaf {errs[('K12', rate)][0]:.3e} "
              f"({errs[('K12', rate)][1]:.1e}, cos {c12:.6f})", flush=True)
    return errs


# SASS opcodes by the unit that runs them (cuobjdump -sass of the built
# libraries): 32-bit integer instructions (the ALU and IMAD), float32 ones,
# shared-memory loads
INT32_OPS = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
             "SHR", "ISETP", "IMAD", "IMUL", "IMUL32I", "IMAD32I", "LEA",
             "PRMT", "SEL", "IABS", "IMNMX", "ICMP", "BFE", "BFI", "POPC",
             "FLO", "BREV", "IDP", "SGXT", "BMSK", "VIADD", "VIMNMX"}
FP32_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "FCHK",
            "MUFU", "F2F", "F2FP", "F2I", "I2F", "FRND", "FADD32I", "FMUL32I",
            "FFMA32I"}
LDS_OPS = {"LDS", "LDSM"}
# the multipliers of gt_mix32 (common.cuh), the second also as the signed
# immediate SASS may print: one of each a mix, two mixes a dropout word
HASH_CONSTANTS = ("0x7feb352d", "0x846ca68b", "-0x7b935975")


def sass_functions(lib_path: str) -> dict:
    """{mangled name: [(address, opcode, text, branch target)]} of a built
    library, from ``cuobjdump -sass``: the target an address (None but for
    a branch)."""
    import re

    from graph_transformer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, cur, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            labels, pending = {}, []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for name in pending:
            labels[name] = addr
        pending = []
        words = [w for w in text.split() if not w.startswith("@")]
        cur.append((addr, words[0] if words else "", text, labels))
    out = {}
    for name, insts in funcs.items():
        rows = []
        for addr, op, text, labels in insts:
            target = None
            if op.startswith("BRA"):
                m = re.search(r"\(\s*(\.L_x_\d+)\s*\)", text)
                if m and m.group(1) in labels:
                    target = labels[m.group(1)]
                else:
                    m = re.search(r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)", text)
                    target = int(m.group(1), 16) if m else None
            rows.append((addr, op, text, target))
        out[name] = rows
    return out


def hash_loops(insts) -> list:
    """The innermost loops (a branch back to an earlier address) of one
    function that draw dropout words: for each, its instructions by unit
    and per word (elements: the loop's gt_mix32 multipliers / 4)."""
    loops = [(t, a) for a, op, _, t in insts
             if op.startswith("BRA") and t is not None and t <= a]
    body = {}
    for lo, hi in loops:
        body[(lo, hi)] = [(op, text) for a, op, text, _ in insts
                          if lo <= a <= hi]
    hashed = {k: v for k, v in body.items()
              if any(c in t.lower() for _, t in v for c in HASH_CONSTANTS)}
    inner = [k for k in hashed if not any(
        o != k and k[0] <= o[0] and o[1] <= k[1] for o in hashed)]
    out = []
    for k in sorted(inner):
        v = hashed[k]
        words = sum(t.lower().count(c) for _, t in v
                    for c in HASH_CONSTANTS) / 4
        base = [op.split(".")[0] for op, _ in v]
        n = {"int32": sum(b in INT32_OPS for b in base),
             "fp32": sum(b in FP32_OPS for b in base),
             "lds": sum(b in LDS_OPS for b in base),
             "hmma": sum(b == "HMMA" for b in base)}
        n["other"] = len(base) - sum(n.values())
        out.append({"span": [hex(k[0]), hex(k[1])], "words": words,
                    "instructions": len(base), **n,
                    "bf16_mma": any("HMMA.16816" in t for _, t in v),
                    "divides": any(b == "MUFU" and "RCP" in t
                                   for b, (_, t) in zip(base, v)),
                    "per_word": {u: n[u] / words for u in n} if words
                    else {}})
    return out


def sm_clock_mhz(fn, seconds: float = 1.5) -> float:
    """The SM clock ``nvidia-smi`` reads while ``fn`` runs back to back on
    the card (the median of its readings every 50 ms)."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    mhz = sorted(float(x) for x in out.split() if x.strip().isdigit())
    if not mhz:
        fail("nvidia-smi read no SM clock")
    return mhz[len(mhz) // 2]


def hash_floor(si, params, S, Tn, seed, dev) -> dict:
    """K1 and K13 at the bench's rows (its training batch ``si``): device ms
    a launch at rate 0.5 and at rate 0, the SASS of the layer's FFN loop on
    that path per dropout word (rate 0.5 takes GT_HID_SCALED, of the
    innermost loops of gt_encoder_fwd_kernel<4, false> that draw words with
    bf16 mma.sync the one of the fewest instructions a word), and the
    integer floor:
    INT32 instructions a word x the launch's words (one a hidden element:
    ((T-1) N S + N) F) / (64 lanes x 132 SMs x the SM clock ``nvidia-smi``
    reads while the kernel runs), with the share of it the kernel reaches."""
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se

    N, F = si[0].shape[0], params[6].shape[2]
    words = ((Tn - 1) * N * S + N) * F
    fwd = ("gt_encoder_fwd_kernel",)
    out = {}
    for key, src, call in (
            ("K1", "sampled_fwd", lambda r: se.sampled_forward(
                *si, params, S, Tn, r, seed)),
            ("K13", "fused_sampled_fwd", lambda r: fs.fused_sampled_forward(
                *si, params, S, Tn, r, seed))):
        funcs = sass_functions(_build.lib_path(src))
        name = next(f for f in funcs if "gt_encoder_fwd_kernelILi4ELb0EE" in f)
        loops = [lp for lp in hash_loops(funcs[name]) if lp["bf16_mma"]]
        if not loops:
            fail(f"{key}: no bf16 dropout loop in the SASS of {name}")
        lp = min(loops, key=lambda lp: lp["instructions"] / lp["words"])
        ms = {r: device_ms(lambda: call(r), 10, fwd) for r in (0.5, 0.0)}
        mhz = sm_clock_mhz(lambda: call(0.5))
        floor_ms = lp["per_word"]["int32"] * words / (64 * 132 * mhz * 1e6) \
            * 1e3
        out[key] = dict(ms_rate_05=ms[0.5], ms_rate_0=ms[0.0],
                        mask_share=1.0 - ms[0.0] / ms[0.5], words=words,
                        sass_loop=lp, sm_clock_mhz=mhz, int32_floor_ms=floor_ms,
                        share_of_floor=floor_ms / ms[0.5])
        pw = lp["per_word"]
        print(f"# hash floor {key} at {N} x S={S}, D={si[3].shape[1]}, F={F},"
              f" T={Tn}: {ms[0.5]:.4f} ms a launch at rate 0.5, "
              f"{ms[0.0]:.4f} at rate 0 (the mask {out[key]['mask_share']:.3f}"
              f" of it); the FFN loop's SASS a word: {pw['int32']:.2f} INT32, "
              f"{pw['fp32']:.2f} FP32, {pw['lds']:.2f} LDS, {pw['hmma']:.3f} "
              f"HMMA, {pw['other']:.2f} other ({lp['instructions']} "
              f"instructions, {lp['words']:g} words an iteration); {words:,} "
              f"words at {mhz:.0f} MHz: integer floor {floor_ms:.4f} ms, "
              f"reached {out[key]['share_of_floor']:.3f}", flush=True)
    return out


def check_per_layer_vs_whole(label, params, x2d, S, Tn):
    """T launches of K9 at rate 0 (slot 0 of the last layer's output)
    against K4 on the same float32 rows and stacked parameters, within 1e-4
    or :func:`check_k4_f32`'s float64 rule: the per-layer and the
    whole-encoder kernels compute one encoder."""
    import torch

    from graph_transformer_tpu_torch.ops.encoder_layer import (
        encoder_layer_forward)
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import u2gnn_encoder

    x32 = x2d.to(torch.float32)
    N, D = x32.shape[0] // S, x32.shape[1]
    h = x32
    for t in range(Tn):
        h = encoder_layer_forward(h, [a[t % a.shape[0]] for a in params], S,
                                  layer=t)
    per_layer = h.view(N, S, D)[:, 0]
    whole = u2gnn_encoder(x32, params, S, Tn)
    torch.cuda.synchronize()
    e = check_forward(f"{label}: {Tn} x K9 vs K4", per_layer, whole,
                      lambda: plain_f64(x32, params, S, Tn, 0.0, None),
                      bf16=False)
    print(f"# check {label}: {Tn} launches of K9 (slot 0) vs K4, float32: "
          f"max|diff| {e[0]:.3e} ({e[1]:.1e})", flush=True)
    return e


def k13_plain_grads(xs, params, S, Tn, rate, seed, w):
    """The plain recompute backward (the plain K8s, then K8 per earlier
    layer) from the bf16 saved layer inputs ``xs`` [T, N·S, D] of a K13
    forward, on the card: the 12 stacked parameter gradients of
    sum(out * w)."""
    import torch

    from graph_transformer_tpu_torch.ops.sampled_encoder import walk_backward
    from graph_transformer_tpu_torch.ops.u2gnn_train import (
        layer_recompute_backward_plain)

    N, D = w.shape

    def layer_bwd(t, g):
        last = t == Tn - 1
        return layer_recompute_backward_plain(
            xs[t].view(N, S, D), g if last else g.view(N, S, D),
            [a[t % a.shape[0]] for a in params], layer=t, rate=rate,
            seed=seed, mm=torch.bfloat16, slot0=last)

    return walk_backward(w, params, Tn, layer_bwd)[1]


def check_fused_sampled(label, si, params, S, Tn, dev):
    """K13 at rate 0 and 0.5 with one seed: against its plain version
    (equal draws; the output within 2e-2 at D <= 32, as K1's check, and by
    :func:`check_bf16_spread` past it; every gradient leaf of K13 with its
    recompute backward at cosine > 0.999 against the plain backward's on the
    same bf16 saved inputs, as :func:`check_two_pass` feeds K8: past D=32
    the bf16 forwards of kernel and plain version spread apart, ROADMAP
    Queue C, and at D=68, rate 0.5, gradients each taken from its own
    forward agree only at cosine 0.9988 on b_out);
    against the two-pass path (K4t/K4tw and K8/K8w) on the bf16 codebook
    rows of K13's draws, which computes the same function with the same
    code: output and every gradient leaf bit for bit; and against K1
    (D <= 32) or K5 (past): the same draws, output and saved layer inputs
    bit for bit, every gradient leaf against K1-K3's or K5/K6's at cosine
    > 0.98.  Not 0.99: K2/K3 and K6 read residuals of each layer's
    unrounded input, K13's backward recomputes from the bf16 saved input,
    and that extra rounding put the MUTAG-like case's c1 leaf at 0.9899 at
    rate 0.5 on the H100 (:func:`check_two_pass_vs_fused` reads
    0.9925-0.9952 on another seed; ROADMAP Queue C).  Returns the errors by
    (kernel, rate), the kernel named K13w past D=32."""
    import torch

    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops.u2gnn_train import (
        u2gnn_train_encoder)

    N, D = si[0].shape[0], si[3].shape[1]
    wide = D > 32
    name, other = ("K13w", "K5") if wide else ("K13", "K1")
    fwd, enc = ((st.stored_forward, st.stored_encoder) if wide
                else (se.sampled_forward, se.sampled_encoder))
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(14))
    errs = {}
    for rate in (0.0, 0.5):
        seed = 1357911
        out_k, xs_k, draws_k = fs.fused_sampled_forward(*si, params, S, Tn,
                                                        rate, seed)
        out_p, _, draws_p = fs.fused_sampled_forward_plain(*si, params, S, Tn,
                                                           rate, seed)
        out_o, res_o = fwd(*si, params, S, Tn, rate, seed)
        torch.cuda.synchronize()
        if not torch.equal(draws_k, draws_p):
            fail(f"{label} rate {rate}: {name} sampled indices differ")
        if wide:
            e = check_bf16_spread(f"{label} rate {rate}: {name}", out_k, out_p)
        else:
            e = max_err([out_k], [out_p])
            if not torch.allclose(out_k, out_p, rtol=2e-2, atol=2e-2):
                fail(f"{label} rate {rate}: {name} forward max err {e[0]}")
        errs[(name, rate)] = e
        xs_o = torch.stack(res_o["xs"]).reshape(Tn, N * S, D)
        if not (torch.equal(draws_k, res_o["draws"])
                and torch.equal(out_k, out_o) and torch.equal(xs_k, xs_o)):
            fail(f"{label} rate {rate}: {name} is not bit-equal to {other} "
                 f"(output max|diff| {max_err([out_k], [out_o])[0]})")
        tags = torch.cat([si[2].long()[:, None],
                          si[0].long().gather(1, draws_k)], 1)
        rows = si[3][tags].to(torch.bfloat16).reshape(N * S, D)
        outs, grads = [], []
        for f in (fs.fused_sampled_encoder, enc, None):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = (u2gnn_train_encoder(rows, ps, S, Tn, rate, seed) if f is None
                   else f(*si, ps, S, Tn, rate, seed))
            grads.append(torch.autograd.grad((out * w).sum(), ps))
            outs.append(out.detach())
        if not (torch.equal(outs[0], outs[2])
                and all(torch.equal(a, b) for a, b in zip(grads[0],
                                                          grads[2]))):
            fail(f"{label} rate {rate}: {name} differs from the two-pass "
                 f"path: output max|diff| {max_err([outs[0]], [outs[2]])[0]}"
                 f", gradients {max_err(grads[0], grads[2])[0]}")
        gp = k13_plain_grads(xs_k, params, S, Tn, rate, seed, w)
        low = {"plain": 1.0, other: 1.0}
        for leaf, a, b, o in zip(LEAVES[1:], grads[0], gp, grads[1]):
            c, co = cosine(a, b), cosine(a, o)
            if not (c > 0.999 and co > 0.98):
                fail(f"{label} rate {rate}: {name} {leaf} gradient cosine "
                     f"{c} to the plain version's, {co} to {other}'s path")
            low = {"plain": min(low["plain"], c), other: min(low[other], co)}
        print(f"# check {label} rate {rate}: {name} max|err| {e[0]:.3e} "
              f"({e[1]:.1e}, draws equal), bit-equal to {other} (output, "
              f"draws, saved inputs) and to the two-pass path (output, "
              f"gradients); lowest gradient leaf cosine {low['plain']:.6f} "
              f"to the plain version, {low[other]:.6f} to {other}'s path",
              flush=True)
    return errs


def leaf_close(label, a, b) -> float:
    """Float32 gradients of one function by two routes: max |a - b| within
    1e-4 of max |b| (``scripts/bench_hybrid.py:62-70`` holds JAX's mega
    backward to its hybrid chain so); returns the relative error."""
    err = float((a - b).abs().max())
    ref = float(b.abs().max())
    if not err <= 1e-4 * max(ref, 1e-30):
        fail(f"{label}: max|diff| {err}, max|ref| {ref}")
    return err / max(ref, 1e-30)


def check_mega(label, params, x2d, S, Tn, dev):
    """K14 (K14w past D=32) at rate 0 and 0.5 on K4t's (K4tw's) saved
    inputs: against the K8 chain on the same inputs (K8s, then K8 per
    earlier layer, summed by the host) — in float32 dx and each leaf within
    1e-4 of its own max, in bf16 each at cosine > 0.999, and whether they
    are equal bit for bit (the kernel replays the chain's sums in its
    order) — and against its plain version (dx and each leaf at cosine >
    0.999).  Returns the errors by (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut

    N, D = x2d.shape[0] // S, x2d.shape[1]
    name = "K14w" if D > 32 else "K14"
    f32 = x2d.dtype == torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)
    errs = {}
    for rate in (0.0, 0.5):
        seed = 86420
        _, xs = ue.u2gnn_encoder_train(x2d, params, S, Tn, rate, seed)
        g = torch.randn(N, D, device=dev, generator=gen)
        dx_k, gk = ut.mega_recompute_backward(x2d, xs, g, params, S, Tn,
                                              rate, seed)
        dx_c, gc = ut.chain_backward(x2d, xs, g, params, S, Tn, rate, seed)
        dx_p, gp = ut.mega_recompute_backward_plain(x2d, xs, g, params, S,
                                                    Tn, rate, seed)
        torch.cuda.synchronize()
        equal = torch.equal(dx_k, dx_c) and all(
            torch.equal(a, b) for a, b in zip(gk, gc))
        worst = 0.0
        for leaf, a, b in zip(LEAVES, (dx_k,) + tuple(gk),
                              (dx_c,) + tuple(gc)):
            if f32:
                worst = max(worst, leaf_close(
                    f"{label} rate {rate}: {name} vs the K8 chain {leaf}", a,
                    b))
            elif float(b.abs().max()) > 0.0:
                c = cosine(a, b)
                if not c > 0.999:
                    fail(f"{label} rate {rate}: {name} vs the K8 chain {leaf}"
                         f" cosine {c}")
                worst = max(worst, 1.0 - c)
        errs[(name, rate)], low = check_grads(
            f"{label} rate {rate}: {name}", dx_k, gk, dx_p, gp)
        print(f"# check {label} rate {rate}: {name} vs the K8 chain: "
              + ("equal bit for bit" if equal else
                 (f"worst leaf {worst:.2e} of its max" if f32 else
                  f"lowest leaf cosine {1.0 - worst:.6f}"))
              + f"; vs plain worst leaf {errs[(name, rate)][0]:.3e} "
              f"({errs[(name, rate)][1]:.1e}, cos {low:.6f})", flush=True)
    return errs


def check_bit_equal_paths(label, si, params, S, Tn, dev):
    """The bit-for-bit relations of the thread-per-row forward layer (D <=
    32) at rate 0 and 0.5, with one seed: K13 against K1 (draws, output,
    saved layer inputs), K13 with its K8 chain against the two-pass path
    (K4t and the K8 chain) on the bf16 codebook rows of K13's draws (output
    and every gradient leaf), K15 fed K1's x0 rows against K1 (output,
    residuals) and K16 against K15.  What :func:`check_fused_sampled` and
    :func:`check_folded` hold bit for bit, without their comparisons with
    the plain versions, for row counts where those run long."""
    import torch

    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops.u2gnn_train import (
        u2gnn_train_encoder)

    N, D = si[0].shape[0], si[3].shape[1]
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(20))
    for rate in (0.0, 0.5):
        seed = 1357911
        out13, xs13, draws13 = fs.fused_sampled_forward(*si, params, S, Tn,
                                                        rate, seed)
        out1, res1 = se.sampled_forward(*si, params, S, Tn, rate, seed)
        xs1 = torch.stack(res1["xs"]).reshape(Tn, N * S, D)
        if not (torch.equal(draws13, res1["draws"])
                and torch.equal(out13, out1) and torch.equal(xs13, xs1)):
            fail(f"{label} rate {rate}: K13 is not bit-equal to K1 (output "
                 f"max|diff| {max_err([out13], [out1])[0]})")
        tags = torch.cat([si[2].long()[:, None],
                          si[0].long().gather(1, draws13)], 1)
        rows = si[3][tags].to(torch.bfloat16).reshape(N * S, D)
        outs, grads = [], []
        for two_pass in (False, True):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = (u2gnn_train_encoder(rows, ps, S, Tn, rate, seed) if two_pass
                   else fs.fused_sampled_encoder(*si, ps, S, Tn, rate, seed))
            grads.append(torch.autograd.grad((out * w).sum(), ps))
            outs.append(out.detach())
        if not (torch.equal(outs[0], outs[1])
                and all(torch.equal(a, b) for a, b in zip(*grads))):
            fail(f"{label} rate {rate}: K13 differs from the two-pass path: "
                 f"output max|diff| {max_err([outs[0]], [outs[1]])[0]}, "
                 f"gradients {max_err(grads[0], grads[1])[0]}")
        x0 = res1["xs"][0].reshape(N * S, D)
        out15, res15 = fe.folded_stored_forward(x0, params, S, Tn, rate, seed)
        out16 = fe.folded_forward(x0, params, S, Tn, rate, seed)
        if not (torch.equal(out15, out1) and all(
                torch.equal(a, b) for k in ("xs", "qkv", "attn", "strip")
                for a, b in zip(res15[k], res1[k]))):
            fail(f"{label} rate {rate}: K15 is not bit-equal to K1 (output "
                 f"max|diff| {max_err([out15], [out1])[0]})")
        if not torch.equal(out16, out15):
            fail(f"{label} rate {rate}: K16 is not bit-equal to K15")
        print(f"# check {label} rate {rate}: K13 bit-equal to K1 and to the "
              f"two-pass path, K15 to K1, K16 to K15", flush=True)


def check_folded(label, si, params, S, Tn, dev):
    """K15 and K16 at rate 0 and 0.5, fed K1's own bf16 x0 rows and seed:
    K15's output and residuals equal K1's bit for bit, K16's output K15's,
    and the gradients of K15 with K3 and (T-1)xK2 K1-K3's; each against its
    plain version within 2e-2 (bf16, as K1).  Returns the errors by
    (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import sampled_encoder as se

    N, D = si[0].shape[0], si[3].shape[1]
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(16))
    errs = {}
    for rate in (0.0, 0.5):
        seed = 97531
        out1, res1 = se.sampled_forward(*si, params, S, Tn, rate, seed)
        x0 = res1["xs"][0].reshape(N * S, D)
        out15, res15 = fe.folded_stored_forward(x0, params, S, Tn, rate, seed)
        out16 = fe.folded_forward(x0, params, S, Tn, rate, seed)
        outp, _ = fe.folded_stored_forward_plain(x0, params, S, Tn, rate,
                                                 seed)
        torch.cuda.synchronize()
        if not (torch.equal(out15, out1) and all(
                torch.equal(a, b) for k in ("xs", "qkv", "attn", "strip")
                for a, b in zip(res15[k], res1[k]))):
            fail(f"{label} rate {rate}: K15 is not bit-equal to K1 (output "
                 f"max|diff| {max_err([out15], [out1])[0]})")
        if not torch.equal(out16, out15):
            fail(f"{label} rate {rate}: K16 is not bit-equal to K15")
        for k, o in (("K15", out15), ("K16", out16)):
            errs[(k, rate)] = max_err([o], [outp])
            if not torch.allclose(o, outp, rtol=2e-2, atol=2e-2):
                fail(f"{label} rate {rate}: {k} forward max err "
                     f"{errs[(k, rate)][0]}")
        grads = []
        for run in ("k1", "folded"):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = (se.sampled_encoder(*si, ps, S, Tn, rate, seed)
                   if run == "k1" else
                   fe.folded_u2gnn_encoder_grad(x0, ps, S, Tn, rate, seed))
            grads.append(torch.autograd.grad((out * w).sum(), ps))
        if not all(torch.equal(a, b) for a, b in zip(*grads)):
            fail(f"{label} rate {rate}: K15 + K3/K2 gradients differ from "
                 f"K1-K3's: max|diff| {max_err(grads[1], grads[0])[0]}")
        print(f"# check {label} rate {rate}: K15 bit-equal to K1 (output, "
              f"residuals) and its gradients to K1-K3's, K16 to K15; vs "
              f"plain K15 {errs[('K15', rate)][0]:.3e} "
              f"({errs[('K15', rate)][1]:.1e})", flush=True)
    return errs


def check_stored_rows(label, si, params, S, Tn, dev):
    """K17 at rate 0 and 0.5, fed K5's own bf16 x0 rows and seed.  Past
    D=32 K17 runs K5's layer: its output and residuals equal K5's bit for
    bit, and the gradients of K17 with K6 K5/K6's.  Up to D=32 it runs K1's
    thread-per-row layer, whose LayerNorm statistics and softmax denominator
    are sums in row order where K5's warp per row sums them by butterfly;
    the two orders round apart in the last bit and the next layer's bf16
    operands carry that on.  There the first step agrees bit for bit (layer
    0's q/k/v, the products of the same inputs in the same order), K17
    equals K15 (the same layer code, without the hidden) bit for bit in
    output and every residual K15 writes, and against K5 the output and each
    residual pass :func:`check_bf16_spread` and the gradients with K6 agree
    leaf by leaf at cosine > 0.999.  Against its plain version by
    :func:`check_bf16_spread`, and with K6 every gradient leaf (dx too)
    against the plain backward on its residuals at cosine > 0.999.  Returns
    the errors by (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import stored_encoder as st

    N, D = si[0].shape[0], si[3].shape[1]
    narrow = D <= 32
    kinds = ("xs", "qkv", "attn", "strip", "h")
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(17))
    errs = {}
    for rate in (0.0, 0.5):
        seed = 75319
        out5, res5 = st.stored_forward(*si, params, S, Tn, rate, seed)
        x0 = res5["xs"][0].reshape(N * S, D)
        out17, res17 = st.stored_rows_forward(x0, params, S, Tn, rate, seed)
        outp, _ = st.stored_rows_forward_plain(x0, params, S, Tn, rate, seed)
        torch.cuda.synchronize()
        same5 = torch.equal(out17, out5) and all(
            torch.equal(a, b) for k in kinds
            for a, b in zip(res17[k], res5[k]))
        if narrow:
            out15, res15 = fe.folded_stored_forward(x0, params, S, Tn, rate,
                                                    seed)
            if not (torch.equal(out17, out15) and all(
                    torch.equal(a, b) for k in res15
                    for a, b in zip(res17[k], res15[k]))):
                fail(f"{label} rate {rate}: K17 is not bit-equal to K15 "
                     f"(output max|diff| {max_err([out17], [out15])[0]})")
            if not torch.equal(res17["qkv"][0], res5["qkv"][0]):
                fail(f"{label} rate {rate}: K17's layer-0 q/k/v differ from "
                     f"K5's")
            check_bf16_spread(f"{label} rate {rate}: K17 vs K5 output",
                              out17, out5)
            for k in kinds:
                check_bf16_spread(f"{label} rate {rate}: K17 vs K5 {k}",
                                  cat_leaves(res17[k]), cat_leaves(res5[k]))
        elif not same5:
            fail(f"{label} rate {rate}: K17 is not bit-equal to K5 (output "
                 f"max|diff| {max_err([out17], [out5])[0]})")
        errs[("K17", rate)] = check_bf16_spread(
            f"{label} rate {rate}: K17", out17, outp)
        grads = []
        for run in ("k5", "k17"):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = (st.stored_encoder(*si, ps, S, Tn, rate, seed)
                   if run == "k5" else
                   st.fused_u2gnn_encoder_stored(x0, ps, S, Tn, rate, seed))
            grads.append(torch.autograd.grad((out * w).sum(), ps))
        gsame = all(torch.equal(a, b) for a, b in zip(*grads))
        if narrow:
            low = min(cosine(a, b) for a, b in zip(grads[1], grads[0]))
            if not low > 0.999:
                fail(f"{label} rate {rate}: K17 + K6 vs K5/K6 lowest leaf "
                     f"cosine {low}")
            print(f"# check {label} rate {rate}: K17 (thread per row) "
                  f"bit-equal to K15 (output, residuals), layer 0's q/k/v "
                  f"to K5's; against K5 "
                  + ("bit-equal" if same5 else
                     f"output max|diff| {max_err([out17], [out5])[0]:.3e}")
                  + ", gradients with K6 "
                  + ("bit-equal" if gsame else f"lowest leaf cosine {low:.6f}"),
                  flush=True)
            continue
        if not gsame:
            fail(f"{label} rate {rate}: K17 + K6 gradients differ from "
                 f"K5/K6's: max|diff| {max_err(grads[1], grads[0])[0]}")
        print(f"# check {label} rate {rate}: K17 bit-equal to K5 (output, "
              f"residuals) and its gradients with K6 to K5/K6's", flush=True)
    return errs


def plain_walk(res, w, params, Tn, rate, seed, mm):
    """The plain backward over a forward's residuals ``res``: K3 then K2
    per earlier layer, or K6 (slot 0, then per earlier layer) where ``res``
    holds the stored hidden ``h``.  Returns (dx [N, S, D], the 12 stacked
    gradients) of sum(out * w)."""
    from graph_transformer_tpu_torch.ops import sampled_encoder as se

    def layer_bwd(t, g):
        last = t == Tn - 1
        x = res["xs"][t]
        bwd = se.slot0_backward_plain if last else se.layer_backward_plain
        h = {"h": res["h"][t]} if "h" in res else {}
        return bwd(x, res["qkv"][t], res["attn"][t], res["strip"][t],
                   g if last else g.view_as(x),
                   [a[t % a.shape[0]] for a in params], layer=t, rate=rate,
                   seed=seed, mm=mm, **h)

    return se.walk_backward(w, params, Tn, layer_bwd)


def cat_leaves(ts):
    import torch

    return torch.cat([t.float().flatten() for t in ts])


def residuals_f64(x2d, params, S, Tn, rate, seed):
    """The plain stored-residual forward in float64 with unrounded
    operands (as :func:`plain_f64`): its residuals, lists by kind."""
    import torch

    from graph_transformer_tpu_torch.ops.sampled_encoder import (
        rows_forward_plain)

    D = x2d.shape[1]
    return rows_forward_plain(
        x2d.double().view(-1, S, D), [p.double() for p in params], Tn, rate,
        seed, torch.float32, torch.float64,
        residuals=("qkv", "attn", "strip", "h"))[1]


def check_stored_rows_f32(label, params, x2d, S, Tn, dev, forward=True):
    """K17 with float32 rows at rate 0 and 0.5: the output by
    :func:`check_forward` (1e-4 or the float64 rule of :func:`check_k4_f32`)
    and each kind of residual against the plain forward's — within 1e-4 of
    its max, or, where float32 sum order alone moves the plain version
    further than that from the float64 forward's, within twice the plain
    version's own error of them (as :func:`check_k4_f32`); then with K6 dx
    and each gradient leaf within 1e-4 of its own max of the plain backward
    on K17's residuals.  The plain backward is not run on the plain
    forward's residuals: float32 gradients amplify the two forwards'
    rounding far past 1e-4 at D=68.  With ``forward`` False only the K6
    part.  Returns the errors by (kernel, rate)."""
    import torch

    from graph_transformer_tpu_torch.ops import stored_encoder as st

    N, D = x2d.shape[0] // S, x2d.shape[1]
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(18))
    errs = {}
    for rate in (0.0, 0.5):
        seed = 24680
        out_k, res_k = st.stored_rows_forward(x2d, params, S, Tn, rate, seed)
        if forward:
            out_p, res_p = st.stored_rows_forward_plain(x2d, params, S, Tn,
                                                        rate, seed)
            errs[("K17", rate)] = check_forward(
                f"{label} rate {rate}: K17", out_k, out_p,
                lambda: plain_f64(x2d, params, S, Tn, rate, seed), bf16=False)
        res64, ratio, own = None, 0.0, 0.0
        for k in res_k if forward else ():
            a, b = cat_leaves(res_k[k]), cat_leaves(res_p[k])
            if float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()):
                continue
            if res64 is None:
                res64 = residuals_f64(x2d, params, S, Tn, rate, seed)
            r = torch.cat([t.flatten() for t in res64[k]])
            ek = float((a.double() - r).abs().max())
            ep = float((b.double() - r).abs().max())
            if not ek <= 2.0 * ep:
                fail(f"{label} rate {rate}: K17 residual {k}: max|diff| "
                     f"{float((a - b).abs().max())} (float64 reference: "
                     f"kernel {ek}, plain {ep})")
            ratio = max(ratio, ek / ep)
            own = max(own, ep / float(r.abs().max()))
        ps = [p.detach().clone().requires_grad_(True) for p in params]
        x = x2d.detach().clone().requires_grad_(True)
        out = st.fused_u2gnn_encoder_stored(x, ps, S, Tn, rate, seed)
        gk = torch.autograd.grad((out * w).sum(), [x] + ps)
        dx_p, gp = plain_walk(res_k, w, params, Tn, rate, seed,
                              torch.float32)
        worst = max(leaf_close(f"{label} rate {rate}: K17 + K6 {leaf}", a, b)
                    for leaf, a, b in zip(LEAVES, gk, (dx_p.reshape(N * S, D),)
                                          + tuple(gp)))
        line = f"# check {label} rate {rate}: "
        if forward:
            line += (f"K17 max|err| {errs[('K17', rate)][0]:.3e} "
                     f"({errs[('K17', rate)][1]:.1e}), residuals within 1e-4 "
                     f"of their max"
                     + (f" or the float64 rule (worst kernel/plain "
                        f"{ratio:.2f}; plain float32 vs float64 up to "
                        f"{own:.1e} of the max)" if ratio else "") + "; ")
        print(line + f"K17 with K6 against the plain backward on its "
              f"residuals: worst leaf {worst:.2e} of its max", flush=True)
    return errs


def check_fused_mega(label, si, params, S, Tn, dev):
    """K13 with the whole-stack backward (``fused_sampled_encoder(...,
    mega_bwd=True)``: K14, K14w past D=32, on K13's saved bf16 inputs)
    against K13 with its chain (K8s/K8 or K8ws/K8w) at rate 0 and 0.5: the
    same output, every gradient leaf at cosine > 0.999, and whether they
    are equal bit for bit."""
    import torch

    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs

    N, D = si[0].shape[0], si[3].shape[1]
    w = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(19))
    name = "K14w" if D > 32 else "K14"
    for rate in (0.0, 0.5):
        seed = 11235
        outs, grads = [], []
        for mega in (False, True):
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            out = fs.fused_sampled_encoder(*si, ps, S, Tn, rate, seed,
                                           mega_bwd=mega)
            grads.append(torch.autograd.grad((out * w).sum(), ps))
            outs.append(out.detach())
        if not torch.equal(outs[0], outs[1]):
            fail(f"{label} rate {rate}: K13 output differs between runs")
        low = min(cosine(a, b) for a, b in zip(grads[1], grads[0]))
        if not low > 0.999:
            fail(f"{label} rate {rate}: K13 + {name} vs K13 + chain lowest "
                 f"leaf cosine {low}")
        equal = all(torch.equal(a, b) for a, b in zip(*grads))
        print(f"# check {label} rate {rate}: K13 + {name} vs K13 + its chain:"
              + (" equal bit for bit" if equal else
                 f" lowest leaf cosine {low:.6f}"), flush=True)


def check_variants(width, x2d, params, w, res, S, Tn, rate, seed):
    """This slice's kernels against their plain versions on the main path's
    own inputs, run after its launch counts were read: K14 (K14w) on K4t's
    (K4tw's) saved inputs and the backward of the stored (folded) variant —
    K6 on K17's residuals (K3/K2 on K15's) — by :func:`check_grads`; K17's
    (K15's) output and each kind of residual, and K16's output, by
    :func:`check_bf16_spread`.  The stored and folded variants' gradient
    leaves against hybrid's at cosine > 0.99: designs that round their bf16
    residuals at different points (the bound of the two-pass against the
    fused path, ROADMAP Queue C).  Returns the errors by (kernel, rate,
    label)."""
    import torch

    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut

    N, D = w.shape
    label = f"{width} main path"
    errs = {}
    _, xs = ue.u2gnn_encoder_train(x2d, params, S, Tn, rate, seed)
    name = "K14w" if D > 32 else "K14"
    dx_k, gk = ut.mega_recompute_backward(x2d, xs, w, params, S, Tn, rate,
                                          seed)
    dx_p, gp = ut.mega_recompute_backward_plain(x2d, xs, w, params, S, Tn,
                                                rate, seed)
    errs[(name, rate, label)], low = check_grads(f"{label}: {name}", dx_k, gk,
                                                 dx_p, gp)
    line = f"# check {label}: {name} vs plain lowest leaf cosine {low:.6f}"
    runs = [("K17", "stored", st.stored_rows_forward,
             st.stored_rows_forward_plain)]
    if "folded" in res:
        runs.append(("K15", "folded", fe.folded_stored_forward,
                     fe.folded_stored_forward_plain))
    for name, variant, fwd, plain in runs:
        out_k, res_k = fwd(x2d, params, S, Tn, rate, seed)
        out_p, res_p = plain(x2d, params, S, Tn, rate, seed)
        out_v, g_v = res[variant]
        if not torch.equal(out_k, out_v):
            fail(f"{label}: {name} differs between two runs")
        errs[(name, rate, label)] = check_bf16_spread(
            f"{label}: {name} output", out_k, out_p)
        for k in res_k:
            check_bf16_spread(f"{label}: {name} residual {k}",
                              cat_leaves(res_k[k]), cat_leaves(res_p[k]))
        if name == "K15":
            errs[("K16", rate, label)] = check_bf16_spread(
                f"{label}: K16 output",
                fe.folded_forward(x2d, params, S, Tn, rate, seed), out_p)
        dx_p, gp = plain_walk(res_k, w, params, Tn, rate, seed,
                              torch.bfloat16)
        _, low = check_grads(f"{label}: {variant} backward", g_v[0].float(),
                             g_v[1:], dx_p.reshape(N * S, D), gp)
        cross = min(cosine(a, b) for a, b in zip(g_v, res["hybrid"][1]))
        if not cross > 0.99:
            fail(f"{label}: {variant} vs hybrid lowest leaf cosine {cross}")
        line += (f"; {variant} backward vs plain {low:.6f}, vs hybrid "
                 f"{cross:.6f}")
    print(line, flush=True)
    return errs


AB_ROWS = dict(N=8832, S=9, D=4, Tn=4)  # scripts/bench_hybrid.py:32


def encoder_variants(dev):
    """This slice's main path: the encoder's forward and backward designs
    that ``scripts/bench_hybrid.py``, ``bench_folded.py`` and
    ``bench_stored_bwd.py`` A/B, at their workload (8,832 neighborhoods x
    S=9 = 79,488 rows, D=4, F=1024, T=4, bf16 rows, rate 0.5, stored = T),
    for one seed and the same weights: hybrid (K4t, K8s, 3xK8), mega (K4t,
    K14), folded (K15, K3, 3xK2), stored (K17, K6s, 3xK6), each forward +
    backward with every launch count set to 0 just before and read just
    after (each of its kernels launched as often as said, every other idle),
    then K16 alone; and at the quickstart's width (D=68 one-hot rows, the
    same rows), where the folded gate fails: hybrid (K4tw, K8ws, 3xK8w), mega
    (K4tw, K14w), stored (K17, K6s, 3xK6).  Holds the outputs against each
    other (hybrid, mega and folded bit for bit at D=4; stored by
    :func:`check_bf16_spread`), K14/K14w against the chain's gradients
    (cosine > 0.999) and K16 against K15, then each kernel against its
    plain version on these inputs (:func:`check_variants`).  Returns (the
    launches by kernel, the A/B and wide cases, the errors by (kernel, rate,
    label))."""
    import torch

    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut

    N, S, Tn = AB_ROWS["N"], AB_ROWS["S"], AB_ROWS["Tn"]
    rate, seed = 0.5, 4321
    counters = launch_counters()
    total = {k: 0 for k in counters}
    cases, errs = {}, {}
    for width, D in (("ab", AB_ROWS["D"]), ("wide", 68)):
        _, params, x2d = random_case(N=N, S=S, D=D, C=D, F=FF, Tn=Tn,
                                     stored=Tn, seed=12, dev=dev)
        if D > 32:  # one-hot degree-tag rows, as the quickstart's
            tags = torch.randint(0, D, (N * S,), device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(20))
            x2d = torch.eye(D, device=dev)[tags].to(torch.bfloat16)
        w = torch.randn(N, D, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(21))
        wide = width == "wide"
        variants = {
            "hybrid": (lambda ps, x: ut.u2gnn_train_encoder(
                x, ps, S, Tn, rate, seed),
                {"K4tw": 1, "K8ws": 1, "K8w": Tn - 1} if wide
                else {"K4t": 1, "K8s": 1, "K8": Tn - 1}),
            "mega": (lambda ps, x: ut.u2gnn_train_encoder(
                x, ps, S, Tn, rate, seed, mega_bwd=True),
                {"K4tw": 1, "K14w": 1} if wide else {"K4t": 1, "K14": 1}),
            "stored": (lambda ps, x: st.fused_u2gnn_encoder_stored(
                x, ps, S, Tn, rate, seed), {"K17": 1, "K6s": 1, "K6": Tn - 1}),
        }
        if width == "ab":
            variants["folded"] = (lambda ps, x: fe.folded_u2gnn_encoder_grad(
                x, ps, S, Tn, rate, seed), {"K15": 1, "K3": 1, "K2": Tn - 1})
        res = {}
        for name, (fn, want) in variants.items():
            ps = [p.detach().clone().requires_grad_(True) for p in params]
            x = x2d.detach().clone().requires_grad_(True)
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            out = fn(ps, x)
            g = torch.autograd.grad((out * w).sum(), [x] + ps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            for k, v in launches.items():
                total[k] += v
                if v != want.get(k, 0):
                    fail(f"{width} {name}: {k} launched {v} times, expected "
                         f"{want.get(k, 0)}")
            if not (bool(torch.isfinite(out).all())
                    and all(bool(torch.isfinite(t).all()) for t in g)):
                fail(f"{width} {name}: output or gradients not finite")
            res[name] = (out.detach(), g)
            print(f"# encoder variant {width} (N={N}, S={S}, D={D}) {name}: "
                  f"forward + backward {dt * 1e3:.1f} ms (first call), "
                  f"launches {dict((k, v) for k, v in launches.items() if v)}",
                  flush=True)
        out_h, g_h = res["hybrid"]
        if not torch.equal(res["mega"][0], out_h):
            fail(f"{width}: the mega variant's forward differs from hybrid's")
        low = min(cosine(a.float(), b.float())
                  for a, b in zip(res["mega"][1], g_h))
        if not low > 0.999:
            fail(f"{width}: mega vs hybrid lowest leaf cosine {low}")
        equal = all(torch.equal(a, b) for a, b in zip(res["mega"][1], g_h))
        e_st = check_bf16_spread(f"{width}: stored vs hybrid output",
                                 res["stored"][0], out_h)
        line = (f"# encoder variants {width}: mega vs hybrid "
                + ("equal bit for bit" if equal else
                   f"lowest leaf cosine {low:.6f}")
                + f"; stored vs hybrid output max|diff| {e_st[0]:.3e}")
        if width == "ab":
            if not torch.equal(res["folded"][0], out_h):
                fail("ab: the folded variant's output differs from hybrid's "
                     f"({max_err([res['folded'][0]], [out_h])[0]})")
            for c in counters.values():
                c.launches = 0
            out16 = fe.folded_u2gnn_encoder(x2d, params, S, Tn, rate, seed)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            for k, v in launches.items():
                total[k] += v
                if v != (k == "K16"):
                    fail(f"ab K16: {k} launched {v} times")
            if not torch.equal(out16, res["folded"][0]):
                fail("ab: K16 is not bit-equal to K15")
            line += "; folded output equal to hybrid's; K16 equal to K15"
        print(line, flush=True)
        errs.update(check_variants(width, x2d, params, w, res, S, Tn, rate,
                                   seed))
        cases[width] = dict(params=params, x2d=x2d, w=w, D=D)
    print(f"# encoder variants launches: "
          f"{dict((k, v) for k, v in total.items() if v)}", flush=True)
    return total, cases, errs


def config_run(label, ds, cfg, want, dev, train_idx=None, test_idx=None):
    """``SupTrainer(cfg)`` on ``ds`` (fold 0, or the given split) on the
    card: every launch count set to 0, then :func:`timed_steps` on one batch
    and ``evaluate()``; asserts at least one launch of each kernel in
    ``want`` and none of any other, then profiles 5 steps.  Returns
    dict(trainer, batch, ms, eps, profile, launches)."""
    import torch

    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    trainer = SupTrainer(ds, cfg, train_idx, test_idx, device="cuda")
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    batch = trainer.builder.sample()
    edges = float(batch.edge_mask.sum())
    batch = batch.to(dev)
    ms, eps = timed_steps(trainer, batch, edges)
    acc = trainer.evaluate()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"# {label}: {ms:.3f} ms/step, {eps:.1f} edges/s ({edges:.0f} "
          f"edges/step, N={batch.n_pad}, D={ds.feature_dim}), eval acc "
          f"{acc:.4f}; launches {launches}", flush=True)
    if not 0.0 <= acc <= 1.0:
        fail(f"{label} accuracy {acc}")
    for k, v in launches.items():
        if (v > 0) != (k in want):
            fail(f"{label}: {k} launched {v} times")
    prof = profile_busy(lambda: trainer.train_steps(batch, 5), 5)
    return dict(trainer=trainer, batch=batch, ms=ms, eps=eps, profile=prof,
                launches=launches)


def write_tu_like(root, name, num_graphs, mean_nodes, mean_edges, num_tags,
                  num_classes, attr_dim=0, seed=0, class_tags=0.0):
    """Write a molecule-like TU text file ``<root>/<name>/<name>.txt`` (and,
    with ``attr_dim``, an ``<name>_node_attributes.txt`` sidecar of
    standard-normal rows): per graph, n nodes around ``mean_nodes``, a
    random tree whose edges join nearby nodes, plus random chords to about
    ``mean_edges`` undirected edges; ``num_tags`` random node tags and
    random labels of ``num_classes``.  With ``class_tags`` > 0 the labels
    can be learned: each node's tag is, with that probability, drawn
    anew from its graph's class's block of the tags (the tags split into
    ``num_classes`` contiguous blocks), so the classes' tag distributions
    differ and overlap."""
    rng = np.random.default_rng(seed)
    lines, attrs = [str(num_graphs)], []
    block = -(-num_tags // num_classes)
    for _ in range(num_graphs):
        n = max(2, int(round(rng.normal(mean_nodes, 0.3 * mean_nodes))))
        adj = [set() for _ in range(n)]
        for j in range(1, n):
            k = int(rng.integers(max(0, j - 4), j))
            adj[j].add(k)
            adj[k].add(j)
        extra = rng.poisson(max(mean_edges / mean_nodes * n - (n - 1), 0.0))
        for _ in range(int(extra)):
            a, b = (int(v) for v in rng.integers(0, n, 2))
            if a != b:
                adj[a].add(b)
                adj[b].add(a)
        label = int(rng.integers(0, num_classes))
        lines.append(f"{n} {label}")
        for nb in adj:
            tag = int(rng.integers(0, num_tags))
            if class_tags and rng.random() < class_tags:
                lo = label * block
                tag = int(rng.integers(lo, min(lo + block, num_tags)))
            lines.append(" ".join(map(str, [tag, len(nb), *sorted(nb)])))
        if attr_dim:
            attrs.append(rng.standard_normal((n, attr_dim)))
    os.makedirs(os.path.join(root, name), exist_ok=True)
    with open(os.path.join(root, name, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if attr_dim:
        np.savetxt(os.path.join(root, name, f"{name}_node_attributes.txt"),
                   np.concatenate(attrs), fmt="%.6f", delimiter=", ")
    return root


def write_ptc_like_tu(root, name="PTC", num_graphs=344, seed=3,
                      class_tags=0.25):
    """PTC's statistics (344 graphs, ~25.6 nodes and ~26 edges a graph, 19
    tags, 2 classes; the U2GNN repository's copy), with labels that can be
    learned from class-dependent tag distributions (``write_tu_like``'s
    ``class_tags``)."""
    return write_tu_like(root, name, num_graphs, 25.6, 26.0, 19, 2,
                         seed=seed, class_tags=class_tags)


def write_mutag_like_tu(root):
    """MUTAG's statistics: 188 graphs, ~17.9 nodes and ~19.8 edges a graph,
    7 tags, 2 classes."""
    return write_tu_like(root, "MUTAG", 188, 17.9, 19.8, 7, 2, seed=1)


def write_enzymes_like_tu(root):
    """ENZYMES's statistics: 600 graphs, ~32.6 nodes and ~62.1 edges a
    graph, 3 tags, 6 classes, 18 continuous attributes a node."""
    return write_tu_like(root, "ENZYMES", 600, 32.6, 62.1, 3, 6, attr_dim=18,
                         seed=2)


def write_imdb_like_tu(root, name="IMDBBINARY", num_graphs=1000, seed=0):
    """Write an IMDBBINARY-like TU text file ``<root>/<name>/<name>.txt``:
    ego networks (a hub joined to every node, plus overlapping cliques), 2
    classes, and one graph in 100 of 130-140 nodes, whose hub degree passes
    the sampler's 128 clamp.  At the defaults: 20.3 nodes and 93.9
    undirected edges a graph, maximum degree 135, 68 distinct degrees (so
    D=68 with degree tags); IMDBBINARY has 19.8, 96.5, ~135 and 65."""
    rng = np.random.default_rng(seed)
    lines = [str(num_graphs)]
    for g in range(num_graphs):
        n = 12 + min(int(rng.geometric(1 / 8.5)) - 1, 28)
        if g % 100 == 99:
            n = int(rng.integers(130, 141))
        cap = 40 if n > 100 else 30
        adj = [set() for _ in range(n)]
        for j in range(1, n):
            adj[0].add(j)
            adj[j].add(0)
        for _ in range(1 + int(rng.poisson(1.8))):
            k = int(rng.integers(3, min(cap, max(4, int(0.6 * n))) + 1))
            members = rng.choice(np.arange(1, n), size=min(k, n - 1),
                                 replace=False)
            for a in members:
                for b in members:
                    if a != b:
                        adj[int(a)].add(int(b))
        lines.append(f"{n} {int(rng.integers(0, 2))}")
        lines += [" ".join(map(str, [0, len(nb), *sorted(nb)]))
                  for nb in adj]
    os.makedirs(os.path.join(root, name), exist_ok=True)
    with open(os.path.join(root, name, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


# ---------------------------------------------------------------- profile
def device_ms(fn, reps: int, kernels) -> float:
    """Device time per call of ``fn`` spent in the CUDA kernels whose names
    hold one of ``kernels``, from torch.profiler (the wrapper's own
    allocations, fills and casts are left out): for each kernel name, its
    mean time a launch times its launches a call.  CUPTI now and then drops
    some of a session's records (9 of 10 launches seen on an H100):
    a sum over the records kept would read low, the mean a launch does not.
    One session has also read K4t at half the time that other runs of the
    same code read, with its step profile unchanged, so the median of three
    sessions is returned, and sessions more than 20% apart are printed with
    their record counts.  A session that records none of
    these kernels is run again, up to seven sessions in all (three lost in
    a row have been seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(7):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in device:
            if any(k in e.name for k in kernels):
                by_name.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if by_name:
            readings.append((sum(
                sum(us) / len(us) * max(1, round(len(us) / reps))
                for us in by_name.values()) / 1e3,
                {n[:40]: len(us) for n, us in by_name.items()}))
            if len(readings) == 3:
                break
            continue
        print(f"# the profiler saw no launch of {kernels} in {reps} calls "
              f"({len(device)} device events); profiling again", flush=True)
    if not readings:
        fail(f"the profiler saw no device time in {kernels} in seven "
             "sessions")
    ms = sorted(r[0] for r in readings)[len(readings) // 2]
    if max(r[0] for r in readings) > 1.2 * min(r[0] for r in readings):
        print(f"# device_ms {kernels}: sessions read "
              + "; ".join(f"{r[0]:.4f} ms ({r[1]} records of {reps} calls)"
                          for r in readings)
              + f"; the median {ms:.4f}", flush=True)
    return ms


def profile_busy(fn, n_steps: int, start_at: str = "") -> None:
    """Trace ``fn()``, which runs ``n_steps`` training steps, with
    torch.profiler; print the device time of each kernel per step and the
    device's busy share (union of device-operation intervals over the span
    from the first one's start to the last one's end; with ``start_at``,
    from the first kernel whose name holds it, so that set-up copies are
    left out), and return the share, the device operations and the busy ms
    per step.  The profiler slows the host, so this share is a lower bound
    of the unprofiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    first = min((e.time_range.start for e in events if start_at in e.name),
                default=None)
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if first is None or t0 < first:
            continue
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0)
    if not spans:
        print("# profile: the profiler saw no device time", flush=True)
        return None
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = cur1 - spans[0][0]
    print(f"# profile: {n_steps} steps, device span {span / n_steps / 1e3:.3f}"
          f" ms/step, busy {busy / n_steps / 1e3:.3f} ms/step, busy share "
          f"{busy / span:.4f}, {len(spans) / n_steps:.1f} device ops/step",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"#   {us / n_steps / 1e3:9.4f} ms/step  {name[:90]}", flush=True)
    return {"busy_share": busy / span, "ops_per_step": len(spans) / n_steps,
            "busy_ms_per_step": busy / n_steps / 1e3}


# ------------------------------------------------------------- library call
def library_encoder(params, S, Tn, D, F, dev, dtype=None, dropout=0.0):
    """torch.nn.TransformerEncoder with the same weights (bf16 unless
    ``dtype``; training mode when ``dropout`` > 0): the yardstick for K4, K4t
    and K5; the port never calls it."""
    import torch
    from torch import nn

    layer = nn.TransformerEncoderLayer(D, 1, F, dropout=dropout,
                                       batch_first=True)
    enc = nn.TransformerEncoder(layer, Tn, enable_nested_tensor=False)
    stored = params[0].shape[0]
    with torch.no_grad():
        for t, L in enumerate(enc.layers):
            (w_in, b_in, w_out, b_out, g1, c1, w1, b1, w2, b2, g2, c2) = [
                a[t % stored] for a in params]
            L.self_attn.in_proj_weight.copy_(w_in.T)
            L.self_attn.in_proj_bias.copy_(b_in)
            L.self_attn.out_proj.weight.copy_(w_out.T)
            L.self_attn.out_proj.bias.copy_(b_out)
            L.linear1.weight.copy_(w1.T)
            L.linear1.bias.copy_(b1)
            L.linear2.weight.copy_(w2.T)
            L.linear2.bias.copy_(b2)
            L.norm1.weight.copy_(g1)
            L.norm1.bias.copy_(c1)
            L.norm2.weight.copy_(g2)
            L.norm2.bias.copy_(c2)
    enc = enc.to(dev, dtype or torch.bfloat16)
    return enc.train() if dropout > 0.0 else enc.eval()




# ------------------------------------------------- README quickstart (CLI)
QUICKSTART_FLAGS = ["--dataset", "IMDBBINARY", "--batch_size", "4",
                    "--ff_hidden_size", "1024", "--num_neighbors", "8",
                    "--num_timesteps", "4", "--learning_rate", "0.0005",
                    "--scan_epochs"]


TWO_PASS_FLAGS = {
    # the MUTAG HPO best arm (RESULTS.md:90)
    "MUTAG": ["--dataset", "MUTAG", "--num_hidden_layers", "2",
              "--num_neighbors", "16", "--num_timesteps", "5",
              "--degree_as_tag", "--batch_size", "4", "--ff_hidden_size",
              "1024", "--learning_rate", "0.0002971875486100803"],
    # the ENZYMES row (RESULTS.md:23) with its continuous attributes
    "ENZYMES": ["--dataset", "ENZYMES", "--use_node_attributes",
                "--batch_size", "4", "--num_neighbors", "8",
                "--num_timesteps", "4", "--ff_hidden_size", "1024",
                "--learning_rate", "0.0005"],
}
FUSED_KERNELS = ("K1", "K2", "K3", "K5", "K6", "K6s", "K13")
TWO_PASS_KERNELS = ("K7", "K4t", "K8", "K8s")
# the README quickstart through the CLI (the two-pass path in float32 on
# wide rows), with two U2GNN layers, and with the ACT recurrence
WIDE_TWO_PASS = ("K7", "K4tw", "K8w", "K8ws", "K4w")
QUICKSTART_RUNS = {
    "quickstart": (QUICKSTART_FLAGS, WIDE_TWO_PASS),
    "quickstart k2": (QUICKSTART_FLAGS + ["--num_hidden_layers", "2"],
                      WIDE_TWO_PASS),
    "quickstart act": (QUICKSTART_FLAGS + ["--recurrence", "act"],
                       ("K7", "K9w", "K10w")),
    # the host batcher's neighborhoods: no sampler launch
    "quickstart host": (QUICKSTART_FLAGS + ["--host_sampling"],
                        ("K4tw", "K8w", "K8ws", "K4w")),
}
# the fused path's three flags (JAX's fused_gate_ok); without use_folded or
# use_stored_bwd it runs K13 with the recompute backward
FUSED_FLAGS = dict(use_fused_sampler=True, use_pallas=True,
                   use_pallas_whole_encoder=True)
# the MUTAG row (RESULTS.md:20) with the ACT recurrence, and the README
# quickstart on the reference's node axis
PER_LAYER_FLAGS = {
    "act": ["--dataset", "MUTAG", "--batch_size", "4", "--num_neighbors", "8",
            "--num_timesteps", "4", "--ff_hidden_size", "1024",
            "--learning_rate", "0.0005", "--recurrence", "act"],
    "node": QUICKSTART_FLAGS + ["--attention_axis", "node"],
}
PER_LAYER_WANT = {"act": ("K7", "K9", "K10"), "node": ("K7", "K11", "K12")}


def launch_counters():
    """Every kernel wrapper's launch counter, by kernel."""
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import ffn
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_encoder as ue
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.sampling import neighbor_table as nt

    return {"K1": se.sampled_forward, "K2": se.layer_backward,
            "K3": se.slot0_backward, "K4": ue.u2gnn_encoder,
            "K4w": ue.wide_encoder, "K5": st.stored_forward,
            "K6": st.stored_layer_backward, "K6s": st.stored_slot0_backward,
            "K7": nt.sample_neighborhoods, "K4t": ue.u2gnn_encoder_train,
            "K8": ut.layer_recompute_backward,
            "K8s": ut.slot0_recompute_backward,
            "K9": el.encoder_layer_forward, "K10": el.encoder_layer_backward,
            "K11": ffn.ffn_forward, "K12": ffn.ffn_backward,
            "K4tw": ue.wide_encoder_train,
            "K8w": ut.wide_layer_recompute_backward,
            "K8ws": ut.wide_slot0_recompute_backward,
            "K9w": el.wide_encoder_layer_forward,
            "K10w": el.wide_encoder_layer_backward,
            "K13": fs.fused_sampled_forward,
            "K14": ut.mega_recompute_backward,
            "K14w": ut.wide_mega_recompute_backward,
            "K15": fe.folded_stored_forward, "K16": fe.folded_forward,
            "K17": st.stored_rows_forward}


def describe(label, ds) -> None:
    deg = ds.degrees
    print(f"# {label} data: {ds.num_graphs} graphs, "
          f"{ds.num_nodes / ds.num_graphs:.2f} nodes and "
          f"{ds.num_directed_edges / 2 / ds.num_graphs:.2f} undirected edges "
          f"a graph, max degree {int(deg.max())} ({int((deg > 128).sum())} "
          f"nodes past 128), feature_dim {ds.feature_dim}", flush=True)


def run_cli(label, flags, data, root, want, idle) -> dict:
    """``cli.train_sup.main`` with ``flags`` for 2 epochs on the card, every
    launch count set to 0 just before and read just after; asserts two
    finite epoch losses, an accuracy in [0, 1], at least one launch of each
    kernel in ``want`` and none of those in ``idle``.  Returns the
    launches."""
    import contextlib
    import io
    import re

    import torch

    from graph_transformer_tpu_torch.cli import train_sup

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        acc = train_sup.main(flags + [
            "--num_epochs", "2", "--device", "cuda", "--data_dir", data,
            "--run_folder", os.path.join(root, "runs")])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for line in log.getvalue().splitlines():
        print(f"# cli: {line}", flush=True)
    losses = [float(v) for v in
              re.findall(r"\| loss\s+(\S+) \|", log.getvalue())]
    print(f"# {label} launches: {launches}", flush=True)
    if len(losses) != 2 or not all(np.isfinite(losses)):
        fail(f"{label} epoch losses {losses}")
    if not 0.0 <= acc <= 1.0:
        fail(f"{label} accuracy {acc}")
    for k in want:
        if launches[k] < 1:
            fail(f"{label}: {k} was not launched")
    for k in idle:
        if launches[k]:
            fail(f"{label}: {k} launched {launches[k]} times")
    return launches


def quickstart(root: str):
    """The README quickstart (``README.md:47-50``) through the CLI on an
    IMDBBINARY-like file, for 2 epochs on the card, as is, with
    ``--num_hidden_layers 2``, ``--recurrence act`` and ``--host_sampling``:
    degree tags are forced, so the rows are wide (D > 32), and the CLI, like
    the JAX CLI, trains on the two-pass path in float32 (K7, K4tw,
    K8ws/K8w; the wide K4 at evaluation; ACT: K7, K9w, K10w; host sampling:
    no K7); every other kernel stays idle.
    Returns (dataset, {run: launches})."""
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    data = write_imdb_like_tu(os.path.join(root, "data"))
    ds = load_tu_dataset("IMDBBINARY", data_dir=data)
    describe("quickstart", ds)
    if ds.feature_dim <= 32:
        fail(f"IMDBBINARY-like feature_dim {ds.feature_dim} <= 32: the "
             "quickstart would not reach the wide kernels")
    launches = {}
    for name, (flags, want) in QUICKSTART_RUNS.items():
        launches[name] = run_cli(
            name, flags, data, root, want=want,
            idle=tuple(k for k in launch_counters() if k not in want))
    return ds, launches


def two_pass_runs(root: str):
    """Slice 3's main paths through the CLI on the card, 2 epochs each: the
    MUTAG HPO best arm (two U2GNN layers) on a MUTAG-like file, and the
    ENZYMES row with its 18 continuous attributes on an ENZYMES-like file.
    Both train through K7, K4t, K8 and K8s and evaluate through K4; no
    fused-path kernel runs.  Returns ({name: dataset}, {name: launches})."""
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    data = os.path.join(root, "data")
    write_mutag_like_tu(data)
    write_enzymes_like_tu(data)
    dsets, launches = {}, {}
    for name, kw in (("MUTAG", dict(degree_as_tag=True)),
                     ("ENZYMES", dict(use_node_attributes=True))):
        ds = load_tu_dataset(name, data_dir=data, **kw)
        describe(name, ds)
        dsets[name] = ds
        launches[name] = run_cli(name, TWO_PASS_FLAGS[name], data, root,
                                 want=TWO_PASS_KERNELS + ("K4",),
                                 idle=FUSED_KERNELS)
    return dsets, launches


def per_layer_runs(root: str):
    """Slice 4's main paths through the CLI on the card, 2 epochs each: the
    MUTAG row with ``--recurrence act`` on a MUTAG-like file (K7, then K9
    and K10 per timestep; evaluation K9) and the README quickstart with
    ``--attention_axis node`` on an IMDBBINARY-like file (K7, the attention
    in plain torch, K11 and K12 per timestep); every other kernel stays
    idle.  Returns ({name: dataset}, {name: launches})."""
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    data = os.path.join(root, "data")
    write_mutag_like_tu(data)
    write_imdb_like_tu(data)
    dsets, launches = {}, {}
    for name, dname in (("act", "MUTAG"), ("node", "IMDBBINARY")):
        ds = load_tu_dataset(dname, data_dir=data)
        describe(f"{name} ({dname}-like)", ds)
        dsets[name] = ds
        want = PER_LAYER_WANT[name]
        launches[name] = run_cli(
            name, PER_LAYER_FLAGS[name], data, root, want=want,
            idle=tuple(k for k in launch_counters() if k not in want))
    return dsets, launches


def short_runs(ds_act, ds_attr) -> None:
    """3 training steps on the card of each other recurrence (the ACT run's
    MUTAG-like data: K9/K10) and of two heads (the ENZYMES-like attributes,
    D=18: plain attention, K11/K12); fails on a loss that is not finite or
    a kernel of the path that did not launch."""
    import dataclasses

    import torch

    from graph_transformer_tpu_torch.cli.common import (
        base_parser, config_from_args)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    counters = launch_counters()
    cases = [(kind, ds_act, PER_LAYER_FLAGS["act"] + ["--recurrence", kind],
              {}, ("K9", "K10"))
             for kind in ("skip", "highway", "gru", "lstm", "dwa")]
    cases.append(("two heads", ds_attr, TWO_PASS_FLAGS["ENZYMES"],
                  dict(num_heads=2), ("K11", "K12")))
    for label, ds, flags, kw, want in cases:
        cfg = config_from_args(base_parser("s").parse_args(flags))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **kw))
        trainer = SupTrainer(ds, cfg, device="cuda")
        for c in counters.values():
            c.launches = 0
        losses = trainer.train_steps(trainer.builder.sample(), 3)
        torch.cuda.synchronize()
        got = {k: counters[k].launches for k in want}
        if not bool(torch.isfinite(losses).all()):
            fail(f"short run {label}: losses {losses}")
        if min(got.values()) < 1:
            fail(f"short run {label}: launches {got}")
        print(f"# short run {label}: losses {losses.tolist()}, launches "
              f"{got}", flush=True)


# the README's 10-fold command (README.md:56-58) on a PTC-like file; the
# phases of slice 14 run it through the CLI and through each CV runner
TENFOLD_FLAGS = ["--dataset", "PTC", "--batch_size", "4",
                 "--ff_hidden_size", "1024", "--num_neighbors", "16",
                 "--num_timesteps", "3", "--learning_rate", "0.0005",
                 "--scan_epochs"]
CV_MIN_MEAN = 0.75  # a label-blind model reads about 0.5
CV_KERNELS = ("K7", "K4t", "K8s", "K8", "K4")


# the unsupervised path: the README's unsup command
# (README.md:68-72) on the IMDBBINARY-like file, and a short run on the
# PTC-like file with learnable labels whose probe is gated; the CPU test
# reads 0.8376 for the port and 0.8168 for JAX on that file with these flags
# (tests/test_torch_unsup_trainer.py)
UNSUP_FLAGS = ["--dataset", "IMDBBINARY", "--batch_size", "2",
               "--ff_hidden_size", "1024", "--num_neighbors", "8",
               "--num_sampled", "512", "--num_timesteps", "1",
               "--learning_rate", "0.0001"]
UNSUP_ACC_FLAGS = ["--batch_size", "8", "--ff_hidden_size", "32",
                   "--num_neighbors", "4", "--num_timesteps", "1",
                   "--num_sampled", "64", "--learning_rate", "0.005",
                   "--num_epochs", "10"]
UNSUP_MIN_MEAN = 0.75  # the CPU readings less about two fold-stds (0.05)


class Preempted(RuntimeError):
    pass


def cv_data(root) -> tuple:
    """(dataset, directory) of the PTC-like file under ``root``."""
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    data = write_ptc_like_tu(os.path.join(root, "data"))
    ds = load_tu_dataset("PTC", data_dir=data)
    describe("PTC-like", ds)
    return ds, data


def check_cv_kernels(ds, dev) -> dict:
    """The 10-fold path's kernels against their plain versions at its own
    shapes (the README's 10-fold width: K=16, T=3, ff 1024, float32), with
    the first fold's initial weights: K7's stage (:func:`check_neighborhoods`)
    on a training batch of the fold's ``BatchBuilder``; K4t, K8s and K8
    (:func:`check_two_pass`) on the rows K7 drew for that batch; K4
    (:func:`check_k4_f32`) on the rows of the fold's first test batch.
    Returns the errors keyed as the other cases'."""
    import torch

    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)
    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        sample_neighborhoods)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    cfg = cv_config(2)
    tr, te = stratified_kfold_indices(ds.labels, 10, seed=0)[0]
    t = SupTrainer(ds, cfg, tr, te, device="cuda")
    if not t.two_pass:
        fail("the 10-fold path does not take the two-pass path")
    K, T = cfg.data.num_neighbors, cfg.model.num_timesteps
    S, D = K + 1, ds.feature_dim
    batch = t.builder.sample().to(dev)
    errs = {("K7", 0.0, "ptc-10fold batch"): check_neighborhoods(
        "ptc-10fold batch", t._nbr_table, t._deg, t._x_global, batch, K, 77)}
    feat = sample_neighborhoods(77, t._nbr_table, t._deg, t._x_global,
                                *t.two_pass_inputs(batch), K)[0]
    params = [p.detach() for p in t.model.encoders[0].stacked()]
    x2d = feat.reshape(-1, D)
    if x2d.dtype != torch.float32:
        fail(f"the 10-fold path's rows are {x2d.dtype}, not float32")
    errs.update({(k, r, "ptc-10fold"): v for (k, r), v in check_two_pass(
        "ptc-10fold float32", params, x2d, S, T, dev).items()})
    eb = t.test_stack()[0][0]
    x2d_e = eb.x.to(torch.float32)[eb.neigh.long()].reshape(-1, D)
    errs[("K4", 0.0, "ptc-10fold")] = check_k4_f32(
        "ptc-10fold eval", params, x2d_e, S, T)
    print(f"# check ptc-10fold: training batch N={batch.n_pad} x S={S}, "
          f"D={D}, T={T}, ff {params[6].shape[2]}; eval batch "
          f"N={eb.n_pad}", flush=True)
    return errs


def cv_config(epochs: int):
    from graph_transformer_tpu_torch.cli.common import (
        base_parser, config_from_args)

    return config_from_args(base_parser("cv").parse_args(
        TENFOLD_FLAGS + ["--num_epochs", str(epochs)]))


def check_cv_launches(label, launches, steps, evals, T) -> None:
    """Per training step K7, K4t and K8s once and K8 T-1 times; K4 once an
    eval batch; no other kernel."""
    want = {"K7": steps, "K4t": steps, "K8s": steps, "K8": (T - 1) * steps,
            "K4": evals}
    got = {k: v for k, v in launches.items() if v or k in want}
    print(f"# {label} launches: {got} over {steps} steps and {evals} eval "
          f"batches; a step: " + ", ".join(
              f"{k} {launches[k] / steps:g}" for k in CV_KERNELS[:4]),
          flush=True)
    if got != want:
        fail(f"{label}: launches {got}, expected {want}")


def cv_cli(ds, data) -> dict:
    """The README's 10-fold command through ``cli.tenfold.main`` for 2
    epochs on the card (the default runner: a ``SupTrainer`` a fold), every
    launch count set to 0 just before and read just after.  Fails unless
    every epoch loss is finite, the mean of the folds' best accuracies is at
    least ``CV_MIN_MEAN`` and the launches are the two-pass path's
    (:func:`check_cv_launches`).  Returns its numbers."""
    import contextlib
    import io

    import torch

    from graph_transformer_tpu_torch.cli import tenfold
    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)

    trainers = []

    class Recording(tenfold.SupTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    log, plain = io.StringIO(), tenfold.SupTrainer
    tenfold.SupTrainer = Recording
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            mean, std = tenfold.main(TENFOLD_FLAGS + [
                "--num_epochs", "2", "--device", "cuda", "--data_dir", data])
        torch.cuda.synchronize()
    finally:
        tenfold.SupTrainer = plain
    secs = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for line in log.getvalue().splitlines():
        print(f"# cli: {line}", flush=True)
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)
    steps = 2 * sum(-(-len(tr) // 4) for tr, _ in folds)
    evals = 2 * sum(-(-len(te) // 4) for _, te in folds)
    check_cv_launches("10-fold CLI", launches, steps, evals, 3)
    losses = [v for t in trainers for v in t.epoch_losses]
    if len(losses) != 20 or not np.all(np.isfinite(losses)):
        fail(f"10-fold CLI epoch losses {losses}")
    if not mean >= CV_MIN_MEAN:
        fail(f"10-fold CLI mean accuracy {mean:.4f} < {CV_MIN_MEAN}")
    print(f"# 10-fold CLI: mean {mean:.4f} ± {std:.4f}; {secs:.1f} s, "
          f"{secs / 2:.2f} s per CV epoch of 10 folds, {secs * 1e3 / steps:.3f}"
          f" ms a step with evaluation and set-up", flush=True)
    return {"mean": mean, "std": std, "s": secs, "steps": steps,
            "launches": launches}


def cv_runners(ds) -> dict:
    """``TenfoldVmapRunner`` (the CLI's ``--vmap_folds``) against a
    ``SupTrainer`` a fold, the CLI's default loop, on 3 folds x 2 epochs
    at the README's 10-fold width: every epoch loss and best accuracy
    equal bit for bit for each fold whose batch count is the runner's
    ``steps_per_epoch`` (the check that two runs repeat on the card).
    Returns each runner's seconds an epoch."""
    import torch

    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    from graph_transformer_tpu_torch.train.tenfold_vmap import (
        TenfoldVmapRunner)

    cfg = cv_config(2)
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:3]
    runner = TenfoldVmapRunner(ds, cfg, folds=folds, device="cuda")
    vm, best, t_vm = [], np.zeros(len(folds)), 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        vm.append(runner.train_epoch())
        best = np.maximum(best, runner.evaluate())
        t_vm += time.perf_counter() - t0
    seq, t_seq, compared = [], 0.0, 0
    for f, (tr, te) in enumerate(folds):
        t = SupTrainer(ds, cfg, tr, te, device="cuda")
        losses, b = [], 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            losses.append(t.train_epoch())
            b = max(b, t.evaluate())
            torch.cuda.synchronize()
            t_seq += time.perf_counter() - t0
        seq.append((losses, b))
        if t.num_batches_per_epoch != runner.steps_per_epoch:
            continue
        compared += 1
        got = [float(v[f]) for v in vm]
        if got != losses or float(best[f]) != b:
            fail(f"fold {f}: runner losses {got}, best {best[f]} against "
                 f"sequential {losses}, {b}")
    if not compared:
        fail("no fold has the runner's steps_per_epoch")
    steps = 2 * len(folds) * runner.steps_per_epoch
    print(f"# runners on {len(folds)} folds x 2 epochs: {compared} folds "
          f"equal bit for bit; fold-looped {t_vm / 2:.2f} s an epoch "
          f"({t_vm * 1e3 / steps:.3f} ms a step), sequential "
          f"{t_seq / 2:.2f} s an epoch; runner losses "
          f"{np.stack(vm).T.tolist()}, best {best.tolist()}", flush=True)
    return {"vmap_s_epoch": t_vm / 2, "seq_s_epoch": t_seq / 2,
            "folds": len(folds), "compared": compared}


def cv_on_device_resume(ds, root) -> dict:
    """``run_cv_on_device`` on 2 folds x 4 epochs in chunks of 2, once
    uninterrupted (launch counts as :func:`check_cv_launches`), once killed
    right after its first snapshot and resumed under ``run_cv_elastic``:
    best accuracies, epoch losses and epoch accuracies equal bit for bit.
    Then the device busy share of a 1-epoch run of 20 steps beside the
    sequential runner's."""
    import shutil

    import torch

    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)
    from graph_transformer_tpu_torch.train import cv_ondevice
    from graph_transformer_tpu_torch.train.elastic import run_cv_elastic
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    cfg = cv_config(4)
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:2]
    steps = max(-(-len(tr) // 4) for tr, _ in folds)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    ref = cv_ondevice.run_cv_on_device(ds, cfg, folds=folds,
                                       return_history=True,
                                       epochs_per_dispatch=2, device="cuda")
    secs = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    check_cv_launches("on-device CV", launches, 4 * len(folds) * steps,
                      4 * sum(-(-len(te) // 4) for _, te in folds), 3)
    if not np.all(np.isfinite(ref[3])):
        fail(f"on-device CV losses {ref[3]}")

    ckpt = os.path.join(root, "cv_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    save, attempts = cv_ondevice.save_checkpoint, []

    def save_then_die(*a, **kw):
        path = save(*a, **kw)
        if not attempts:
            raise Preempted("preempted right after the snapshot")
        return path

    cv_ondevice.save_checkpoint = save_then_die
    try:
        res = run_cv_elastic(ds, cfg, ckpt, folds=folds, return_history=True,
                             epochs_per_dispatch=2, device="cuda",
                             max_restarts=2,
                             retryable=(Preempted,),
                             on_failure=lambda a, e: attempts.append(a))
    finally:
        cv_ondevice.save_checkpoint = save
    if attempts != [1]:
        fail(f"on-device CV: restarts {attempts}, expected [1]")
    for name, i in (("best accuracies", 0), ("epoch losses", 3),
                    ("epoch accuracies", 4)):
        if not np.array_equal(ref[i], res[i]):
            fail(f"on-device CV resumed: {name} {res[i]} against the "
                 f"uninterrupted {ref[i]}")
    print(f"# on-device CV, 2 folds x 4 epochs: {secs:.1f} s, {secs / 4:.2f} s"
          f" an epoch ({secs * 1e3 / (4 * len(folds) * steps):.3f} ms a step "
          f"with set-up); killed after its first snapshot and resumed: equal "
          f"bit for bit (best {ref[0].tolist()}, losses {ref[3].tolist()})",
          flush=True)
    # device busy a step from the first K7 launch on: 1 epoch of 20 steps
    # (fold 0 with 80 training graphs, the steps unchanged), on the device
    # and with a SupTrainer (set up before the trace)
    fold = [(folds[0][0][:80], folds[0][1])]
    print("# on-device CV, 1 epoch of 20 steps:", flush=True)
    busy_dev = profile_busy(lambda: cv_ondevice.run_cv_on_device(
        ds, cv_config(1), folds=fold, device="cuda"), 20,
        start_at="gt_sample")
    t = SupTrainer(ds, cv_config(1), *fold[0], device="cuda")

    def sequential():
        t.train_epoch()
        t.evaluate()

    print("# sequential runner, 1 epoch of 20 steps:", flush=True)
    busy_seq = profile_busy(sequential, 20, start_at="gt_sample")
    torch.cuda.synchronize()
    return {"s_epoch": secs / 4, "busy": busy_dev, "busy_seq": busy_seq}


def train_sup_resume(data, root) -> None:
    """``cli.train_sup`` with ``--checkpoint_every 1``: 2 epochs straight,
    then 1 epoch and a ``--resume`` to 2; the two last checkpoints hold the
    same parameters, Adam state, epoch, losses and plateau scale, bit for
    bit."""
    import contextlib
    import io

    import torch

    from graph_transformer_tpu_torch.cli import train_sup
    from graph_transformer_tpu_torch.train.checkpoint import (
        latest_checkpoint, restore_checkpoint)

    t0 = time.perf_counter()
    base = TENFOLD_FLAGS + ["--data_dir", data, "--device", "cuda",
                            "--checkpoint_every", "1",
                            "--run_folder", os.path.join(root, "runs")]
    dirs = {k: os.path.join(root, "resume", k) for k in ("straight", "cut")}
    with contextlib.redirect_stdout(io.StringIO()):
        train_sup.main(base + ["--num_epochs", "2", "--checkpoint_dir",
                               dirs["straight"]])
        train_sup.main(base + ["--num_epochs", "1", "--checkpoint_dir",
                               dirs["cut"]])
        train_sup.main(base + ["--num_epochs", "2", "--resume",
                               "--checkpoint_dir", dirs["cut"]])
    a, b = (restore_checkpoint(latest_checkpoint(d)) for d in dirs.values())
    same = all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1]["mu"] + a[1]["nu"],
                                          b[1]["mu"] + b[1]["nu"]))
    same &= (a[1]["count"], a[1]["lr_scale"]) == (b[1]["count"],
                                                  b[1]["lr_scale"])
    same &= (a[2]["epoch"], a[2]["losses"]) == (b[2]["epoch"], b[2]["losses"])
    print(f"# train_sup resume: epoch {b[2]['epoch']}, losses "
          f"{b[2]['losses']}, Adam count {b[1]['count']}, lr_scale "
          f"{b[1]['lr_scale']}; equal to the straight run: {same}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not same:
        fail("train_sup: the resumed run's checkpoint differs from the "
             "straight run's")


def cv_phases(ds, data, root) -> dict:
    """Slice 14's phases on the PTC-like dataset ``ds`` with learnable
    labels (written to ``data``), each timed: the 10-fold CLI, the
    fold-looped runner against the sequential one, the on-device CV's
    resume, and ``cli.train_sup``'s resume."""
    out = {}
    for name, fn in (("cli", lambda: cv_cli(ds, data)),
                     ("runners", lambda: cv_runners(ds)),
                     ("on_device", lambda: cv_on_device_resume(ds, root)),
                     ("train_sup", lambda: train_sup_resume(data, root))):
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"# phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    fold_epoch = {"sequential (CLI)": out["cli"]["s"] / 20,
                  "fold-looped": out["runners"]["vmap_s_epoch"]
                  / out["runners"]["folds"],
                  "on-device": out["on_device"]["s_epoch"] / 2}
    print("# seconds a fold-epoch (x 10 for a 10-fold CV epoch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in fold_epoch.items()), flush=True)
    out["fold_epoch_s"] = fold_epoch
    return out


# ---------------------------------------------------- the unsupervised path
def unsup_config(flags, **model):
    """The config ``cli.train_unsup`` builds from ``flags``, with ``model``
    fields replaced."""
    import dataclasses

    from graph_transformer_tpu_torch.cli import train_unsup

    cfg = train_unsup.parse_config(flags + ["--device", "cuda"])[1]
    return cfg.replace(model=dataclasses.replace(cfg.model, **model))


def unsup_data(root) -> tuple:
    """(IMDBBINARY-like dataset, its directory) under ``root``."""
    from graph_transformer_tpu_torch.data.tu import load_tu_dataset

    data = write_imdb_like_tu(os.path.join(root, "data"))
    ds = load_tu_dataset("IMDBBINARY", data_dir=data)
    describe("unsup IMDBBINARY-like", ds)
    return ds, data


def check_unsup_kernels(ds, dev) -> dict:
    """The unsupervised path's kernels against their plain versions at its
    own shapes, with the trainer's initial weights: on a training batch of
    the README's unsup command (2 graphs, K=8, T=1, ff 1024, float32 degree
    tags of D=68), K7's stage (:func:`check_neighborhoods`), then K4tw and
    K8ws on the rows K7 drew (:func:`check_two_pass`: the float32 forward
    rule, every gradient leaf at cosine > 0.999); on the same batch with
    the fused flags, K13w with K8ws (:func:`check_fused_sampled`).  Returns
    the errors keyed as the other cases'."""
    import torch

    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        sample_neighborhoods)
    from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

    t = UnsupTrainer(ds, unsup_config(UNSUP_FLAGS), device="cuda")
    if t.fused or t.host_sampling:
        fail("the README's unsup command does not take the two-pass path")
    K, T1 = t.cfg.data.num_neighbors, t.cfg.model.num_timesteps
    S, D = K + 1, ds.feature_dim
    batch = t.builder.sample().to(dev)
    errs = {("K7", 0.0, "unsup batch"): check_neighborhoods(
        "unsup batch", t._nbr_table, t._deg, t._x_global, batch, K, 77)}
    feat = sample_neighborhoods(77, t._nbr_table, t._deg, t._x_global,
                                batch.node_gidx, batch.node_mask, K)[0]
    x2d = feat.reshape(-1, D)
    if x2d.dtype != torch.float32 or D <= 32:
        fail(f"the unsup rows are {x2d.dtype} of D={D}, not float32 past 32")
    params = [p.detach() for p in t.model.encoders[0].stacked()]
    errs.update({(k, r, "unsup"): v for (k, r), v in check_two_pass(
        "unsup float32", params, x2d, S, T1, dev).items()})
    tf = UnsupTrainer(ds, unsup_config(UNSUP_FLAGS, **FUSED_FLAGS),
                      device="cuda")
    if not tf.fused:
        fail("the unsup fused flags do not take the fused path")
    g = batch.node_gidx.long()
    si = (tf._tag_table[g], tf._deg[g], tf._tags[g], tf._codebook)
    errs.update({(k, r, "unsup fused"): v for (k, r), v in
                 check_fused_sampled("unsup fused", si, params, S, T1,
                                     dev).items()})
    print(f"# check unsup: training batch N={batch.n_pad} x S={S}, D={D}, "
          f"T={T1}, ff {params[6].shape[2]}, V={ds.num_nodes}", flush=True)
    return errs


def check_unsup_softmax(ds, dev) -> dict:
    """The sampled softmax on the card against a float64 recomputation on
    the host at the same candidates, both modes, at the IMDBBINARY-like
    vocabulary (the exact sampler) and at 40,000 nodes (the fast one): the
    card's candidate ids (and ``valid``) equal the CPU's for the same seed;
    per-example losses within 1e-4 of their largest magnitude and the
    gradients of inputs, weight and bias at cosine > 0.9999.  Times the
    card's loss and backward.  Returns {(V, mode): (max_rel_err, ms)}."""
    import torch

    from graph_transformer_tpu_torch.ops import sampled_softmax as ss
    from graph_transformer_tpu_torch.sampling.log_uniform import (
        LogUniformSpec, probs_table)

    out = {}
    B, Dz = 384, ds.feature_dim
    for V in (ds.num_nodes, 40_000):
        spec = LogUniformSpec.create(V, 512)
        gen = torch.Generator().manual_seed(V)
        x = torch.randn(B, Dz, generator=gen)
        w = torch.randn(V, Dz, generator=gen) * 0.1
        b = torch.randn(V, generator=gen) * 0.1
        labels = torch.cat([torch.arange(8), torch.randint(0, V, (B - 8,),
                                                           generator=gen)])
        mask = (torch.arange(B) < B - 40).float()
        seed = 4321 + V
        ids_d, valid_d = ss.draw_candidates(seed, spec, dev)
        ids_h, valid_h = ss.draw_candidates(seed, spec, "cpu")
        if not (torch.equal(ids_d.cpu(), ids_h)
                and (valid_h is None) == (valid_d is None)
                and (valid_h is None or torch.equal(valid_d.cpu(), valid_h))):
            fail(f"sampled softmax V={V}: the card's candidates differ from "
                 "the CPU's")
        for mode in ("tf", "reference"):
            def run(dv, dtype, probs=None):
                ts = [t.to(dv, dtype).clone().requires_grad_(True)
                      for t in (x, w, b)]
                ids = ids_h.to(dv)
                valid = None if valid_h is None else valid_h.to(dv)
                loss = ss.loss_given(ts[1], ts[2], ts[0], labels.to(dv), ids,
                                     valid, spec, mode, mask.to(dv, dtype),
                                     probs)
                loss.sum().backward()
                return [loss.detach()] + [
                    torch.zeros_like(t) if t.grad is None else t.grad
                    for t in ts]

            got = run(dev, torch.float32)
            ref = run("cpu", torch.float64,
                      probs_table(V, "cpu").to(torch.float64))
            rel = float((got[0].cpu().double() - ref[0]).abs().max()
                        / ref[0].abs().max())
            cos = [cosine(a.cpu().double(), r) for a, r in zip(got[1:],
                                                               ref[1:])
                   if r.abs().max() > 0]
            if not (rel < 1e-4 and min(cos) > 0.9999):
                fail(f"sampled softmax V={V} {mode}: loss rel err {rel:.3e},"
                     f" gradient cosines {cos}")
            ms = time_ms(lambda: run(dev, torch.float32), 20)
            out[(V, mode)] = (rel, ms)
            print(f"# check sampled softmax V={V} {mode}: candidates equal "
                  f"to the CPU's ({'fast, ' + str(int(valid_h.sum())) + ' valid' if valid_h is not None else 'exact'}"
                  f"), loss max rel err {rel:.3e} against float64, lowest "
                  f"gradient cosine {min(cos):.8f}; loss and backward "
                  f"{ms:.4f} ms at B={B}, D={Dz}", flush=True)
    return out


def unsup_counts(label, launches, steps, want) -> None:
    """Launches a step exactly ``want`` ({kernel: per step}) and no other
    kernel."""
    got = {k: v for k, v in launches.items() if v}
    exp = {k: v * steps for k, v in want.items()}
    print(f"# {label} launches over {steps} steps: {got}; a step: "
          + ", ".join(f"{k} {launches[k] / steps:g}" for k in want),
          flush=True)
    if got != exp:
        fail(f"{label}: launches {got}, expected {exp}")


def unsup_cli(data, root) -> dict:
    """The README's unsup command through ``cli.train_unsup.main`` for 2
    epochs on the card, every launch count set to 0 just before and read
    just after: finite falling epoch losses, the probe's mean ± std (the
    labels are random: no gate), seconds an epoch, ms a step and exactly
    K7, K4tw and K8ws once a step."""
    import contextlib
    import io
    import re

    import torch

    from graph_transformer_tpu_torch.cli import train_unsup

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        mean, std = train_unsup.main(UNSUP_FLAGS + [
            "--num_epochs", "2", "--device", "cuda", "--data_dir", data,
            "--run_folder", os.path.join(root, "runs")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for line in log.getvalue().splitlines():
        print(f"# cli: {line}", flush=True)
    losses = [float(v) for v in
              re.findall(r"\| loss\s+(\S+) \|", log.getvalue())]
    epoch_s = [float(v) for v in re.findall(r"\| (\S+)s$", log.getvalue(),
                                            re.M)]
    steps = launches["K7"]
    if len(losses) != 2 or not np.all(np.isfinite(losses)) \
            or not losses[1] < losses[0]:
        fail(f"unsup CLI epoch losses {losses}")
    if not 0.0 <= mean <= 1.0:
        fail(f"unsup CLI probe mean {mean}")
    unsup_counts("unsup CLI", launches, 1000,
                 {"K7": 1, "K4tw": 1, "K8ws": 1})
    print(f"# unsup CLI: losses {losses}, probe {mean:.4f} ± {std:.4f} "
          f"(random labels); {secs:.1f} s for 2 epochs, seconds an epoch "
          f"(probe included) {epoch_s}", flush=True)
    return {"losses": losses, "mean": mean, "std": std, "s": secs,
            "epoch_s": epoch_s, "steps": steps}


def unsup_steps(label, ds, cfg, want, n=20) -> dict:
    """``n`` steps of an ``UnsupTrainer`` on the card, each on a new batch,
    every launch count set to 0 just before and read just after (after 3
    warm-up steps): finite losses, the launches ``want`` a step exactly,
    and the ms a step by CUDA events."""
    import torch

    from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

    t = UnsupTrainer(ds, cfg, device="cuda")
    t.train_batches(3)
    torch.cuda.synchronize()
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    total = t.train_batches(n)
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(total)):
        fail(f"{label}: loss {float(total)}")
    launches = {k: c.launches for k, c in counters.items()}
    unsup_counts(label, launches, n, want)
    ms = start.elapsed_time(end) / n
    print(f"# {label}: {ms:.3f} ms a step (new batch each step), "
          f"V={ds.num_nodes}, D={ds.feature_dim}, N={t.builder.n_pad}",
          flush=True)
    return {"trainer": t, "ms": ms, "launches": launches}


def unsup_repeat(ds, n=5) -> None:
    """Two trainers of the README's unsup command, ``n`` steps each from
    the same seeds: every parameter and Adam moment equal bit for bit
    (the output table's gradient gathers from ``W[labels]`` and
    ``W[sample_ids]`` scatter into [V, D])."""
    import torch

    from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

    runs = []
    for _ in range(2):
        t = UnsupTrainer(ds, unsup_config(UNSUP_FLAGS), device="cuda")
        loss = t.train_batches(n)
        torch.cuda.synchronize()
        runs.append((float(loss), [p.detach().clone()
                                   for p in t.model.parameters()],
                     [m.clone() for m in t.opt.mu + t.opt.nu]))
    (la, pa, ma), (lb, pb, mb) = runs
    same = la == lb and all(torch.equal(a, b) for a, b in zip(pa + ma,
                                                                pb + mb))
    if not same:
        diff = [n_ for n_, a, b in zip(
            [n_ for n_, _ in t.model.named_parameters()], pa, pb)
            if not torch.equal(a, b)]
        fail(f"two unsup runs of {n} steps differ: losses {la} {lb}, "
             f"parameters {diff}")
    print(f"# unsup: two runs of {n} steps equal bit for bit (loss {la}, "
          f"{len(pa)} parameters and their Adam moments)", flush=True)


def unsup_accuracy(data_cv, root) -> dict:
    """``cli.train_unsup.main`` with ``UNSUP_ACC_FLAGS`` on the PTC-like
    file with learnable labels: fails unless the best probe mean is at
    least ``UNSUP_MIN_MEAN``."""
    import contextlib
    import io

    from graph_transformer_tpu_torch.cli import train_unsup

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        mean, std = train_unsup.main(
            ["--dataset", "PTC", "--data_dir", data_cv, "--device", "cuda",
             "--run_folder", os.path.join(root, "runs_acc")]
            + UNSUP_ACC_FLAGS)
    secs = time.perf_counter() - t0
    for line in log.getvalue().splitlines():
        print(f"# cli: {line}", flush=True)
    print(f"# unsup accuracy on learnable labels: best {mean:.4f} ± "
          f"{std:.4f} (gate {UNSUP_MIN_MEAN}; the CPU test reads 0.8376), "
          f"{secs:.1f} s", flush=True)
    if not mean >= UNSUP_MIN_MEAN:
        fail(f"unsup probe mean {mean:.4f} < {UNSUP_MIN_MEAN}")
    return {"mean": mean, "std": std, "s": secs}


def unsup_phases(data_cv, root, dev) -> tuple:
    """The unsupervised path's phases: its kernels at its shapes, the sampled
    softmax, the README's unsup command through the CLI with a profile of
    20 steps, 20 steps each of the fused flags, two U2GNN layers and a
    vocabulary past 32,768, two runs bit for bit, and the probe's gate on
    the PTC-like file.  Returns (errors by kernel, numbers)."""
    import torch

    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset

    ds, data = unsup_data(root)
    out = {}
    t0 = time.perf_counter()
    errs = check_unsup_kernels(ds, dev)
    out["softmax"] = {f"{v}_{m}": r for (v, m), r in
                      check_unsup_softmax(ds, dev).items()}
    out["cli"] = unsup_cli(data, root)
    runs = {
        "readme": (ds, unsup_config(UNSUP_FLAGS),
                   {"K7": 1, "K4tw": 1, "K8ws": 1}),
        "fused": (ds, unsup_config(UNSUP_FLAGS, **FUSED_FLAGS),
                  {"K13": 1, "K8ws": 1}),
        "two layers": (ds, unsup_config(UNSUP_FLAGS, num_hidden_layers=2),
                       {"K7": 1, "K4tw": 2, "K8ws": 2})}
    big = synthetic_powerlaw_dataset("V40k", num_graphs=2000, num_classes=2,
                                     mean_nodes=20, seed=15,
                                     reddit_like=False)
    describe("unsup V > 32,768", big)
    if big.num_nodes <= 32_768 or big.feature_dim > 32:
        fail(f"the large vocabulary has {big.num_nodes} nodes of D="
             f"{big.feature_dim}")
    runs["V > 32,768"] = (big, unsup_config(UNSUP_FLAGS),
                          {"K7": 1, "K4t": 1, "K8s": 1})
    steps = {}
    for name, (d, cfg, want) in runs.items():
        steps[name] = unsup_steps(f"unsup {name}", d, cfg, want)
    out["ms_per_step"] = {k: v["ms"] for k, v in steps.items()}
    t = steps["readme"]["trainer"]
    out["profile"] = profile_busy(lambda: t.train_batches(20), 20)
    unsup_repeat(ds)
    out["accuracy"] = unsup_accuracy(data_cv, root)
    print(f"# unsup phases: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    return errs, out


def timed_steps(trainer, batch, edges: float) -> tuple:
    """(ms/step, edges/s) of ``train_steps(batch, STEPS)`` after WARMUP
    steps, by CUDA events; fails on a loss that is not finite, and on the
    two-pass path unless each step launched K7 once (its sampling stage)
    and no other sampler."""
    import torch

    from graph_transformer_tpu_torch.sampling import neighbor_table as nt

    trainer.train_steps(batch, WARMUP)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k7 = (nt.sample_neighborhoods.launches, nt.sample_neighbors.launches)
    start.record()
    losses = trainer.train_steps(batch, STEPS)
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(losses).all()):
        fail(f"losses not finite: {losses}")
    k7 = (nt.sample_neighborhoods.launches - k7[0],
          nt.sample_neighbors.launches - k7[1])
    if trainer.two_pass and not trainer.host_sampling and k7 != (STEPS, 0):
        fail(f"{STEPS} two-pass steps launched K7 {k7[0]} times by "
             f"sample_neighborhoods and {k7[1]} by sample_neighbors")
    ms = start.elapsed_time(end) / STEPS
    return ms, edges * 1e3 / ms


def bound(b, f, flop_rate=BF16_FLOP_PER_S):
    """The least time (ms) for ``b`` bytes and ``f`` product operations at
    ``flop_rate``: bf16 products on the tensor cores, float32 products on
    the CUDA cores."""
    tb, tf = b / HBM_BYTES_PER_S * 1e3, f / flop_rate * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def layer_flops(rows_q, rows_kv, S, D, F):
    """bf16 product FLOPs of one encoder layer with ``rows_q`` query rows
    and ``rows_kv`` key/value rows."""
    return (2 * D * 3 * D * rows_kv
            + rows_q * (4 * S * D + 2 * D * D + 4 * D * F))


def fwd_flops(N, S, D, F, Tn):
    return ((Tn - 1) * layer_flops(N * S, N * S, S, D, F)
            + layer_flops(N, N * S, S, D, F))


# the wide forward's tensor-core instantiations, bf16 rows of 32 < D <= 80
# (mangled names: KT = 4, 5; KT = 0, float32 rows and the other D, runs on
# the CUDA cores)
WIDE_FWD = tuple(f"wd_encoder_fwd_kernelILi{kt}E" for kt in (4, 5))
# the thread-per-row forward layer's instantiations, D <= 4, 8, 16, 32: the
# forward kernel of K1, K4, K4t, K13, K15, K16 (H = false) and K17 (H =
# true), K9's and K8/K8s/K10's recompute forward (mangled template
# arguments)
DMS = (4, 8, 16, 32)
NARROW_FWD = tuple(f"gt_encoder_fwd_kernelILi{dm}ELb0EE" for dm in DMS)
NARROW_FWD_H = tuple(f"gt_encoder_fwd_kernelILi{dm}ELb1EE" for dm in DMS)
K9_FWD = tuple(f"gt_layer_fwd_kernelILi{dm}EE" for dm in DMS)
RECOMPUTE_FWD = tuple(f"gt_recompute_fwd_kernelILi{dm}ELb{s}EE"
                      for dm in DMS for s in (0, 1))
# the kernels whose products run on the tensor cores, by library: the wide
# forward (the wide K4, K4tw, K9w, K5, K13w, K17 with bf16 rows), the
# thread-per-row forward layer at few rows, the wide recompute backward's
# row kernel and K6's, K11/K12 and the split-K weight products, and the
# thread-per-row backwards (K2/K3, K8/K8s/K10, K14) with their FFN
MMA_KERNELS = {
    "recompute_bwd": ("wd_recompute_bwd_kernel", "gt_layer_bwd_kernel",
                      "wd_wgrad_mma_kernel") + RECOMPUTE_FWD,
    "encoder_layer": ("wd_recompute_bwd_kernel", "gt_layer_bwd_kernel")
    + WIDE_FWD + K9_FWD + RECOMPUTE_FWD[::2],
    "wide_fwd": WIDE_FWD, "stored_fwd": WIDE_FWD + NARROW_FWD_H,
    "fused_sampled_fwd": WIDE_FWD + NARROW_FWD,
    "encoder_fwd": NARROW_FWD, "sampled_fwd": NARROW_FWD,
    "folded_fwd": NARROW_FWD,
    "ffn": ("ff_fwd_kernel", "ff_bwd_kernel", "wd_wgrad_mma_kernel"),
    "stored_bwd": ("wd_stored_bwd_kernel", "wd_wgrad_mma_kernel"),
    "layer_bwd": ("gt_layer_bwd_kernel",),
    "mega_bwd": ("gt_mega_bwd_kernel", "wd_mega_bwd_kernel"),
}


def hmma_counts(_build) -> dict:
    """HMMA (tensor-core) instructions in the SASS of each kernel of
    MMA_KERNELS (``cuobjdump -sass`` of the built library), by library and
    instantiation; fails where one holds none or a kernel is missing."""
    counts = {}
    for name, kernels in MMA_KERNELS.items():
        funcs = sass_functions(_build.lib_path(name))
        for func, insts in funcs.items():
            if any(k in func for k in kernels):
                counts[(name, func)] = sum("HMMA" in op for _, op, _, _ in insts)
        missing = [k for k in kernels
                   if not any(k in f for (n, f) in counts if n == name)]
        if missing:
            fail(f"{name}: no SASS function of {missing}")
    if not all(counts.values()):
        fail(f"tensor-core kernels without HMMA instructions: {counts}")
    for (name, func), n in counts.items():
        print(f"# SASS {name}: {n} HMMA instructions in {func}", flush=True)
    return counts


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from graph_transformer_tpu_torch.cli.common import (
        base_parser, config_from_args)
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import ffn
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder, u2gnn_encoder_plain, u2gnn_encoder_train,
        u2gnn_encoder_train_plain, wide_encoder, wide_encoder_train)
    from graph_transformer_tpu_torch.sampling.neighbor_table import (
        sample_neighborhoods, sample_neighborhoods_plain)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()

    # ---- 1. build
    build_s = _build.build_all(verbose=True)
    print(f"# build: {build_s:.1f} s for {len(_build.SOURCES)} sources",
          flush=True)
    hmma_counts(_build)

    # ---- main-path objects (bench workload, bench.py:65-105)
    ds = synthetic_powerlaw_dataset("REDDITMULTI5K-like", num_graphs=64,
                                    mean_nodes=509, seed=0)
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=BATCH, num_neighbors=K),
        model=ModelConfig(num_timesteps=T, num_hidden_layers=1,
                          ff_hidden_size=FF, compute_dtype="bfloat16",
                          use_pallas=True, use_pallas_whole_encoder=True,
                          use_fused_sampler=True, use_stored_bwd=True,
                          use_folded=True),
        train=TrainConfig(num_epochs=1))
    trainer = SupTrainer(ds, cfg, train_idx=np.arange(ds.num_graphs),
                         test_idx=np.arange(8), device="cuda")
    batch = trainer.builder.sample()
    edges_per_step = float(batch.edge_mask.sum())
    batch = batch.to(dev)
    si = trainer.sampled_inputs(batch)
    params = [p.detach() for p in trainer.model.encoders[0].stacked()]
    S = K + 1
    D = ds.feature_dim
    N = batch.n_pad
    eval_batch = next(trainer.builder.eval_batches(trainer.test_idx))[0].to(dev)
    x2d_eval = eval_batch.x.to(torch.bfloat16)[eval_batch.neigh.long()] \
        .reshape(-1, D)

    # ---- 2. kernels vs plain versions
    t0 = time.perf_counter()
    errs = check_kernels("bench", si, params, x2d_eval, S, T, dev)
    si_m, params_m, x2d_m = random_case(N=1000, S=S, D=7, C=7, F=FF, Tn=T,
                                        stored=1, seed=3, dev=dev)
    errs.update({(k, r, "m"): v for (k, r), v in check_kernels(
        "mutag-like", si_m, params_m, x2d_m, S, T, dev).items()})
    _, params_p, x2d_p = random_case(N=200, S=S, D=19, C=19, F=FF, Tn=T,
                                     stored=1, seed=3, dev=dev)
    check_k4_f32("ptc-width", params_p, x2d_p, S, T)
    # K5/K6 at IMDBBINARY's width (one-hot codebook), at D=128 and at PTC's
    # K=16 shape; then against K1-K3 where both paths run
    for label, S_, D_, one_hot in (("imdb-width", S, 65, True),
                                   ("d128", S, 128, False),
                                   ("ptc-k16", 17, 19, False)):
        si_w, params_w, _ = random_case(N=4096, S=S_, D=D_, C=D_, F=FF,
                                        Tn=T, stored=T, seed=4, dev=dev,
                                        one_hot=one_hot)
        errs.update({(k, r, label): v for (k, r), v in check_stored(
            label, si_w, params_w, S_, T, dev).items()})
    check_paths("mutag-like", si_m, params_m, S, T, dev)
    # the wide K4 in float32 (its logic) and bf16 (bf16's own spread)
    for D_ in (65, 128):
        _, params_w, x2d_w = random_case(N=512, S=S, D=D_, C=D_, F=FF, Tn=T,
                                         stored=1, seed=5, dev=dev)
        errs[("K4w", 0.0, D_)] = check_k4_f32(f"wide-d{D_}", params_w,
                                             x2d_w, S, T)
    # slice 3: K7 on a heavy-tailed graph (hubs past 128) at the HPO arm's
    # K=16 and at K=8; K4t and K8/K8s at the HPO arm's shape (S=17, D=7,
    # T=5), the ENZYMES-attribute shape (S=9, D=18, T=4) and the
    # shared-memory edge (S=32, D=32), in float32 and bf16; the two-pass
    # path against K1-K3 at one layer
    ds_h = synthetic_powerlaw_dataset("heavy-tail", num_graphs=24,
                                      mean_nodes=300, seed=1,
                                      reddit_like=False, heavy_tail=True)
    for K_ in (16, 8):
        errs[("K7", 0.0, K_)] = check_sampler(f"sampler-k{K_}", ds_h, K_, 31,
                                             dev)
    for label, S_, D_, T_ in (("hpo-arm", 17, 7, 5), ("enzymes-attr", 9, 18, 4),
                              ("edge-s32-d32", 32, 32, 2)):
        _, params_t, x2d_t = random_case(N=4096, S=S_, D=D_, C=D_, F=FF,
                                         Tn=T_, stored=T_, seed=6, dev=dev)
        for dt in (torch.float32, torch.bfloat16):
            errs.update({(k, r, label, str(dt)): v for (k, r), v in
                         check_two_pass(f"{label} {dt}", params_t,
                                        x2d_t.to(dt), S_, T_, dev).items()})
    check_two_pass_vs_fused("mutag-like", si_m, params_m, S, T, dev)
    # slice 14: the 10-fold path's K7, K4t, K8s, K8 and K4 at its own
    # shapes, on the PTC-like file its phases (section 10) train on
    ds_cv, data_cv = cv_data(os.path.join(here, "build", "tenfold"))
    errs.update(check_cv_kernels(ds_cv, dev))
    # K4t, K8, K8s at the HPO arm's own rows (512 x S=17, D=6, T=5) and K9,
    # K10 at ACT's (512 x S=9, D=7), float32 and bf16: blocks of two
    # neighborhoods that fill the card
    _, params_t, x2d_t = random_case(N=512, S=17, D=6, C=6, F=FF, Tn=5,
                                     stored=5, seed=15, dev=dev)
    _, params_l, x2d_l = random_case(N=512, S=9, D=7, C=7, F=FF, Tn=1,
                                     stored=1, seed=16, dev=dev)
    for dt in (torch.float32, torch.bfloat16):
        errs.update({(k, r, "hpo-arm rows", str(dt)): v for (k, r), v in
                     check_two_pass(f"hpo-arm rows {dt}", params_t,
                                    x2d_t.to(dt), 17, 5, dev).items()})
        errs.update({(k, r, "act rows", str(dt)): v for (k, r), v in
                     check_encoder_layer(f"act rows {dt}", params_l,
                                         x2d_l.to(dt), 9, dev).items()})
    # slice 4: K9/K10 at (S, D) = (9, 7), (17, 19), (32, 32), N=4096; K11/K12
    # at D = 4, 68 and 128 over 36,864 rows; in float32 and bf16; then T
    # launches of K9 against K4
    for label, S_, D_ in (("s9-d7", 9, 7), ("s17-d19", 17, 19),
                          ("s32-d32", 32, 32)):
        _, params_l, x2d_l = random_case(N=4096, S=S_, D=D_, C=D_, F=FF,
                                         Tn=1, stored=1, seed=7, dev=dev)
        for dt in (torch.float32, torch.bfloat16):
            errs.update({(k, r, label, str(dt)): v for (k, r), v in
                         check_encoder_layer(f"{label} {dt}", params_l,
                                             x2d_l.to(dt), S_, dev).items()})
    for D_ in (4, 68, 128):
        for dt in (torch.float32, torch.bfloat16):
            errs.update({(k, r, D_, str(dt)): v for (k, r), v in check_ffn(
                f"ffn-d{D_} {dt}", 36864, D_, FF, dt, dev).items()})
    _, params_v, x2d_v = random_case(N=1000, S=S, D=7, C=7, F=FF, Tn=T,
                                     stored=T, seed=8, dev=dev)
    errs[("K9", 0.0, "vs-K4")] = check_per_layer_vs_whole(
        "mutag-like", params_v, x2d_v, S, T)
    # slice 5: K4tw, K8w/K8ws (T=3) and K9w/K10w at D = 40, 68 and 128,
    # N=4096, in float32 and bf16, K4tw's saved inputs against K9w; K13
    # against its plain version and bit for
    # bit against K1 (the MUTAG-like case, D=7) and K5 (one-hot D=68)
    for D_ in (40, 68, 128):
        _, params_w, x2d_w = random_case(N=4096, S=S, D=D_, C=D_, F=FF, Tn=3,
                                         stored=3, seed=9, dev=dev)
        for dt in (torch.float32, torch.bfloat16):
            label = f"wide-d{D_} {dt}"
            errs.update({(k, r, label): v for (k, r), v in check_two_pass(
                label, params_w, x2d_w.to(dt), S, 3, dev).items()})
            errs.update({(k, r, label): v for (k, r), v in
                         check_encoder_layer(label, params_w, x2d_w.to(dt), S,
                                             dev).items()})
            check_saved_inputs_are_layers(label, params_w, x2d_w.to(dt), S, 3,
                                          dev)
    errs.update({(k, r, "m"): v for (k, r), v in check_fused_sampled(
        "mutag-like", si_m, params_m, S, T, dev).items()})
    si_68, params_68, _ = random_case(N=4096, S=S, D=68, C=68, F=FF, Tn=T,
                                      stored=T, seed=10, dev=dev, one_hot=True)
    errs.update({(k, r, "d68"): v for (k, r), v in check_fused_sampled(
        "imdb-width-68", si_68, params_68, S, T, dev).items()})
    # slice 6: K14 against the K8 chain and its plain version at (S, D, T) =
    # (9, 4, 4) and (17, 19, 4), K14w at D = 40, 68, 128 (T=3), weight-tied
    # or not, float32 and bf16; K15/K16 against K1 (the bench's rows and
    # the MUTAG-like case), K17 against K5 (MUTAG-like, one-hot D=68) and
    # in float32; K13 with K14/K14w against K13 with its chain
    for S_, D_, T_, st_ in ((9, 4, 4, 4), (9, 4, 4, 1), (17, 19, 4, 4),
                            (17, 19, 4, 1), (9, 40, 3, 3), (9, 68, 3, 3),
                            (9, 68, 3, 1), (9, 128, 3, 3)):
        _, params_g, x2d_g = random_case(N=2048, S=S_, D=D_, C=D_, F=FF,
                                         Tn=T_, stored=st_, seed=13, dev=dev)
        for dt in (torch.float32, torch.bfloat16):
            label = f"mega s{S_}-d{D_} stored {st_} {dt}"
            errs.update({(k, r, label): v for (k, r), v in check_mega(
                label, params_g, x2d_g.to(dt), S_, T_, dev).items()})
    for label, si_f, params_f in (("bench", si, params),
                                  ("mutag-like", si_m, params_m)):
        errs.update({(k, r, label): v for (k, r), v in check_folded(
            label, si_f, params_f, S, T, dev).items()})
    for label, si_s, params_s in (("mutag-like", si_m, params_m),
                                  ("imdb-width-68", si_68, params_68)):
        errs.update({(k, r, label): v for (k, r), v in check_stored_rows(
            label, si_s, params_s, S, T, dev).items()})
    for D_ in (7, 68):
        _, params_r, x2d_r = random_case(N=2048, S=S, D=D_, C=D_, F=FF, Tn=T,
                                         stored=T, seed=14, dev=dev)
        label = f"stored rows d{D_} float32"
        errs.update({(k, r, label): v for (k, r), v in check_stored_rows_f32(
            label, params_r, x2d_r.float(), S, T, dev).items()})
    check_fused_mega("mutag-like", si_m, params_m, S, T, dev)
    check_fused_mega("imdb-width-68", si_68, params_68, S, T, dev)
    print(f"# kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    floor = hash_floor(si, params, S, T, 20260, dev)
    print(f"# hash floor: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. the main path of slice 1: the bench workload on K1-K4
    trainer.train_steps(batch, WARMUP)
    torch.cuda.synchronize()
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = trainer.train_steps(batch, STEPS)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS
    acc = trainer.evaluate()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"# main path launches: {launches}", flush=True)
    losses = losses.float().cpu()
    if losses.shape != (STEPS,) or not bool(torch.isfinite(losses).all()):
        fail(f"losses not finite: {losses}")
    if not 0.0 <= acc <= 1.0:
        fail(f"accuracy {acc}")
    want = {"K1": STEPS, "K2": (T - 1) * STEPS, "K3": STEPS}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"{k} launched {launches[k]} times, expected {v}")
    if launches["K4"] < 1:
        fail("K4 was not launched at eval")
    eps = edges_per_step * STEPS / (step_ms * STEPS / 1e3)
    print(f"# train: {step_ms:.3f} ms/step, {eps:.1f} edges/s "
          f"({edges_per_step:.0f} edges/step, N={N}), loss "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, eval acc "
          f"{acc:.4f}", flush=True)

    profile_busy(lambda: trainer.train_steps(batch, 5), 5)

    # ---- 4. the main paths of slices 2 and 5: the README quickstart on
    # wide rows through the CLI (the two-pass path in float32), also with two
    # U2GNN layers and with ACT
    t0 = time.perf_counter()
    ds_q, launches_q = quickstart(os.path.join(here, "build", "quickstart"))
    print(f"# quickstart runs through the CLI: {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    for name in ("quickstart", "quickstart act"):
        for k in QUICKSTART_RUNS[name][1][1:]:
            launches[k] = launches_q[name][k]
    cfg_q = config_from_args(base_parser("q").parse_args(
        QUICKSTART_FLAGS + ["--num_epochs", "2"]))
    trainer_q = SupTrainer(ds_q, cfg_q, device="cuda")
    batch_q = trainer_q.builder.sample()
    edges_q = float(batch_q.edge_mask.sum())
    batch_q = batch_q.to(dev)
    if not trainer_q.two_pass:
        fail("the quickstart does not take the two-pass path")
    errs[("K7", 0.0, "quickstart batch")] = check_neighborhoods(
        "quickstart batch", trainer_q._nbr_table, trainer_q._deg,
        trainer_q._x_global, batch_q, K, 77)
    step_ms_q, eps_q = timed_steps(trainer_q, batch_q, edges_q)
    print(f"# quickstart train: {step_ms_q:.3f} ms/step, {eps_q:.1f} edges/s "
          f"({edges_q:.0f} edges/step, N={batch_q.n_pad}, "
          f"D={ds_q.feature_dim}, float32)", flush=True)
    prof_q = profile_busy(lambda: trainer_q.train_steps(batch_q, 5), 5)

    # ---- 5. the main paths of slice 3: the two-pass path through the CLI
    t0 = time.perf_counter()
    dsets_2, launches_2 = two_pass_runs(os.path.join(here, "build",
                                                     "two_pass"))
    print(f"# two-pass runs through the CLI: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for k in TWO_PASS_KERNELS:
        launches[k] = launches_2["MUTAG"][k]
    # the HPO arm's step at 16 graphs a batch
    cfg_h = config_from_args(base_parser("h").parse_args(
        TWO_PASS_FLAGS["MUTAG"] + ["--batch_size", "16"]))
    trainer_h = SupTrainer(dsets_2["MUTAG"], cfg_h, device="cuda")
    if not trainer_h.two_pass:
        fail("the HPO arm does not take the two-pass path")
    batch_h = trainer_h.builder.sample()
    edges_h = float(batch_h.edge_mask.sum())
    batch_h = batch_h.to(dev)
    errs[("K7", 0.0, "hpo-arm batch")] = check_neighborhoods(
        "hpo-arm batch", trainer_h._nbr_table, trainer_h._deg,
        trainer_h._x_global, batch_h, cfg_h.data.num_neighbors, 77)
    step_ms_h, eps_h = timed_steps(trainer_h, batch_h, edges_h)
    print(f"# hpo-arm train (16 graphs a batch): {step_ms_h:.3f} ms/step, "
          f"{eps_h:.1f} edges/s ({edges_h:.0f} edges/step, "
          f"N={batch_h.n_pad}, D={dsets_2['MUTAG'].feature_dim})", flush=True)
    profile_busy(lambda: trainer_h.train_steps(batch_h, 5), 5)

    # ---- 6. the main paths of slice 4: the per-layer encoder through the
    # CLI (ACT on MUTAG-like data; the quickstart on the node axis), short
    # runs of the other recurrences and of two heads
    t0 = time.perf_counter()
    dsets_4, launches_4 = per_layer_runs(os.path.join(here, "build",
                                                      "per_layer"))
    for name, want in PER_LAYER_WANT.items():
        for k in want[1:]:
            launches[k] = launches_4[name][k]
    short_runs(dsets_4["act"], dsets_2["ENZYMES"])
    print(f"# per-layer runs: {time.perf_counter() - t0:.1f} s", flush=True)
    # the ACT step at 16 graphs a batch, as the HPO arm is timed; the
    # node-axis quickstart step
    steps_4 = {}
    for name, extra in (("act", ["--batch_size", "16"]), ("node", [])):
        cfg_4 = config_from_args(base_parser(name).parse_args(
            PER_LAYER_FLAGS[name] + extra))
        trainer_4 = SupTrainer(dsets_4[name], cfg_4, device="cuda")
        if not trainer_4.two_pass:
            fail(f"{name} does not take the two-pass path")
        batch_4 = trainer_4.builder.sample()
        edges_4 = float(batch_4.edge_mask.sum())
        batch_4 = batch_4.to(dev)
        errs[("K7", 0.0, f"{name} batch")] = check_neighborhoods(
            f"{name} batch", trainer_4._nbr_table, trainer_4._deg,
            trainer_4._x_global, batch_4, cfg_4.data.num_neighbors, 77)
        ms_4, eps_4 = timed_steps(trainer_4, batch_4, edges_4)
        print(f"# {name} train: {ms_4:.3f} ms/step, {eps_4:.1f} edges/s "
              f"({edges_4:.0f} edges/step, N={batch_4.n_pad}, "
              f"D={dsets_4[name].feature_dim})", flush=True)
        prof_4 = profile_busy(lambda: trainer_4.train_steps(batch_4, 5), 5)
        steps_4[name] = dict(trainer=trainer_4, batch=batch_4, ms=ms_4,
                             eps=eps_4, profile=prof_4)

    # ---- 7. the config paths of slice 5: the fused path's three flags
    # without use_folded or use_stored_bwd (K13 with the recompute backward)
    # on the bench workload and on the quickstart file, and with
    # use_stored_bwd (K5/K6) on the quickstart file
    t0 = time.perf_counter()
    runs_5 = {
        "bench K13": config_run(
            "bench K13", ds, cfg.replace(model=dataclasses.replace(
                cfg.model, use_stored_bwd=False, use_folded=False)),
            ("K13", "K8", "K8s", "K4"), dev, trainer.train_idx,
            trainer.test_idx),
        "quickstart K13": config_run(
            "quickstart K13", ds_q, cfg_q.replace(model=dataclasses.replace(
                cfg_q.model, **FUSED_FLAGS)),
            ("K13", "K8w", "K8ws", "K4w"), dev),
        "quickstart stored": config_run(
            "quickstart stored", ds_q, cfg_q.replace(
                model=dataclasses.replace(cfg_q.model, use_stored_bwd=True,
                                          **FUSED_FLAGS)),
            ("K5", "K6", "K6s", "K4w"), dev)}
    print(f"# config runs: {time.perf_counter() - t0:.1f} s", flush=True)
    launches["K13"] = runs_5["bench K13"]["launches"]["K13"]
    launches["K13w"] = runs_5["quickstart K13"]["launches"]["K13"]
    for k in ("K5", "K6", "K6s"):
        launches[k] = runs_5["quickstart stored"]["launches"][k]

    # ---- 8. the main path of slice 6: the encoder's forward and backward
    # variants at the A/B scripts' workload and at the quickstart's width
    t0 = time.perf_counter()
    launches_v, cases_v, errs_v = encoder_variants(dev)
    errs.update(errs_v)
    print(f"# encoder variants: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in ("K14", "K14w", "K15", "K16", "K17"):
        launches[k] = launches_v[k]

    # ---- 9. per-kernel times at each main path's shapes
    seed = 99
    out_k, res_k = se.sampled_forward(*si, params, S, T, 0.5, seed)
    g3 = torch.randn(N, D, device=dev)
    g2 = torch.randn(N, S, D, device=dev)
    a3 = (res_k["xs"][T - 1], res_k["qkv"][T - 1], res_k["attn"][T - 1],
          res_k["strip"][T - 1], g3)
    a2 = (res_k["xs"][0], res_k["qkv"][0], res_k["attn"][0],
          res_k["strip"][0], g2)
    p_last = [a[(T - 1) % a.shape[0]] for a in params]
    p_0 = [a[0] for a in params]
    Ne = x2d_eval.shape[0] // S
    F = FF
    P = sum(p[0].numel() for p in params)
    pbytes = nbytes(*params)
    # of the [N, 128] tag rows, K1 and K5 read only the K drawn entries
    k1_bytes = (nbytes(*si[1:]) + N * K * si[0].element_size() + pbytes
                + nbytes(out_k, res_k["draws"].int())
                + sum(nbytes(t) for k in ("xs", "qkv", "attn", "strip")
                      for t in res_k[k]))
    k2_flops = N * S * (10 * D * F + 4 * D * 3 * D + 4 * D * D + 8 * S * D)
    k2_bytes = nbytes(*a2) + pbytes + nbytes(g2) + 4 * P
    k3_flops = (N * (10 * D * F + 4 * D * D + 8 * S * D)
                + N * S * 4 * D * 3 * D)
    k3_bytes = nbytes(*a3) + pbytes + nbytes(g2) + 4 * P
    k4_flops = fwd_flops(Ne, S, D, F, T)
    k4_bytes = nbytes(x2d_eval) + pbytes + Ne * D * 4

    # the quickstart's shapes: the stored config run's training batch
    # (K5/K6), the first eval batch (K4w, float32 rows as the model's default
    # compute dtype gives them)
    tr_qs = runs_5["quickstart stored"]["trainer"]
    b_qs = runs_5["quickstart stored"]["batch"]
    si_q = tr_qs.sampled_inputs(b_qs)
    params_q = [p.detach() for p in tr_qs.model.encoders[0].stacked()]
    Dq, Nq = ds_q.feature_dim, b_qs.n_pad
    Pq = sum(p[0].numel() for p in params_q)
    pbytes_q = nbytes(*params_q)
    out5, res5 = st.stored_forward(*si_q, params_q, S, T, 0.5, seed)
    g6s = torch.randn(Nq, Dq, device=dev)
    g6 = torch.randn(Nq, S, Dq, device=dev)
    a6s = tuple(res5[k][T - 1] for k in ("xs", "qkv", "attn", "strip", "h")) \
        + (g6s,)
    a6 = tuple(res5[k][0] for k in ("xs", "qkv", "attn", "strip", "h")) \
        + (g6,)
    pq_last = [a[(T - 1) % a.shape[0]] for a in params_q]
    pq_0 = [a[0] for a in params_q]
    eb = next(trainer_q.builder.eval_batches(trainer_q.test_idx))[0].to(dev)
    x2d_q = eb.x.to(torch.float32)[eb.neigh.long()].reshape(-1, Dq)
    Neq = x2d_q.shape[0] // S
    k5_bytes = (nbytes(*si_q[1:]) + Nq * K * si_q[0].element_size()
                + pbytes_q + nbytes(out5, res5["draws"].int())
                + sum(nbytes(t) for k in ("xs", "qkv", "attn", "strip", "h")
                      for t in res5[k]))
    k5_flops = fwd_flops(Nq, S, Dq, F, T)
    k6_flops = Nq * S * (8 * Dq * F + 4 * Dq * 3 * Dq + 4 * Dq * Dq
                         + 8 * S * Dq)
    k6_bytes = nbytes(*a6) + pbytes_q + nbytes(g6) + 4 * Pq
    k6s_flops = (Nq * (8 * Dq * F + 4 * Dq * Dq + 8 * S * Dq)
                 + Nq * S * 4 * Dq * 3 * Dq)
    k6s_bytes = nbytes(*a6s) + pbytes_q + nbytes(g6) + 4 * Pq
    k4w_flops = fwd_flops(Neq, S, Dq, F, T)
    k4w_bytes = nbytes(x2d_q) + pbytes_q + Neq * Dq * 4

    # the quickstart's two-pass shapes (float32 rows, its training batch,
    # U2GNN layer 0): K4tw, K8w and K8ws; K9w and K10w (the ACT run's
    # layer) over the same rows
    Nt = batch_q.n_pad
    x2d_tw = sample_neighborhoods(
        seed, trainer_q._nbr_table, trainer_q._deg, trainer_q._x_global,
        *trainer_q.two_pass_inputs(batch_q), K)[0].reshape(Nt * S, Dq)
    params_tw = [p.detach() for p in trainer_q.model.encoders[0].stacked()]
    out_tw, xs_tw = wide_encoder_train(x2d_tw, params_tw, S, T, 0.5, seed)
    x8w = x2d_tw.view(Nt, S, Dq)
    x8ws = xs_tw[-1].view(Nt, S, Dq)
    g8w = torch.randn(Nt, S, Dq, device=dev)
    g8ws = torch.randn(Nt, Dq, device=dev)
    ptw_0 = [a[0] for a in params_tw]
    ptw_last = [a[(T - 1) % a.shape[0]] for a in params_tw]
    k4tw_bytes = nbytes(x2d_tw, out_tw, xs_tw) + nbytes(*params_tw)
    k4tw_flops = fwd_flops(Nt, S, Dq, F, T)
    k8w_bytes = nbytes(x8w, g8w) + nbytes(g8w) + 2 * 4 * Pq
    k8w_flops = (layer_flops(Nt * S, Nt * S, S, Dq, F)
                 + Nt * S * (8 * Dq * F + 4 * Dq * 3 * Dq + 4 * Dq * Dq
                             + 8 * S * Dq))
    k8ws_bytes = nbytes(x8ws, g8ws) + nbytes(g8w) + 2 * 4 * Pq
    k8ws_flops = (layer_flops(Nt, Nt * S, S, Dq, F)
                  + Nt * (8 * Dq * F + 4 * Dq * Dq + 8 * S * Dq)
                  + Nt * S * 4 * Dq * 3 * Dq)
    g10w = torch.randn(Nt * S, Dq, device=dev)
    k9w_bytes = 2 * nbytes(x2d_tw) + nbytes(*ptw_0)
    k9w_flops = layer_flops(Nt * S, Nt * S, S, Dq, F)
    k10w_bytes = nbytes(x2d_tw, g10w, g10w) + 2 * 4 * Pq
    k10w_flops = k9w_flops + Nt * S * (8 * Dq * F + 4 * Dq * 3 * Dq
                                       + 4 * Dq * Dq + 8 * S * Dq)
    lib_tw = library_encoder(params_tw, S, T, Dq, F, dev, torch.float32, 0.5)
    lib_9w = library_encoder([p[None] for p in ptw_0], S, 1, Dq, F, dev,
                             torch.float32, 0.5).layers[0]

    # K13 at the bench workload's training batch (D=4) and at the
    # quickstart K13 run's (D=68)
    k13 = {}
    for key, run in (("K13", "bench K13"), ("K13w", "quickstart K13")):
        tr, b = runs_5[run]["trainer"], runs_5[run]["batch"]
        si_k = tr.sampled_inputs(b)
        p_k = [p.detach() for p in tr.model.encoders[0].stacked()]
        o_k, xs_k, d_k = fs.fused_sampled_forward(*si_k, p_k, S, T, 0.5, seed)
        n_k, d_dim = b.n_pad, si_k[3].shape[1]
        k13[key] = dict(
            si=si_k, params=p_k, x0=xs_k[0].view(n_k, S, d_dim),
            bytes=(nbytes(*si_k[1:]) + n_k * K * si_k[0].element_size()
                   + nbytes(*p_k) + nbytes(o_k, xs_k, d_k.int())),
            flops=fwd_flops(n_k, S, d_dim, F, T))

    # the HPO arm's shapes (two-pass, float32 rows and products): the
    # training batch of 16 graphs, U2GNN layer 0
    Kh, Th = cfg_h.data.num_neighbors, cfg_h.model.num_timesteps
    Sh, Dh, Nh = Kh + 1, dsets_2["MUTAG"].feature_dim, batch_h.n_pad
    params_h = [p.detach() for p in trainer_h.model.encoders[0].stacked()]
    Ph = sum(p[0].numel() for p in params_h)
    k7_args = (seed, trainer_h._nbr_table, trainer_h._deg,
               trainer_h._x_global, *trainer_h.two_pass_inputs(batch_h), Kh)
    out_k7 = sample_neighborhoods(*k7_args, with_ids=True)
    x2d_h = out_k7[0].reshape(Nh * Sh, Dh)
    out_t, xs_t = u2gnn_encoder_train(x2d_h, params_h, Sh, Th, 0.5, seed)
    x8 = x2d_h.view(Nh, Sh, Dh)
    x8s = xs_t[-1].view(Nh, Sh, Dh)
    g8 = torch.randn(Nh, Sh, Dh, device=dev)
    g8s = torch.randn(Nh, Dh, device=dev)
    ph_0 = [a[0] for a in params_h]
    ph_last = [a[(Th - 1) % a.shape[0]] for a in params_h]
    k7_b = k7_bytes(trainer_h._nbr_table, trainer_h._deg, trainer_h._x_global,
                    batch_h, Kh, seed, out_k7)
    k4t_bytes = nbytes(x2d_h, out_t, xs_t) + nbytes(*params_h)
    k4t_flops = fwd_flops(Nh, Sh, Dh, F, Th)
    # K8/K8s read x, g and the layer's parameters and write dx (the size of
    # g8) and the gradients; their operations are the layer's forward and
    # its backward (K6's count)
    k8_bytes = nbytes(x8, g8) + nbytes(g8) + 2 * 4 * Ph
    k8_flops = (layer_flops(Nh * Sh, Nh * Sh, Sh, Dh, F)
                + Nh * Sh * (8 * Dh * F + 4 * Dh * 3 * Dh + 4 * Dh * Dh
                             + 8 * Sh * Dh))
    k8s_bytes = nbytes(x8s, g8s) + nbytes(g8) + 2 * 4 * Ph
    k8s_flops = (layer_flops(Nh, Nh * Sh, Sh, Dh, F)
                 + Nh * (8 * Dh * F + 4 * Dh * Dh + 8 * Sh * Dh)
                 + Nh * Sh * 4 * Dh * 3 * Dh)

    # the ACT step's shapes (16 graphs, float32 rows, U2GNN layer 0's first
    # timestep): K9 and K10; the node-axis quickstart's: K11 and K12 over
    # (K+1) x N_pad rows
    tr_a, b_a = steps_4["act"]["trainer"], steps_4["act"]["batch"]
    Da, Na = dsets_4["act"].feature_dim, b_a.n_pad
    x9 = sample_neighborhoods(seed, tr_a._nbr_table, tr_a._deg, tr_a._x_global,
                              *tr_a.two_pass_inputs(b_a), K)[0] \
        .reshape(Na * S, Da)
    p9 = [p.detach()[0] for p in tr_a.model.encoders[0].stacked()]
    g10 = torch.randn(Na * S, Da, device=dev)
    P9 = sum(p.numel() for p in p9)
    k9_bytes = 2 * nbytes(x9) + nbytes(*p9)
    k9_flops = layer_flops(Na * S, Na * S, S, Da, F)
    k10_bytes = nbytes(x9, g10, g10) + 2 * 4 * P9
    k10_flops = k9_flops + Na * S * (8 * Da * F + 4 * Da * 3 * Da
                                     + 4 * Da * Da + 8 * S * Da)
    tr_n, b_n = steps_4["node"]["trainer"], steps_4["node"]["batch"]
    Dn, Mn = dsets_4["node"].feature_dim, S * b_n.n_pad
    enc_n = tr_n.model.encoders[0]
    p11 = [getattr(enc_n, k).detach()[0] for k in (
        "w_ff1", "b_ff1", "w_ff2", "b_ff2", "ln2_scale", "ln2_bias")]
    x11 = torch.randn(Mn, Dn, device=dev)
    g12 = torch.randn(Mn, Dn, device=dev)
    k11_bytes = 2 * nbytes(x11) + nbytes(*p11)
    k11_flops = 4 * Mn * Dn * F
    k12_bytes = nbytes(x11, g12, g12) + 2 * nbytes(*p11)
    k12_flops = 12 * Mn * Dn * F
    lib_a = library_encoder([p[None] for p in p9], S, 1, Da, F, dev,
                            torch.float32, 0.5).layers[0]
    x3_a = x9.view(Na, S, Da)

    # this slice's shapes: the encoder variants at the A/B workload (K14,
    # K15, K16, K17; bf16 rows) and at the quickstart's width (K14w)
    Nv, Sv, Tv = AB_ROWS["N"], AB_ROWS["S"], AB_ROWS["Tn"]
    mega = {}
    for key, case in (("K14", cases_v["ab"]), ("K14w", cases_v["wide"])):
        p_v, x_v, Dv = case["params"], case["x2d"], case["D"]
        _, xs_v = u2gnn_encoder_train(x_v, p_v, Sv, Tv, 0.5, seed)
        full = (layer_flops(Nv * Sv, Nv * Sv, Sv, Dv, F)
                + Nv * Sv * (8 * Dv * F + 4 * Dv * 3 * Dv + 4 * Dv * Dv
                             + 8 * Sv * Dv))
        slot0 = (layer_flops(Nv, Nv * Sv, Sv, Dv, F)
                 + Nv * (8 * Dv * F + 4 * Dv * Dv + 8 * Sv * Dv)
                 + Nv * Sv * 4 * Dv * 3 * Dv)
        mega[key] = dict(
            args=(x_v, xs_v, case["w"], p_v, Sv, Tv, 0.5, seed),
            bytes=(nbytes(x_v, xs_v, case["w"]) + 2 * nbytes(*p_v)
                   + Nv * Sv * Dv * 4),
            flops=(Tv - 1) * full + slot0)
    p_ab, x_ab = cases_v["ab"]["params"], cases_v["ab"]["x2d"]
    Dv = cases_v["ab"]["D"]
    x3_ab = x_ab.view(Nv, Sv, Dv)
    out15, res15 = fe.folded_stored_forward(x_ab, p_ab, Sv, Tv, 0.5, seed)
    out17, res17 = st.stored_rows_forward(x_ab, p_ab, Sv, Tv, 0.5, seed)
    v_in = nbytes(x_ab) + nbytes(*p_ab)
    k15_bytes = v_in + nbytes(out15) + sum(
        nbytes(t) for k in ("xs", "qkv", "attn", "strip") for t in res15[k])
    k16_bytes = v_in + nbytes(out15)
    k17_bytes = v_in + nbytes(out17) + sum(
        nbytes(t) for k in ("qkv", "attn", "strip", "h") for t in res17[k]) \
        + sum(nbytes(t) for t in res17["xs"][1:])
    v_flops = fwd_flops(Nv, Sv, Dv, F, Tv)
    lib_ab = library_encoder(p_ab, Sv, Tv, Dv, F, dev, torch.bfloat16, 0.5)

    lib = library_encoder(params, S, T, D, F, dev)
    x3d = x2d_eval.view(Ne, S, D)
    x0_k1 = res_k["xs"][0].view(N, S, D)  # K1's gathered rows
    lib_q = library_encoder(params_q, S, T, Dq, F, dev)
    x3d_q = x2d_q.to(torch.bfloat16).view(Neq, S, Dq)
    x0_q = res5["xs"][0]
    lib_h = library_encoder(params_h, Sh, Th, Dh, F, dev, torch.float32, 0.5)
    with torch.no_grad():
        for name, lb, x3, ko in (
                ("K4", lib, x3d, u2gnn_encoder(x2d_eval, params, S, T)),
                ("K4w", lib_q, x3d_q, wide_encoder(x2d_q, params_q, S, T))):
            diff = float((lb(x3)[:, 0].float() - ko).abs().max())
            print(f"# library TransformerEncoder vs {name} slot-0 max|diff| "
                  f"{diff:.3e}", flush=True)
        calls = {
            "K1": (lambda: se.sampled_forward(*si, params, S, T, 0.5, seed),
                   lambda: se.sampled_forward_plain(*si, params, S, T, 0.5, seed),
                   lambda: lib(x0_k1)),
            "K2": (lambda: se.layer_backward(*a2, params, 0, 0.5, seed),
                   lambda: se.layer_backward_plain(*a2, p_0, layer=0, rate=0.5,
                                                   seed=seed),
                   None),
            "K3": (lambda: se.slot0_backward(*a3, params, T - 1, 0.5, seed),
                   lambda: se.slot0_backward_plain(*a3, p_last, layer=T - 1,
                                                   rate=0.5, seed=seed),
                   None),
            "K4": (lambda: u2gnn_encoder(x2d_eval, params, S, T),
                   lambda: u2gnn_encoder_plain(x2d_eval, params, S, T),
                   lambda: lib(x3d)),
            "K4w": (lambda: wide_encoder(x2d_q, params_q, S, T),
                    lambda: u2gnn_encoder_plain(x2d_q, params_q, S, T),
                    lambda: lib_q(x3d_q)),
            "K5": (lambda: st.stored_forward(*si_q, params_q, S, T, 0.5, seed),
                   lambda: st.stored_forward_plain(*si_q, params_q, S, T, 0.5,
                                                   seed),
                   lambda: lib_q(x0_q)),
            "K6": (lambda: st.stored_layer_backward(*a6, params_q, 0, 0.5,
                                                    seed),
                   lambda: st.stored_layer_backward_plain(
                       *a6, pq_0, layer=0, rate=0.5, seed=seed),
                   None),
            "K6s": (lambda: st.stored_slot0_backward(*a6s, params_q, T - 1,
                                                     0.5, seed),
                    lambda: st.stored_layer_backward_plain(
                        *a6s, pq_last, layer=T - 1, rate=0.5, seed=seed,
                        slot0=True),
                    None),
            "K7": (lambda: sample_neighborhoods(*k7_args),
                   lambda: sample_neighborhoods_plain(*k7_args),
                   None),
            "K4t": (lambda: u2gnn_encoder_train(x2d_h, params_h, Sh, Th, 0.5,
                                                seed),
                    lambda: u2gnn_encoder_train_plain(x2d_h, params_h, Sh, Th,
                                                      0.5, seed),
                    lambda: lib_h(x8)),
            "K8": (lambda: ut.layer_recompute_backward(x8, g8, params_h, 0,
                                                       0.5, seed),
                   lambda: ut.layer_recompute_backward_plain(
                       x8, g8, ph_0, layer=0, rate=0.5, seed=seed,
                       mm=torch.float32, slot0=False),
                   None),
            "K8s": (lambda: ut.slot0_recompute_backward(x8s, g8s, params_h,
                                                        Th - 1, 0.5, seed),
                    lambda: ut.layer_recompute_backward_plain(
                        x8s, g8s, ph_last, layer=Th - 1, rate=0.5, seed=seed,
                        mm=torch.float32, slot0=True),
                    None),
            "K9": (lambda: el.encoder_layer_forward(x9, p9, S, 0.5, seed),
                   lambda: el.encoder_layer_forward_plain(x9, p9, S, 0.5,
                                                          seed),
                   lambda: lib_a(x3_a)),
            "K10": (lambda: el.encoder_layer_backward(x9, g10, p9, S, 0.5,
                                                      seed),
                    lambda: el.encoder_layer_backward_plain(x9, g10, p9, S,
                                                            0.5, seed),
                    None),
            "K11": (lambda: ffn.ffn_forward(x11, *p11, rate=0.5, seed=seed),
                    lambda: ffn.ffn_forward_plain(x11, *p11, rate=0.5,
                                                  seed=seed),
                    None),
            "K12": (lambda: ffn.ffn_backward(x11, g12, *p11, rate=0.5,
                                             seed=seed),
                    lambda: ffn.ffn_backward_plain(x11, g12, *p11, rate=0.5,
                                                   seed=seed),
                    None),
            "K4tw": (lambda: wide_encoder_train(x2d_tw, params_tw, S, T, 0.5,
                                                seed),
                     lambda: u2gnn_encoder_train_plain(x2d_tw, params_tw, S,
                                                       T, 0.5, seed),
                     lambda: lib_tw(x8w)),
            "K8w": (lambda: ut.wide_layer_recompute_backward(
                        x8w, g8w, params_tw, 0, 0.5, seed),
                    lambda: ut.layer_recompute_backward_plain(
                        x8w, g8w, ptw_0, layer=0, rate=0.5, seed=seed,
                        mm=torch.float32, slot0=False),
                    None),
            "K8ws": (lambda: ut.wide_slot0_recompute_backward(
                         x8ws, g8ws, params_tw, T - 1, 0.5, seed),
                     lambda: ut.layer_recompute_backward_plain(
                         x8ws, g8ws, ptw_last, layer=T - 1, rate=0.5,
                         seed=seed, mm=torch.float32, slot0=True),
                     None),
            "K9w": (lambda: el.wide_encoder_layer_forward(x2d_tw, ptw_0, S,
                                                          0.5, seed),
                    lambda: el.encoder_layer_forward_plain(x2d_tw, ptw_0, S,
                                                           0.5, seed),
                    lambda: lib_9w(x8w)),
            "K10w": (lambda: el.wide_encoder_layer_backward(
                         x2d_tw, g10w, ptw_0, S, 0.5, seed),
                     lambda: el.encoder_layer_backward_plain(
                         x2d_tw, g10w, ptw_0, S, 0.5, seed),
                     None),
            "K13": (lambda: fs.fused_sampled_forward(
                        *k13["K13"]["si"], k13["K13"]["params"], S, T, 0.5,
                        seed),
                    lambda: fs.fused_sampled_forward_plain(
                        *k13["K13"]["si"], k13["K13"]["params"], S, T, 0.5,
                        seed),
                    lambda: lib(k13["K13"]["x0"])),
            "K13w": (lambda: fs.fused_sampled_forward(
                         *k13["K13w"]["si"], k13["K13w"]["params"], S, T, 0.5,
                         seed),
                     lambda: fs.fused_sampled_forward_plain(
                         *k13["K13w"]["si"], k13["K13w"]["params"], S, T,
                         0.5, seed),
                     lambda: lib_q(k13["K13w"]["x0"])),
            "K14": (lambda: ut.mega_recompute_backward(*mega["K14"]["args"]),
                    lambda: ut.mega_recompute_backward_plain(
                        *mega["K14"]["args"]),
                    None),
            "K14w": (lambda: ut.mega_recompute_backward(
                         *mega["K14w"]["args"]),
                     lambda: ut.mega_recompute_backward_plain(
                         *mega["K14w"]["args"]),
                     None),
            "K15": (lambda: fe.folded_stored_forward(x_ab, p_ab, Sv, Tv, 0.5,
                                                     seed),
                    lambda: fe.folded_stored_forward_plain(
                        x_ab, p_ab, Sv, Tv, 0.5, seed),
                    lambda: lib_ab(x3_ab)),
            "K16": (lambda: fe.folded_forward(x_ab, p_ab, Sv, Tv, 0.5, seed),
                    lambda: fe.folded_forward_plain(x_ab, p_ab, Sv, Tv, 0.5,
                                                    seed),
                    lambda: lib_ab(x3_ab)),
            "K17": (lambda: st.stored_rows_forward(x_ab, p_ab, Sv, Tv, 0.5,
                                                   seed),
                    lambda: st.stored_rows_forward_plain(x_ab, p_ab, Sv, Tv,
                                                         0.5, seed),
                    lambda: lib_ab(x3_ab)),
        }
        # each wrapper's kernels: the backward kernels include their
        # partial sums (and K6, K8w ... their split-K weight products)
        wgrad = ("wd_wgrad_mma_kernel", "wd_wgrad_reduce_kernel")
        k6_kernels = ("wd_stored_bwd_kernel",) + wgrad
        k8_kernels = ("gt_recompute_fwd_kernel", "gt_layer_bwd_kernel",
                      "gt_reduce_partials_kernel")
        k8w_kernels = ("wd_recompute_bwd_kernel",) + wgrad
        device_kernels = {
            "K1": ("gt_encoder_fwd_kernel",), "K4": ("gt_encoder_fwd_kernel",),
            "K2": ("gt_layer_bwd_kernel", "gt_reduce_partials_kernel"),
            "K3": ("gt_layer_bwd_kernel", "gt_reduce_partials_kernel"),
            "K4w": ("wd_encoder_fwd_kernel",), "K5": ("wd_encoder_fwd_kernel",),
            "K6": k6_kernels, "K6s": k6_kernels,
            "K7": ("gt_sample_kernel",), "K4t": ("gt_encoder_fwd_kernel",),
            "K8": k8_kernels, "K8s": k8_kernels,
            "K9": ("gt_layer_fwd_kernel",), "K10": k8_kernels,
            "K11": ("ff_fwd_kernel",),
            "K12": ("ff_bwd_kernel", "gt_reduce_partials_kernel") + wgrad,
            "K4tw": ("wd_encoder_fwd_kernel",), "K8w": k8w_kernels,
            "K8ws": k8w_kernels, "K9w": ("wd_encoder_fwd_kernel",),
            "K10w": k8w_kernels, "K13": ("gt_encoder_fwd_kernel",),
            "K13w": ("wd_encoder_fwd_kernel",),
            "K14": ("gt_mega_bwd_kernel", "gt_mega_reduce_kernel"),
            "K14w": ("wd_mega_bwd_kernel",) + wgrad
            + ("gt_mega_reduce_kernel",),
            "K15": ("gt_encoder_fwd_kernel",), "K16": ("gt_encoder_fwd_kernel",),
            "K17": ("gt_encoder_fwd_kernel", "wd_encoder_fwd_kernel")}
        timings = {
            key: (device_ms(kern, 10, device_kernels[key]), time_ms(kern, 10),
                  time_ms(plain, 3),
                  None if lib_call is None else time_ms(lib_call, 10))
            for key, (kern, plain, lib_call) in calls.items()}
        # the wide backwards and K12 split into the row kernel and the
        # split-K weight products with their partial sums
        parts = {key: (("wd_recompute_bwd_kernel",), wgrad)
                 for key in ("K8w", "K8ws", "K10w")}
        parts.update({key: (("wd_stored_bwd_kernel",), wgrad)
                      for key in ("K6", "K6s")})
        parts["K12"] = (("ff_bwd_kernel",), device_kernels["K12"][1:])
        split = {key: (device_ms(calls[key][0], 10, row),
                       device_ms(calls[key][0], 10, prod))
                 for key, (row, prod) in parts.items()}
        for key, (row_ms, prod_ms) in split.items():
            print(f"# {key}: row kernel {row_ms:.4f} ms, split-K weight "
                  f"products and partial sums {prod_ms:.4f} ms a launch",
                  flush=True)
    src = "graph_transformer_tpu_torch/ops/csrc/"
    bf, f32 = BF16_FLOP_PER_S, F32_FLOP_PER_S
    meta = {
        "K1": ("sampled_fwd", src + "sampled_fwd.cu",
               "graph_transformer_tpu/ops/pallas_folded.py:1094", k1_bytes,
               fwd_flops(N, S, D, F, T), bf),
        "K2": ("layer_bwd", src + "layer_bwd.cu",
               "graph_transformer_tpu/ops/pallas_folded.py:538", k2_bytes,
               k2_flops, bf),
        "K3": ("slot0_bwd", src + "layer_bwd.cu",
               "graph_transformer_tpu/ops/pallas_folded.py:683", k3_bytes,
               k3_flops, bf),
        "K4": ("encoder_fwd", src + "encoder_fwd.cu",
               "graph_transformer_tpu/ops/pallas_u2gnn.py:266", k4_bytes,
               k4_flops, bf),
        "K4w": ("wide_encoder_fwd", src + "wide_fwd.cu",
                "graph_transformer_tpu/ops/pallas_u2gnn.py:266", k4w_bytes,
                k4w_flops, f32),
        "K5": ("stored_fwd", src + "stored_fwd.cu",
               "graph_transformer_tpu/ops/pallas_stored_bwd.py:355", k5_bytes,
               k5_flops, bf),
        "K6": ("stored_layer_bwd", src + "stored_bwd.cu",
               "graph_transformer_tpu/ops/pallas_stored_bwd.py:192", k6_bytes,
               k6_flops, bf),
        "K6s": ("stored_slot0_bwd", src + "stored_bwd.cu",
                "graph_transformer_tpu/ops/pallas_stored_bwd.py:192",
                k6s_bytes, k6s_flops, bf),
        "K7": ("sample_neighborhoods", src + "sampler.cu",
               "graph_transformer_tpu/sampling/pallas_sampler.py:114",
               k7_b, 0, bf),
        "K4t": ("encoder_train_fwd", src + "encoder_fwd.cu",
                "graph_transformer_tpu/ops/pallas_u2gnn.py:266", k4t_bytes,
                k4t_flops, f32),
        "K8": ("recompute_layer_bwd", src + "recompute_bwd.cu",
               "graph_transformer_tpu/ops/pallas_u2gnn.py:316", k8_bytes,
               k8_flops, f32),
        "K8s": ("recompute_slot0_bwd", src + "recompute_bwd.cu",
                "graph_transformer_tpu/ops/pallas_u2gnn.py:316", k8s_bytes,
                k8s_flops, f32),
        "K9": ("encoder_layer_fwd", src + "encoder_layer.cu",
               "graph_transformer_tpu/ops/pallas_encoder.py:196", k9_bytes,
               k9_flops, f32),
        "K10": ("encoder_layer_bwd", src + "encoder_layer.cu",
                "graph_transformer_tpu/ops/pallas_encoder.py:214", k10_bytes,
                k10_flops, f32),
        "K11": ("ffn_fwd", src + "ffn.cu",
                "graph_transformer_tpu/ops/pallas_ffn.py:70", k11_bytes,
                k11_flops, f32),
        "K12": ("ffn_bwd", src + "ffn.cu",
                "graph_transformer_tpu/ops/pallas_ffn.py:97", k12_bytes,
                k12_flops, f32),
        "K4tw": ("wide_encoder_train_fwd", src + "wide_fwd.cu",
                 "graph_transformer_tpu/ops/pallas_u2gnn.py:266", k4tw_bytes,
                 k4tw_flops, f32),
        "K8w": ("wide_recompute_layer_bwd", src + "recompute_bwd.cu",
                "graph_transformer_tpu/ops/pallas_u2gnn.py:316", k8w_bytes,
                k8w_flops, f32),
        "K8ws": ("wide_recompute_slot0_bwd", src + "recompute_bwd.cu",
                 "graph_transformer_tpu/ops/pallas_u2gnn.py:316", k8ws_bytes,
                 k8ws_flops, f32),
        "K9w": ("wide_encoder_layer_fwd", src + "encoder_layer.cu",
                "graph_transformer_tpu/ops/pallas_encoder.py:196", k9w_bytes,
                k9w_flops, f32),
        "K10w": ("wide_encoder_layer_bwd", src + "encoder_layer.cu",
                 "graph_transformer_tpu/ops/pallas_encoder.py:214",
                 k10w_bytes, k10w_flops, f32),
        "K13": ("fused_sampled_fwd", src + "fused_sampled_fwd.cu",
                "graph_transformer_tpu/ops/pallas_sampled_encoder.py:139",
                k13["K13"]["bytes"], k13["K13"]["flops"], bf),
        "K13w": ("fused_sampled_fwd_wide", src + "fused_sampled_fwd.cu",
                 "graph_transformer_tpu/ops/pallas_sampled_encoder.py:139",
                 k13["K13w"]["bytes"], k13["K13w"]["flops"], bf),
        "K14": ("mega_bwd", src + "mega_bwd.cu",
                "graph_transformer_tpu/ops/pallas_u2gnn.py:284",
                mega["K14"]["bytes"], mega["K14"]["flops"], bf),
        "K14w": ("wide_mega_bwd", src + "mega_bwd.cu",
                 "graph_transformer_tpu/ops/pallas_u2gnn.py:284",
                 mega["K14w"]["bytes"], mega["K14w"]["flops"], bf),
        "K15": ("folded_stored_fwd", src + "folded_fwd.cu",
                "graph_transformer_tpu/ops/pallas_folded.py:502", k15_bytes,
                v_flops, bf),
        "K16": ("folded_fwd", src + "folded_fwd.cu",
                "graph_transformer_tpu/ops/pallas_folded.py:382", k16_bytes,
                v_flops, bf),
        "K17": ("stored_rows_fwd", src + "stored_fwd.cu",
                "graph_transformer_tpu/ops/pallas_stored_bwd.py:106",
                k17_bytes, v_flops, bf),
    }
    # ---- 9b. the unsupervised path (the README's unsup command through the
    # CLI, the fused flags, two U2GNN layers, a vocabulary past 32,768, the
    # probe on learnable labels); its kernel checks join the errors that the
    # kernel line reads
    errs_u, unsup = unsup_phases(data_cv, os.path.join(here, "build", "unsup"),
                                 dev)
    errs.update(errs_u)

    kernels = []
    for key, (name, source, replaces, b, f, rate) in meta.items():
        ms, wrapper_ms, plain_ms, lib_ms = timings[key]
        bms, by = bound(b, f, rate)
        errs_k = [v for k, v in errs.items() if k[0] == key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(e[0] for e in errs_k),
            "max_rel_err": max(e[1] for e in errs_k),
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "bytes": b, "flops": f,
            "excess_ms": launches[key] * (ms - bms),
            **({"row_ms": split[key][0], "products_ms": split[key][1]}
               if key in split else {})})
        print(f"# {key} {name}: {ms:.4f} ms/launch on the device (wrapper "
              f"{wrapper_ms:.4f}, plain {plain_ms:.4f}, "
              f"bound {bms:.5f} by {by}"
              + (f", library {lib_ms:.4f}" if lib_ms is not None else "")
              + ")", flush=True)
    # the speed queue's order: kernels slower than their library call
    # first, then launches x (ms - bound) on their main paths
    slower = [k["name"].split()[0] for k in kernels
              if k["library_ms"] is not None and k["ms"] > k["library_ms"]]
    queue = sorted(kernels, key=lambda k: -k["excess_ms"])
    print(f"# slower than their library call: {slower or 'none'}; launches x "
          "(ms - bound): " + ", ".join(f"{k['name'].split()[0]} "
                                       f"{k['excess_ms']:.1f}"
                                       for k in queue), flush=True)

    # ---- 10. the main paths of slice 14: the README's 10-fold command
    # through the CLI, the fold-looped runner against the sequential one,
    # the on-device CV's resume and cli.train_sup's, on a PTC-like file
    # with learnable labels.  Last of the device work: after its profiler
    # sessions CUPTI has recorded no device event in a later session on the
    # card (five sessions in a row)
    t0 = time.perf_counter()
    cv = cv_phases(ds_cv, data_cv, os.path.join(here, "build", "tenfold"))
    print(f"# 10-fold phases: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"# edges/s on the card: bench {eps:.1f}, quickstart {eps_q:.1f}, "
          f"hpo arm {eps_h:.1f}, act {steps_4['act']['eps']:.1f}, node axis "
          f"{steps_4['node']['eps']:.1f}, "
          + ", ".join(f"{k} {v['eps']:.1f}" for k, v in runs_5.items())
          + f"; whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    cells = {f"{name.replace(' ', '_')}_{k}": v
             for name, run in list(steps_4.items()) + list(runs_5.items())
             for k, v in (("edges_per_s", run["eps"]),
                          ("ms_per_step", run["ms"]),
                          ("profile", run["profile"]))}
    print(json.dumps({"kernels": kernels, "edges_per_s": eps,
                      "ms_per_step": step_ms,
                      "quickstart_edges_per_s": eps_q,
                      "quickstart_ms_per_step": step_ms_q,
                      "quickstart_profile": prof_q,
                      "hpo_arm_edges_per_s": eps_h,
                      "hpo_arm_ms_per_step": step_ms_h, **cells,
                      "tenfold": {k: {n: v for n, v in run.items()
                                      if n != "launches"}
                                  for k, run in cv.items() if run},
                      "unsup": unsup,
                      "hash_floor": floor,
                      "steps": STEPS, "build_s": build_s}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: rc {smi.returncode}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
