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
   0.75 and every loss is finite); ``TenfoldVmapRunner`` (section 9f's
   unsharded run: 10 folds, 2 epochs) against the CLI's ``SupTrainer`` a
   fold, each epoch equal bit for bit; ``run_cv_on_device`` on 2
   folds x 2 epochs in chunks of 1, killed after its first snapshot and
   resumed under ``run_cv_elastic``, equal bit for bit to the
   uninterrupted run, with its device busy share beside the sequential
   runner's; ``cli.train_sup`` with ``--checkpoint_every 1`` resumed,
   equal to a straight run (``cv_phases``).
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
9c. Drives the node path past D = 128 (``node_phases``, slice 16): K18,
   K19 and K20 against their plain versions at D = 160, 500, 1,433 and
   3,703 (2,816 neighborhoods of S = 5; 256 at 3,703), float32 and bf16,
   rates 0 and 0.5, each kernel's forward and the slot-0 layer's forward and
   recompute backward (the full layer too at D = 160): float32 forwards
   within 1e-4 and relative L2 1e-5, bf16 by ``check_bf16_spread``, every
   leaf at cosine > 0.999 and float32 leaves at relative L2 1e-4 (against
   the plain backward with the kernel's ReLU gates where the two forwards'
   pre-activations straddle 0, the count printed); the whole encoder at
   D = 160, T = 2 and the K9/K10 and K11/K12 routes against their plain
   versions; ``cli.train_node.main`` on Planetoid files of Cora's shape it
   writes under ``build/node/`` (``write_planetoid_like``): losses finite
   and falling, exactly K18 18, K19 3 and K20 5 launches a step and no
   other kernel, the best mask probe at least the test mask's majority
   share less 0.05; 20 node steps timed with a profile of 5, two 5-step
   runs bit for bit; K18 at each of the step's launches beside
   ``torch.addmm``/``mm``, K19 and K20 at one beside
   ``scaled_dot_product_attention`` and ``F.layer_norm``, and their
   backward launches beside their bounds.  Then the same in bf16
   (``NODE_BF16_FLAGS``): K18's bf16 products at each width in every
   layout and epilogue with the bf16 layer's operand types
   (``check_k18_bf16``), the CLI with every K18 launch in bf16 and the loss
   at fixed step seeds lower after training, 20 timed and 5 profiled steps,
   two 5-step runs bit for bit, and K18 at each launch beside one bf16
   ``torch.mm`` with a float32 result.
9d. Drives the multiplex path and the node baselines
   (``multiplex_phases``): K4t and K8s against their plain
   versions at the siamese step's shape (12,000 neighborhoods of S = 9,
   D = 8, F = 1,024, float32, rates 0 and 0.5); the geometric-mean
   Laplacian on the card against the same function on the CPU at the
   gaussian loader's N = 200, S = 4 (relative 1e-10, equal spectral
   metrics), then its iterations and seconds at mfeat's N = 2,000;
   ``cli.node_classification.main`` on UCI mfeat-shaped files it writes
   under ``build/multiplex/`` (``write_mfeat_like``: six views of the
   published widths, 2,000 rows in 10 classes) with the reference's setup
   (siamese, contrastive, k-means, the spectral baselines, 20 steps):
   finite losses, the trained loss below the initial one at fixed probe
   seeds, exactly K4t 1 and K8s 1 a step and no other kernel, the best
   k-means accuracy at least the JAX package's CPU reading less 0.05, the
   embeddings saved; multi mode with the GAE at T = 2 for 5 steps (K4t,
   K8s and K8 6 times a step); 20 steps timed with the host's
   neighborhood draws beside them, a profile of 5, two 5-step runs bit
   for bit; and ``cli.train_node`` with ``--node_model gcn`` and ``gat`` on
   the Cora-shaped files (20 steps, the default loss): finite losses, the
   trained loss below the initial one at the probe seeds, no kernel
   launched, ms a step, two 5-step runs bit for bit.
9e. Drives the remaining single-device modules (``slice19_phases``):
   ``BatchBuilder``'s host ms a batch with the C++ assembler (the default,
   whose draws are the JAX package's) and with numpy at the bench's shape;
   the graph-level GCN baseline (``UnsupTrainer(model="gcn_unsup")``, 2
   layers of H = 1,024 on the IMDBBINARY-like file): 20 steps timed by
   ``utils/profiling.StepTimer``, no kernel launched, the loss at the probe
   seeds lower after training, a profile of 5 steps, the probe, two 5-step
   runs bit for bit; OrthoNet fitted on the card and on the CPU on the
   Laplacian of the mfeat-shaped files' first view (N = 2,000), the
   histories, final losses and orthogonality within the stated tolerances;
   ``nn.TransformerEncoder`` against the port's encoder fed its converted
   weights (``utils/torch_compat``) on the card (K9w with one head, the
   plain attention and K11 with two) by the float32 rule; the README's HPO
   commands through ``cli.hpo.main``: 2 unsup trials of 1 epoch on the
   IMDBBINARY-like file twice (each trial's launches exactly K7, K4tw,
   K8ws and K8w by its arm; the two trial logs equal byte for byte) and 2
   node trials on the Cora-shaped files (K18-K20 only).
9f. Drives the parallel layer (``parallel_phases``; ``parallel/dryrun.py``'s
   four regimes): (a) ``dryrun_multichip(1, "nccl", "cuda")`` in this
   process, NCCL at world size 1 — regime 1 (U2GNNSup's batch sharded by
   node ranges, the FFN leaves over ``model``) at the bench's shapes in
   float32 at rate 0 against the model's own pass, then a bf16 step at rate
   0.5; regime 2 (the node-partitioned halo step) on the Cora-shaped files
   at K = 4, T = 1, ff 1024, two layers, 512 candidates against the step
   without a group; regime 3 (the overlapped halo step on the edge-balanced,
   padded partition) against the masked blocking one; regime 4 (the folds
   over ranks) unsharded on the PTC-like file, 10 folds, 2 epochs — then the
   group destroyed; (b) one job of 4 ranks over gloo sharing cuda:0 that
   load the kernels built here (regime 1 on a (2, 2) mesh, 2-3 on 4 node
   ranges, 4 on 2 ranks with 5 folds each), held to (a): losses within
   1e-5 relative, every gradient leaf at cosine > 0.999 and relative L2
   1e-4, each overlapped row equal bit for bit to the blocking one and
   the gradients within relative L2 1e-5, the folds' 2 epochs bit for
   bit, every regime's launches a step exact on every rank (K4t, K8s, 3
   K8; K18 32, K19 6, K20 10; twice that overlapped; K7, K4t, K8s, 2 K8 a
   step and K4 an eval batch); each rank's ms a step blocking and
   overlapped, one card shared by 4 ranks (not gated).
9g. Drives JAX's one-dispatch training (``replay_phases``; run after 9,
   before 9b): for the bench's fused flags, the README quickstart at full
   width, the MUTAG HPO arm (two U2GNN layers, 16 graphs a batch), ACT (16
   graphs) and the README's unsup command, on files under
   ``build/replay/``, 20 steps of the captured step replayed as a CUDA
   graph (``train/step_graph.py``, the first run capturing) against the
   same step run eagerly 20 times, from one saved state, one list of
   batches and one seed list: every loss and every parameter, moment and
   Adam count bit for bit (the first leaf that differs is named), equal
   launches a step; then each way's ms a step and edges/s by CUDA events,
   and its busy share and device operations a step over 5 profiled steps.
   Every ``train_steps`` of the sections above replays too, and the
   ``--scan_epochs`` CLI runs train through ``train_epoch_stacked``.
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


CORA_CLASS_SIZES = (351, 217, 418, 818, 426, 298, 180)  # 2,708 nodes


def write_planetoid_like(root, name="cora", num_feats=1433,
                         class_sizes=CORA_CLASS_SIZES, n_train=140,
                         n_val=500, n_test=1000, num_edges=5278,
                         words=18, class_words=200, own_word=0.6,
                         homophily=0.8, seed=0):
    """Write Planetoid files ``<root>/ind.<name>.{x,y,tx,ty,allx,ally,graph,
    test.index}`` of Cora's published shape at the defaults: 2,708 nodes in
    Cora's 7 class sizes, 1,433 binary features, ``n_train`` / ``n_val`` /
    ``n_test`` = 140 / 500 / 1,000 train, val and test nodes, 5,278
    undirected edges.  Learnable labels: a node's ``words`` words are drawn
    with probability ``own_word`` from its class's ``class_words`` (else from
    all), and an edge's second end shares the first's class with probability
    ``homophily``.  The byte format is the one ``tests/test_planetoid_loader.py``
    writes (pickled scipy sparse feature blocks, one-hot labels, the
    neighbor-dict graph, test ids in shuffled file order).  Node ids: the
    first ``n - n_test`` are ``allx`` (of which ``x`` the first
    ``n_train``), the last ``n_test`` the test nodes.  Returns the labels."""
    import pickle

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    C = len(class_sizes)
    labels = rng.permutation(np.repeat(np.arange(C), class_sizes))
    n = len(labels)
    vocab = [rng.choice(num_feats, class_words, replace=False)
             for _ in range(C)]
    feats = np.zeros((n, num_feats), np.float32)
    for v in range(n):
        own = rng.random(words) < own_word
        cols = np.where(own, rng.choice(vocab[labels[v]], words),
                        rng.integers(0, num_feats, words))
        feats[v, cols] = 1.0
    members = [np.nonzero(labels == c)[0] for c in range(C)]
    pairs = set()
    while len(pairs) < num_edges:
        u = int(rng.integers(n))
        v = int(rng.choice(members[labels[u]]) if rng.random() < homophily
                else rng.integers(n))
        if u != v:
            pairs.add((min(u, v), max(u, v)))
    graph = {v: [] for v in range(n)}
    for u, v in sorted(pairs):
        graph[u].append(v)
        graph[v].append(u)
    onehot = np.eye(C, dtype=np.float32)[labels]
    n_all = n - n_test
    test_ids = rng.permutation(np.arange(n_all, n))
    os.makedirs(root, exist_ok=True)

    def dump(suffix, obj):
        with open(os.path.join(root, f"ind.{name}.{suffix}"), "wb") as f:
            pickle.dump(obj, f)

    dump("x", sp.csr_matrix(feats[:n_train]))
    dump("y", onehot[:n_train])
    dump("allx", sp.csr_matrix(feats[:n_all]))
    dump("ally", onehot[:n_all])
    dump("tx", sp.csr_matrix(feats[test_ids]))
    dump("ty", onehot[test_ids])
    dump("graph", graph)
    with open(os.path.join(root, f"ind.{name}.test.index"), "w") as f:
        f.write("".join(f"{i}\n" for i in test_ids))
    assert n_train + n_val <= n_all
    return labels


# UCI "Multiple Features" (mfeat): six views of 2,000 handwritten digits,
# 10 classes in blocks of 200, each view a whitespace-separated file of its
# published width
MFEAT_WIDTHS = {"mfeat-fac": 216, "mfeat-fou": 76, "mfeat-kar": 64,
                "mfeat-mor": 6, "mfeat-pix": 240, "mfeat-zer": 47}


def write_mfeat_like(root, widths=MFEAT_WIDTHS, rows_per_class=200,
                     num_classes=10, spread=1.0, seed=0):
    """Write the six files of UCI mfeat under ``root`` at their published
    names and widths (``widths``): ``num_classes`` blocks of
    ``rows_per_class`` rows, each row its class's center (standard normal
    entries, one center a class and view) plus noise of std ``spread``, so
    that every view carries the labels.  Returns the labels."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(num_classes), rows_per_class)
    os.makedirs(root, exist_ok=True)
    for name, width in widths.items():
        centers = rng.standard_normal((num_classes, width))
        rows = centers[labels] + spread * rng.standard_normal(
            (len(labels), width))
        np.savetxt(os.path.join(root, name), rows, fmt="%.5f")
    return labels


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


def profile_busy(fn, n_steps: int, start_at: str = "", sum_of=()) -> None:
    """Trace ``fn()``, which runs ``n_steps`` training steps, with
    torch.profiler; print the device time of each kernel per step and the
    device's busy share (union of device-operation intervals over the span
    from the first one's start to the last one's end; with ``start_at``,
    from the first kernel whose name holds it, so that set-up copies are
    left out), and return the share, the device operations and the busy ms
    per step (with ``sum_of``, also the device ms a step of the kernels
    whose names hold one of those).  The profiler slows the host, so this
    share is a lower bound of the unprofiled one."""
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
    out = {"busy_share": busy / span, "ops_per_step": len(spans) / n_steps,
           "busy_ms_per_step": busy / n_steps / 1e3}
    if sum_of:
        out["ms_per_step_of"] = sum(us for n, us in by_name.items()
                                    if any(k in n for k in sum_of)
                                    ) / n_steps / 1e3
    return out


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
    from graph_transformer_tpu_torch.utils.profiling import kernel_counters

    return kernel_counters()


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
# the on-device CV killed after its first snapshot and resumed: 2 epochs in
# chunks of 1
CV_RESUME_EPOCHS = 2
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
            self.accs = []
            trainers.append(self)

        def evaluate(self, indices=None):
            acc = super().evaluate(indices)
            self.accs.append(acc)
            return acc

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
            "launches": launches,
            "epochs": [(t.epoch_losses, t.accs, t.num_batches_per_epoch)
                       for t in trainers]}


def cv_runners(cli: dict, r4: dict) -> dict:
    """``TenfoldVmapRunner`` (the CLI's ``--vmap_folds``) against a
    ``SupTrainer`` a fold, the CLI's default loop, at the README's 10-fold
    width, on runs already made: the runner is section 9f's unsharded
    reference (10 folds, 2 epochs), the trainers are :func:`cv_cli`'s (2
    epochs).  Each epoch's loss and accuracy are equal bit for bit for each
    fold whose batch count is the runner's ``steps_per_epoch`` (the check
    that two runs repeat on the card, Adam's state carried across an
    epoch).  Returns the runner's seconds an epoch."""
    spe, epochs = r4["steps_per_epoch"], len(r4["losses"])
    compared = 0
    for f, (losses, accs, batches) in enumerate(cli["epochs"]):
        if batches != spe:
            continue
        compared += 1
        got = ([float(v) for v in r4["losses"][:, f]],
               [float(v) for v in r4["accs"][:, f]])
        if got != (losses[:epochs], accs[:epochs]):
            fail(f"fold {f}: runner losses and accuracies {got} against the "
                 f"sequential trainer's {(losses, accs)}")
    if not compared:
        fail("no fold has the runner's steps_per_epoch")
    folds = len(cli["epochs"])
    s_epoch = r4["s"] / epochs
    print(f"# runners on {folds} folds x {epochs} epochs: {compared} folds "
          f"equal bit for bit; fold-looped {s_epoch:.2f} s an epoch with "
          f"set-up ({s_epoch * 1e3 / (folds * spe):.3f} ms a step), "
          f"sequential {cli['s'] / 2:.2f} s an epoch (the CLI's)", flush=True)
    return {"vmap_s_epoch": s_epoch, "folds": folds, "compared": compared}


def cv_on_device_resume(ds, root) -> dict:
    """``run_cv_on_device`` on 2 folds x 2 epochs in chunks of 1, once
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

    cfg = cv_config(CV_RESUME_EPOCHS)
    folds = stratified_kfold_indices(ds.labels, 10, seed=0)[:2]
    steps = max(-(-len(tr) // 4) for tr, _ in folds)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    ref = cv_ondevice.run_cv_on_device(ds, cfg, folds=folds,
                                       return_history=True,
                                       epochs_per_dispatch=1, device="cuda")
    secs = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    E = CV_RESUME_EPOCHS
    check_cv_launches("on-device CV", launches, E * len(folds) * steps,
                      E * sum(-(-len(te) // 4) for _, te in folds), 3)
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
                             epochs_per_dispatch=1, device="cuda",
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
    print(f"# on-device CV, 2 folds x {E} epochs: {secs:.1f} s, {secs / E:.2f}"
          f" s an epoch ({secs * 1e3 / (E * len(folds) * steps):.3f} ms a step "
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
    return {"s_epoch": secs / E, "busy": busy_dev, "busy_seq": busy_seq}


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


def cv_phases(ds, data, root, r4) -> dict:
    """Slice 14's phases on the PTC-like dataset ``ds`` with learnable
    labels (written to ``data``), each timed: the 10-fold CLI, the
    fold-looped runner (section 9f's unsharded run ``r4``) against the
    CLI's sequential trainers, the on-device CV's resume, and
    ``cli.train_sup``'s resume."""
    out = {}
    for name, fn in (("cli", lambda: cv_cli(ds, data)),
                     ("runners", lambda: cv_runners(out["cli"], r4)),
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


# ------------------------------------------------ the node path (slice 16)
# The encoder past D = 128 (K18-K20) at the node path's widths: Cora's
# 1,433, Pubmed's 500, Citeseer's 3,703 (fewer rows), and 160 (N
# neighborhoods of S = 5 slots, F = 1,024)
ROWS_WIDTHS = ((160, 2816), (500, 2816), (1433, 2816), (3703, 256))
ROWS_S, ROWS_F = 5, 1024
# the node CLI at Cora's shape with the defaults (K = 4, T = 1, one layer,
# ff 1024, float32, 512 candidates): 2,708 nodes padded to 2,816, 14,080
# rows of D = 1,433
NODE_FLAGS = ["--node_dataset", "cora", "--num_epochs", "20", "--eval_every",
              "5"]
# a step of the node path at T = 1 (ops/rows_encoder.py): K18 5 forward (q
# on slot 0's rows, k and v on every row, the output product, the FFN's
# two) + 5 recompute + 3 row products (dx is not needed) + 5 weight products
# (W_in's q columns over slot 0's rows apart from its k, v columns), K19
# forward, recompute and backward, K20 2 + 1 + 2
NODE_STEP_LAUNCHES = {"K18": 18, "K19": 3, "K20": 5}
# the same in bf16 (the reference's --compute_dtype bfloat16: the rows
# rounded to bf16, every K18 product on bf16-rounded operands)
NODE_BF16_FLAGS = NODE_FLAGS + ["--compute_dtype", "bfloat16"]
# the mask probe's gate: the test mask's majority-class share less this.
# Both packages' probes read that share after 20 steps: the embedding is
# the fork head's weight table, which 20 Adam steps of 5e-4 barely move
# from its initial draw (the JAX package's CPU reading on Planetoid files
# of half Cora's size and these flags: 0.2980, the share; PERF.md, PR 16)
NODE_GATE_BELOW_MAJORITY = 0.05


def rows_params(D, F, seed, dev, stored=None):
    """One encoder layer's 12 tensors (KERNEL_ORDER; a leading [stored]
    axis if ``stored``): weights 0.3 / sqrt(D / 6), LayerNorm scales near
    1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lead = () if stored is None else (stored,)
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,),
              (F, D), (D,), (D,), (D,))
    scale = 0.3 / (D / 6.0) ** 0.5
    out = [torch.randn(lead + s, generator=g) * scale for s in shapes]
    out[4] += 1.0
    out[10] += 1.0
    return [t.to(dev) for t in out]


class plain_pieces:
    """Within the block, ``ops/rows_encoder``'s compositions take the plain
    versions of K18-K20 on CUDA tensors too (the reference of the card's
    checks)."""

    NAMES = ("gemm", "weight_grad", "attention_forward", "attention_backward",
             "res_ln_forward", "res_ln_backward")

    def __enter__(self):
        from graph_transformer_tpu_torch.ops import rows_encoder as re

        self.saved = [getattr(re, n) for n in self.NAMES]
        for n in self.NAMES:
            setattr(re, n, getattr(re, n + "_plain"))

    def __exit__(self, *exc):
        from graph_transformer_tpu_torch.ops import rows_encoder as re

        for n, f in zip(self.NAMES, self.saved):
            setattr(re, n, f)


def check_rows_forward(label, out_k, out_p, bf16) -> tuple:
    """float32: within 1e-4 and relative L2 <= 1e-5 (products summed over
    up to 14,080 terms: sqrt(K) 2^-24 ~ 7e-6); bf16 by
    ``check_bf16_spread``."""
    out_k, out_p = out_k.detach(), out_p.detach()
    if bf16:
        return check_bf16_spread(label, out_k, out_p)
    d = (out_k - out_p).abs()
    rel = float(d.norm() / out_p.norm().clamp_min(1e-30))
    if not (float(d.max()) <= 1e-4 and rel <= 1e-5):
        fail(f"{label}: max |err| {float(d.max())}, relative L2 {rel}")
    return max_err([out_k], [out_p])


def check_rows_grads(label, dx_k, gk, dx_p, gp, f32, names=LEAVES,
                     regate=None) -> tuple:
    """Every leaf at cosine > 0.999 (``check_grads``), float32 leaves
    (``f32``) also at relative L2 <= 1e-4.  Where a float32 leaf misses
    that and ``regate()`` is given, it returns (dx, grads, flips): the plain
    backward with the FFN's ReLU gate taken from the kernel's forward at
    the ``flips`` hidden elements where the two forwards' pre-activations
    fall on either side of 0 (a gate that flips moves a hidden element's
    gradient by its whole value: a step of the function, not an error of
    the sums); the leaves are then held to 1e-4 against that, and the
    flips and both readings printed.  No flip, and the miss fails."""
    err, low = check_grads(label, dx_k, gk, dx_p, gp, names)
    if not f32:
        return err, low

    def worst(ref_dx, ref_g):
        return max((float((a - b).norm() / b.norm().clamp_min(1e-30)), leaf)
                   for leaf, a, b in zip(names, (dx_k,) + tuple(gk),
                                         (ref_dx,) + tuple(ref_g)))

    rel, leaf = worst(dx_p, gp)
    if rel <= 1e-4:
        return err, low
    if regate is None:
        fail(f"{label} {leaf}: relative L2 {rel}")
    dx_g, g_g, flips = regate()
    rel_g, leaf_g = worst(dx_g, g_g)
    print(f"# {label}: {leaf} relative L2 {rel:.3e} against the plain "
          f"version; {flips} of the FFN's ReLU gates differ between the two "
          f"forwards, and with the kernel's gates the worst leaf ({leaf_g}) "
          f"reads {rel_g:.3e}", flush=True)
    if flips == 0 or not rel_g <= 1e-4:
        fail(f"{label} {leaf}: relative L2 {rel} ({flips} gates differ; "
             f"{leaf_g} {rel_g} with the kernel's gates)")
    return max_err((dx_k,) + tuple(gk), (dx_g,) + tuple(g_g)), low


class kernel_gates:
    """Within the block (and ``plain_pieces``), the FFN hidden ``h`` that
    the layer and the FFN route hand their backward
    (``ops/rows_encoder._ffn_hidden``) takes the kernel's ReLU gates at the
    elements ``flips``."""

    def __init__(self, h_kernel, flips):
        self.h_kernel, self.flips = h_kernel, flips

    def __enter__(self):
        import torch

        from graph_transformer_tpu_torch.ops import rows_encoder as re

        self.saved = hidden = re._ffn_hidden

        def gated(*a, **kw):
            h, z = hidden(*a, **kw)
            return torch.where(self.flips, self.h_kernel, h), z

        re._ffn_hidden = gated

    def __exit__(self, *exc):
        from graph_transformer_tpu_torch.ops import rows_encoder as re

        re._ffn_hidden = self.saved


def slot0_qkv(qkv, S):
    """What the slot-0 layer forms of QKV [N·S, 3D]: q on slot 0's rows,
    k and v on every row, as one vector."""
    import torch

    D = qkv.shape[1] // 3
    return torch.cat([qkv[::S, :D].reshape(-1), qkv[:, D:].reshape(-1)])


def check_rows_kernels(dev) -> dict:
    """K18, K19 and K20 against their plain versions at the node path's
    widths (``ROWS_WIDTHS``), float32 and bf16, rates 0 and 0.5: each
    kernel's forward at the slot-0 layer's own intermediates, then the
    layer's forward and its recompute backward (every kernel in every
    layout), every gradient leaf; the full layer too at D = 160.  Returns
    the errors by (kernel, ...)."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    errs = {}
    S = ROWS_S
    for D, N in ROWS_WIDTHS:
        p = rows_params(D, ROWS_F, D, dev)
        g = torch.Generator().manual_seed(D + 1)
        x = torch.randn(N * S, D, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            bf = dtype == torch.bfloat16
            xx = x.to(dtype)
            for rate in (0.0, 0.5):
                lab = f"D={D} N={N} {str(dtype)[6:]} rate {rate}"
                kw = dict(layer=0, rate=rate, seed=1234, bf16=bf)
                with plain_pieces():
                    r = re.layer_forward_rows(xx, p, S, slot0=True, keep=True,
                                              **kw)
                qkv = re._qkv_rows(xx, p[0], p[1], S, bf, True)
                ctx = re.attention_forward(r["qkv"], S, slot0=True, **kw)
                y1 = re.res_ln_forward(xx, r["a"], p[4], p[5], res_every=S,
                                       rate=rate, seed=1234, layer=0, site=1)
                y1_p = re.res_ln_forward_plain(xx, r["a"], p[4], p[5],
                                               res_every=S, rate=rate,
                                               seed=1234, layer=0, site=1)
                for key, a, b in (("K18", slot0_qkv(qkv, S),
                                   slot0_qkv(r["qkv"], S)),
                                  ("K19", ctx, r["ctx"]), ("K20", y1, y1_p)):
                    errs[(key, D, str(dtype), rate, "fwd")] = \
                        check_rows_forward(f"{key} {lab}", a, b, bf)
                for slot0 in (True, False) if D == 160 else (True,):
                    lk = f"layer {'slot0' if slot0 else 'full'} {lab}"
                    out_k = re.layer_forward_rows(xx, p, S, slot0=slot0, **kw)
                    gout = torch.randn(out_k.shape, generator=g).to(dev)
                    dx_k, g_k = re.layer_backward_rows(xx, gout, p, S,
                                                       slot0=slot0, **kw)
                    with plain_pieces():
                        out_p = re.layer_forward_rows(xx, p, S, slot0=slot0,
                                                      **kw)
                        dx_p, g_p = re.layer_backward_rows(
                            xx, gout, p, S, slot0=slot0, **kw)
                    torch.cuda.synchronize()
                    e = check_rows_forward(lk, out_k, out_p, bf)

                    def regate(slot0=slot0, gout=gout):
                        kw2 = dict(kw, slot0=slot0)
                        h_k = re.layer_forward_rows(xx, p, S, keep=True,
                                                    **kw2)["h"]
                        with plain_pieces():
                            h_p = re.layer_forward_rows(xx, p, S, keep=True,
                                                        **kw2)["h"]
                            flips = (h_k > 0) != (h_p > 0)
                            with kernel_gates(h_k, flips):
                                dx, gr = re.layer_backward_rows(xx, gout, p,
                                                                S, **kw2)
                        return dx, gr, int(flips.sum())

                    ge, low = check_rows_grads(lk, dx_k, g_k, dx_p, g_p,
                                               not bf, regate=regate)
                    for key in ("K18", "K19", "K20"):
                        errs[(key, D, str(dtype), rate, lk)] = (
                            max(e[0], ge[0]), max(e[1], ge[1]))
                    print(f"# {lk}: forward {e[0]:.3e}, worst leaf "
                          f"{ge[0]:.3e} (cosine >= {low:.6f})", flush=True)
    return errs


K18_BF16_REL = 1e-4  # K18's bf16 products against their plain version


def check_k18_bf16_products(label, got, want) -> tuple:
    """K18's bf16 products against ``gemm_plain(bf16=True)``: both round the
    same operands to bf16 and sum in float32, so they differ only in sum
    order (relative L2 at most 1.18e-5 at D = 160-3,703 on an H100).  Held
    by ``check_bf16_spread`` and within relative L2 ``K18_BF16_REL``, which
    a rounding other than to nearest even (~2e-3) fails."""
    got, want = got.detach(), want.detach()
    e = check_bf16_spread(label, got, want)
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    if not rel <= K18_BF16_REL:
        fail(f"{label}: relative L2 {rel} against the plain version's "
             f"bf16 products (limit {K18_BF16_REL})")
    return e


def check_k18_bf16(dev) -> dict:
    """K18's bf16 products against their plain version at the node path's
    widths (``ROWS_WIDTHS``: R = N S rows of D, F = ``ROWS_F``), with the
    operands' types of the bf16 layer (x in bf16, weights and K18's own
    outputs float32): every layout with each epilogue the layer gives it,
    the FFN's dropout at rates 0 and 0.5, and dx's product (``add_every``
    = S); forwards by :func:`check_k18_bf16_products`, the weight products
    (with their column sums) at cosine > 0.999 and within relative L2
    ``K18_BF16_REL``.  Returns the errors by (kernel, ...)."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    errs, S, F = {}, ROWS_S, ROWS_F
    bf = torch.bfloat16
    for D, N in ROWS_WIDTHS:
        R = N * S
        g = torch.Generator().manual_seed(D + 7)
        ws = 0.3 / (D / 6.0) ** 0.5

        def rnd(*shape, sc=1.0):
            return (torch.randn(*shape, generator=g) * sc).to(dev)

        x = rnd(R, D).to(bf)
        w_in, w1, w2 = rnd(D, 3 * D, sc=ws), rnd(D, F, sc=ws), rnd(F, D,
                                                                    sc=ws)
        y1, dz, dqkv = rnd(N, D), rnd(N, D), rnd(R, 3 * D)
        h = rnd(N, F)
        cases = [("nn x W bias", (x, w_in[:, D:], "nn"),
                  dict(bias=rnd(2 * D))),
                 ("nn y1 W1 add", (y1, w1, "nn"), dict(add=rnd(N, F))),
                 ("nn h W2 bias", (h, w2, "nn"), dict(bias=rnd(D))),
                 ("nt dz W2 gate", (dz, w2, "nt"),
                  dict(gate=rnd(N, F), gate_keep=0.5)),
                 ("nt dh W1 add", (h, w1, "nt"), dict(add=rnd(N, D))),
                 ("nt dqkv W_in add_every", (dqkv, w_in, "nt"),
                  dict(add=rnd(N, D), add_every=S)),
                 ("nt dz W_out", (dz, w_in[:, :D], "nt"), {})]
        cases += [(f"nn y1 W1 relu_drop rate {rate}", (y1, w1, "nn"),
                   dict(bias=rnd(F), relu=True,
                        drop=(rate, 11, 0, re.HIDDEN_SITE)))
                  for rate in (0.0, 0.5)]
        for lab, (a, b, layout), kw in cases:
            got = re.gemm(a, b, layout, bf16=True, **kw)
            want = re.gemm_plain(a, b, layout, bf16=True, **kw)
            torch.cuda.synchronize()
            rate = kw["drop"][0] if "drop" in kw else 0.0
            errs[("K18", D, str(bf), rate, lab)] = check_k18_bf16_products(
                f"K18 bf16 D={D} {lab}", got, want)
        for lab, a, b in (("tn x dqkv", x, dqkv[:, D:]), ("tn y1 dh", y1, h),
                          ("tn x[::S] dq", x[::S], dqkv[::S, :D])):
            got = re.weight_grad(a, b, bf16=True)
            want = re.weight_grad_plain(a, b, bf16=True)
            torch.cuda.synchronize()
            low = min(cosine(k, p) for k, p in zip(got, want))
            rel = max(float((k - p).norm() / p.norm().clamp_min(1e-30))
                      for k, p in zip(got, want))
            if not (low > 0.999 and rel <= K18_BF16_REL):
                fail(f"K18 bf16 D={D} {lab}: cosine {low}, relative L2 "
                     f"{rel}")
            errs[("K18", D, str(bf), 0.0, lab)] = max_err(list(got),
                                                          list(want))
            print(f"#   K18 bf16 D={D} {lab}: cosine {low:.7f}, relative "
                  f"L2 {rel:.2e}", flush=True)
    return errs


def check_rows_routes(dev) -> dict:
    """The routes past D = 128 at D = 160 against their plain versions on
    the card: the whole encoder at T = 2 (``u2gnn_train_encoder``: two
    layers, the slot-0 last, and the chain of recompute backwards) against
    ``u2gnn_encoder_train_plain`` with the plain K8 chain; K9/K10's
    (``fused_encoder_layer``) and K11/K12's (``ffn_residual_ln``) against
    their plain versions; forward and every leaf, rates 0 and 0.5, float32
    and bf16 (the whole encoder)."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re
    from graph_transformer_tpu_torch.ops.encoder_layer import (
        encoder_layer_backward_plain, encoder_layer_forward_plain,
        fused_encoder_layer)
    from graph_transformer_tpu_torch.ops.ffn import (
        ffn_backward_plain, ffn_forward_plain, ffn_residual_ln)
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train_plain)
    from graph_transformer_tpu_torch.ops.u2gnn_train import (
        mega_recompute_backward_plain, u2gnn_train_encoder)

    errs = {}
    D, N, S, Tn = 160, 1024, ROWS_S, 2
    g = torch.Generator().manual_seed(160)
    x = torch.randn(N * S, D, generator=g).to(dev)
    w = torch.randn(N, D, generator=g).to(dev)
    wr = torch.randn(N * S, D, generator=g).to(dev)
    stacked = rows_params(D, ROWS_F, 161, dev, stored=Tn)
    one = rows_params(D, ROWS_F, 162, dev)
    for dtype in (torch.float32, torch.bfloat16):
        xx = x.to(dtype)
        for rate in (0.0, 0.5):
            lab = f"whole encoder D=160 T=2 {str(dtype)[6:]} rate {rate}"
            ps = [t.clone().requires_grad_(True) for t in stacked]
            xk = xx.clone().requires_grad_(True)
            out = u2gnn_train_encoder(xk, ps, S, Tn, rate, 99)
            gk = torch.autograd.grad((out * w).sum(), [xk] + ps)
            out_p, xs = u2gnn_encoder_train_plain(xx, stacked, S, Tn, rate, 99)
            dx_p, g_p = mega_recompute_backward_plain(xx, xs, w, stacked, S,
                                                      Tn, rate, 99)
            torch.cuda.synchronize()
            bf = dtype == torch.bfloat16
            e = check_rows_forward(lab, out, out_p, bf)
            ge, low = check_rows_grads(lab, gk[0].float(), gk[1:], dx_p, g_p,
                                       not bf)
            errs[("route", lab)] = (max(e[0], ge[0]), max(e[1], ge[1]))
            print(f"# {lab}: forward {e[0]:.3e}, worst leaf {ge[0]:.3e} "
                  f"(cosine >= {low:.6f})", flush=True)
            if bf:
                continue
            lab = f"K9/K10 and K11/K12 routes D=160 rate {rate}"
            ps = [t.clone().requires_grad_(True) for t in one]
            xk = x.clone().requires_grad_(True)
            out = fused_encoder_layer(xk, *ps, 99, S, rate, 1)
            gk = torch.autograd.grad((out * wr).sum(), [xk] + ps)
            dx_p, g_p = encoder_layer_backward_plain(x, wr, one, S, rate, 99,
                                                     1)
            e = check_rows_forward(lab, out, encoder_layer_forward_plain(
                x, one, S, rate, 99, 1), False)

            def regate_layer(rate=rate):
                kw = dict(layer=1, rate=rate, seed=99, bf16=False,
                          slot0=False, keep=True)
                h_k = re.layer_forward_rows(x, one, S, **kw)["h"]
                with plain_pieces():
                    h_p = re.layer_forward_rows(x, one, S, **kw)["h"]
                    flips = (h_k > 0) != (h_p > 0)
                    with kernel_gates(h_k, flips):
                        dx, gr = re.layer_rows_backward(x, wr, one, S, rate,
                                                        99, 1)
                return dx, gr, int(flips.sum())

            ge, _ = check_rows_grads(lab, gk[0], gk[1:], dx_p, g_p, True,
                                     regate=regate_layer)
            fp = [t.clone().requires_grad_(True) for t in one[6:]]
            xk = x.clone().requires_grad_(True)
            out = ffn_residual_ln(xk, *fp, 99, rate, 1)
            fk = torch.autograd.grad((out * wr).sum(), [xk] + fp)
            dx_p, f_p = ffn_backward_plain(x, wr, *one[6:], rate, 99, 1)
            e2 = check_rows_forward(lab + " ffn", out, ffn_forward_plain(
                x, *one[6:], rate, 99, 1), False)

            def regate_ffn(rate=rate):
                h_k = re._ffn_hidden(x, *one[6:10], False, rate, 99, 1)[0]
                with plain_pieces():
                    h_p = re._ffn_hidden(x, *one[6:10], False, rate, 99, 1)[0]
                    flips = (h_k > 0) != (h_p > 0)
                    with kernel_gates(h_k, flips):
                        dx, gr = re.ffn_rows_backward(x, wr, *one[6:], rate,
                                                      99, 1)
                return dx, gr, int(flips.sum())

            ge2, _ = check_rows_grads(lab + " ffn", fk[0], fk[1:], dx_p, f_p,
                                      True, FFN_LEAVES, regate=regate_ffn)
            errs[("route", lab)] = (max(e[0], ge[0], e2[0], ge2[0]),
                                    max(e[1], ge[1], e2[1], ge2[1]))
            print(f"# {lab}: forward {max(e[0], e2[0]):.3e}, worst leaf "
                  f"{max(ge[0], ge2[0]):.3e}", flush=True)
    return errs


def node_config(flags):
    from graph_transformer_tpu_torch.cli import train_node

    args = train_node.parser().parse_args(flags)
    return train_node.experiment_config(args), args


def node_majority_share(ds) -> float:
    y = ds.node_labels[ds.test_mask]
    return float(np.bincount(y).max() / len(y))


def node_cli(root, flags=NODE_FLAGS, label="node CLI") -> dict:
    """``cli.train_node.main`` with ``flags`` on the Planetoid-format files
    at Cora's shape under ``root``, every launch count set to 0 just before
    and read just after: finite losses, the mean of the last five below the
    mean of the first five, exactly ``NODE_STEP_LAUNCHES`` a step and no
    other kernel, each K18 launch in the flags' compute dtype, and the best
    mask probe at least the gate.  In bf16 also the loss at the
    ``PROBE_SEEDS`` seeds lower with the trained parameters than with the
    initial ones."""
    from graph_transformer_tpu_torch.cli import train_node
    from graph_transformer_tpu_torch.ops import rows_encoder as re
    from graph_transformer_tpu_torch.train.node_trainer import NodeTrainer

    cfg, args = node_config(flags + ["--citation_dir", root])
    bf16 = cfg.model.compute_dtype == "bfloat16"
    ds = train_node.load(args)
    gate = node_majority_share(ds) - NODE_GATE_BELOW_MAJORITY
    re.K18.shapes.clear()
    t0 = time.perf_counter()
    with kept_output(train_node, "train_evaluate_node") as out:
        best, text, launches = run_counted(
            lambda: train_node.main(flags + ["--citation_dir", root]))
    sec = time.perf_counter() - t0
    losses = [float(line.split("|")[1].split()[1])
              for line in text.splitlines() if line.startswith("epoch ")]
    steps = int(flags[flags.index("--num_epochs") + 1])
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"{label}: losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: the last five losses' mean {last} is not below the "
             f"first five's {first}")
    unsup_counts(label, launches, steps, NODE_STEP_LAUNCHES)
    kinds = {key[1] for key in re.K18.shapes}
    if kinds != {bf16}:
        fail(f"{label}: K18 launched with bf16 products {sorted(kinds)}, the "
             f"compute dtype is {cfg.model.compute_dtype}")
    probe = {}
    if bf16:
        trained = out["trainer"]
        probe = check_fell(label, lambda tr, s: tr.loss(s),
                           NodeTrainer(ds, cfg, device="cuda"), trained,
                           steps, losses)
    if not best >= gate:
        fail(f"{label}: best mask probe {best} below the gate {gate}")
    print(f"# {label}: {ds.num_nodes} nodes, D={ds.feature_dim}, "
          f"{cfg.model.compute_dtype}, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first five {first:.4f}, last five {last:.4f}), "
          f"best mask probe {best:.4f} (gate {gate:.4f}: the test mask's "
          f"majority share less {NODE_GATE_BELOW_MAJORITY}), {sec:.1f} s",
          flush=True)
    return {"losses": losses, "best_masks": best, "gate": gate,
            "seconds": sec, **probe,
            "launches": {k: v for k, v in launches.items() if v}}


def node_step_flops(N, S, D, F) -> float:
    """Product operations of a node step's forward at T = 1 (one slot-0
    layer), by the code: q over slot 0's rows, k and v over every row, the
    output product and the FFN over slot 0's rows."""
    return (2.0 * N * D * D + 2.0 * N * S * D * 2 * D + 2.0 * N * D * D
            + 4.0 * N * D * F)


def node_steps(root, n=20, flags=NODE_FLAGS, label="node steps") -> dict:
    """A ``NodeTrainer`` of the CLI's configuration (``flags``) on the card:
    ``n`` steps timed by CUDA events after 3 warm-up steps, device busy and
    operations a step from torch.profiler over 5 steps with K18's launches
    a step by launch key (``rows_encoder.K18.shapes``) and its device ms a
    step, and the forward's operation bound beside the step; then two
    trainers of 5 steps each, every parameter and Adam moment equal bit for
    bit."""
    import torch

    from graph_transformer_tpu_torch.cli import train_node
    from graph_transformer_tpu_torch.ops import rows_encoder as re
    from graph_transformer_tpu_torch.train.node_trainer import NodeTrainer

    cfg, args = node_config(flags + ["--citation_dir", root])
    ds = train_node.load(args)
    t = NodeTrainer(ds, cfg, device="cuda")
    for _ in range(3):
        t.train_step(t.next_seed())
    torch.cuda.synchronize()
    seeds = [t.next_seed() for _ in range(n)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in seeds:
        loss = t.train_step(s)
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(loss)):
        fail(f"{label}: loss {float(loss)}")
    ms = start.elapsed_time(end) / n
    re.K18.shapes.clear()
    prof = profile_busy(lambda: [t.train_step(t.next_seed())
                                 for _ in range(5)], 5, sum_of=K18_KERNELS)
    shapes = {k: v // 5 for k, v in re.K18.shapes.items()}
    if (any(v % 5 for v in re.K18.shapes.values())
            or sum(shapes.values()) != NODE_STEP_LAUNCHES["K18"]):
        fail(f"{label}: K18's launches over 5 steps by shape "
             f"{dict(re.K18.shapes)}, not {NODE_STEP_LAUNCHES['K18']} a step")
    N, S, D = t.batch.n_pad, cfg.data.num_neighbors + 1, ds.feature_dim
    flops = node_step_flops(N, S, D, cfg.model.ff_hidden_size)
    bf16 = cfg.model.compute_dtype == "bfloat16"
    bound_ms = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S) * 1e3
    k18_ms = prof["ms_per_step_of"] if prof else None
    rates = ("989 TFLOP/s bf16" if bf16 else
             f"67 TFLOP/s float32, {3 * flops / TF32_FLOP_PER_S * 1e3:.3f} "
             "ms as 3xTF32")
    print(f"# {label}: {ms:.3f} ms a step ({n} steps, CUDA events), N={N},"
          f" S={S}, D={D}, {cfg.model.compute_dtype}; forward {flops:.4g} "
          f"FLOP, bound {bound_ms:.3f} ms at {rates} (the backward about "
          f"twice); K18 {k18_ms} ms a step (profile)", flush=True)
    runs = []
    for _ in range(2):
        r = NodeTrainer(ds, cfg, device="cuda")
        losses = [r.train_epoch() for _ in range(5)]
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().clone()
                              for p in r.model.parameters()],
                     [m.clone() for m in r.opt.mu + r.opt.nu]))
    (la, pa, ma), (lb, pb, mb) = runs
    if not (la == lb and all(torch.equal(a, b)
                             for a, b in zip(pa + ma, pb + mb))):
        fail(f"{label}: two runs of 5 steps differ: losses {la} {lb}")
    print(f"# {label}: two runs of 5 steps equal bit for bit (losses {la})",
          flush=True)
    return {"ms_per_step": ms, "profile": prof, "forward_flops": flops,
            "forward_bound_ms": bound_ms, "k18_ms_per_step": k18_ms,
            "trainer": t, "k18_shapes": shapes}


TF32_FLOP_PER_S = 495e12  # H100 SXM, dense TF32 tensor cores
# K18's device kernels: the products (float32 3xTF32; bf16 on wgmma, after
# the packing that rounds both operands), the split-K products' partial
# sums and the bias gradients' column sums
K18_KERNELS = ("rg_tf32_kernel", "rg_pack_kernel", "rg_wgmma_bf16_kernel",
               "rg_reduce_kernel", "rg_colsum_kernel")


def k18_bounds(b, f) -> dict:
    """A float32 product's least times (ms) for ``b`` bytes and ``f``
    operations: as 3xTF32 on the tensor cores (three TF32 products) and on
    the CUDA cores."""
    tc, by = bound(b, 3 * f, TF32_FLOP_PER_S)
    f32, by32 = bound(b, f, F32_FLOP_PER_S)
    return {"bound_ms": tc, "bound_by": by, "bound_f32_ms": f32,
            "bound_f32_by": by32}


def node_k18_table(N, S, D, F, bf16=False) -> list:
    """K18's launches in a node step at T = 1 (one slot-0 layer, no dx), as
    ``ops/rows_encoder.py`` makes them for N neighborhoods of S slots at
    width D and FFN width F: (name, epilogue, launch key), the key as
    ``rows_encoder.K18.shapes`` counts it (layout, bf16, M, N, K, the row
    strides of A, B and C).  q from x's every S-th row into the QKV
    buffer's first D columns, k and v from every row into the rest; the
    output product and the FFN over slot 0's rows; the row products dh
    (gate), dy1 (add) and dctx; the weight products (with their column
    sums): W_in's q columns from slot 0's rows of x and of QKV's
    cotangent, its k and v columns from every row, then W_out, W1, W2."""
    R, D3, b = N * S, 3 * D, bool(bf16)
    return [("q nn", "bias", ("nn", b, N, D, D, S * D, D3, S * D3)),
            ("kv nn", "bias", ("nn", b, R, 2 * D, D, D, D3, D3)),
            ("out nn", "bias", ("nn", b, N, D, D, D, D, D)),
            ("ffn1 nn", "relu_drop", ("nn", b, N, F, D, D, F, F)),
            ("ffn2 nn", "bias", ("nn", b, N, D, F, F, D, D)),
            ("dh nt", "gate", ("nt", b, N, F, D, D, D, F)),
            ("dy1 nt", "add", ("nt", b, N, D, F, F, F, D)),
            ("dctx nt", None, ("nt", b, N, D, D, D, D, D)),
            ("dW_in q tn", None, ("tn", b, D, D, N, S * D, S * D3, D)),
            ("dW_in kv tn", None, ("tn", b, D, 2 * D, R, D, D3, 2 * D)),
            ("dW_out tn", None, ("tn", b, D, D, N, D, D, D)),
            ("dW1 tn", None, ("tn", b, D, F, N, D, F, F)),
            ("dW2 tn", None, ("tn", b, F, D, N, F, D, D))]


BF16_MM = "torch.mm out_dtype=float32"


def bf16_mm(x, y):
    """One torch product of bf16 operands with a float32 result."""
    import torch

    return torch.mm(x, y, out_dtype=torch.float32)


def node_k18_launches(dev, N, S, D, F, seed=5, views=True,
                      bf16=False) -> dict:
    """Each launch of :func:`node_k18_table` on random operands: name ->
    (kernel call, library call, launch key, operations, bytes).  With
    ``views`` the operands and outputs are views as the step's are (x[::S],
    W_in's column blocks, the QKV buffer's and its cotangent's), so each
    call makes its table key; without, contiguous copies of the same values
    and no ``out`` (for a checkout whose K18 takes no row strides).  Float32:
    the library call is one torch.addmm or torch.mm (on transposed views) of
    the same product, with torch.backends.cuda.matmul.allow_tf32 False.
    bf16 (``bf16``: x in bf16, as the bf16 step's rows; every other operand
    float32, as the step's weights and K18's outputs; bf16 products): one
    :func:`bf16_mm` on bf16 copies of the operands made beforehand (the
    casts not counted, no bias, gate or add), a yardstick of the product
    alone.  Bytes count the operands as they lie in memory."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    g = torch.Generator().manual_seed(seed)
    ws = 0.3 / (D / 6.0) ** 0.5

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to(dev)

    R = N * S
    x, w_in, b_in, dqkv = rnd(R, D), rnd(D, 3 * D, sc=ws), rnd(3 * D), rnd(
        R, 3 * D)
    if bf16:
        x = x.to(torch.bfloat16)
    qkv = torch.empty(R, 3 * D, device=dev)
    w_out, w1, w2 = rnd(D, D, sc=ws), rnd(D, F, sc=ws), rnd(F, D, sc=ws)
    b_d, b_f = rnd(D), rnd(F)
    ctx, y1, dz, da, du2 = (rnd(N, D) for _ in range(5))
    h, dh = rnd(N, F), rnd(N, F)
    xs, w_q, w_kv, dq, dkv = (x[::S], w_in[:, :D], w_in[:, D:],
                              dqkv[::S, :D], dqkv[:, D:])
    b_q, b_kv = b_in[:D], b_in[D:]
    q_out, kv_out = dict(out=qkv[::S, :D]), dict(out=qkv[:, D:])
    if not views:
        xs, w_q, w_kv, dq, dkv = (t.contiguous()
                                  for t in (xs, w_q, w_kv, dq, dkv))
        q_out = kv_out = {}
    drop = (0.5, 3, 0, re.HIDDEN_SITE)
    kw = dict(bf16=bf16)

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def out(M, Nn):
        return M * Nn * 4

    if bf16:
        def lib(bias, a, b):
            a_, b_ = a.to(torch.bfloat16), b.to(torch.bfloat16)
            return lambda: bf16_mm(a_, b_)
    else:
        def lib(bias, a, b):
            if bias is None:
                return lambda: torch.mm(a, b)
            return lambda: torch.addmm(bias, a, b)

    calls = {
        "q nn": (lambda: re.gemm(xs, w_q, bias=b_q, **q_out, **kw),
                 lib(b_q, xs, w_q), 2.0 * N * D * D,
                 nb(xs, w_q, b_q) + out(N, D)),
        "kv nn": (lambda: re.gemm(x, w_kv, bias=b_kv, **kv_out, **kw),
                  lib(b_kv, x, w_kv), 2.0 * R * D * 2 * D,
                  nb(x, w_kv, b_kv) + out(R, 2 * D)),
        "out nn": (lambda: re.gemm(ctx, w_out, bias=b_d, **kw),
                   lib(b_d, ctx, w_out), 2.0 * N * D * D,
                   nb(ctx, w_out, b_d) + out(N, D)),
        "ffn1 nn": (lambda: re.gemm(y1, w1, bias=b_f, relu=True, drop=drop,
                                    **kw),
                    lib(b_f, y1, w1), 2.0 * N * D * F,
                    nb(y1, w1, b_f) + out(N, F)),
        "ffn2 nn": (lambda: re.gemm(h, w2, bias=b_d, **kw),
                    lib(b_d, h, w2), 2.0 * N * F * D,
                    nb(h, w2, b_d) + out(N, D)),
        "dh nt": (lambda: re.gemm(dz, w2, "nt", gate=h, gate_keep=0.5, **kw),
                  lib(None, dz, w2.t()), 2.0 * N * D * F,
                  nb(dz, w2, h) + out(N, F)),
        "dy1 nt": (lambda: re.gemm(dh, w1, "nt", add=du2, **kw),
                   lib(du2, dh, w1.t()), 2.0 * N * F * D,
                   nb(dh, w1, du2) + out(N, D)),
        "dctx nt": (lambda: re.gemm(da, w_out, "nt", **kw),
                    lib(None, da, w_out.t()), 2.0 * N * D * D,
                    nb(da, w_out) + out(N, D)),
        "dW_in q tn": (lambda: re.weight_grad(xs, dq, **kw),
                       lib(None, xs.t(), dq), 2.0 * N * D * D,
                       nb(xs, dq) + out(D, D) + 4 * D),
        "dW_in kv tn": (lambda: re.weight_grad(x, dkv, **kw),
                        lib(None, x.t(), dkv), 2.0 * R * D * 2 * D,
                        nb(x, dkv) + out(D, 2 * D) + 8 * D),
        "dW_out tn": (lambda: re.weight_grad(ctx, da, **kw),
                      lib(None, ctx.t(), da), 2.0 * N * D * D,
                      nb(ctx, da) + out(D, D) + 4 * D),
        "dW1 tn": (lambda: re.weight_grad(y1, dh, **kw),
                   lib(None, y1.t(), dh), 2.0 * N * D * F,
                   nb(y1, dh) + out(D, F) + 4 * F),
        "dW2 tn": (lambda: re.weight_grad(h, dz, **kw),
                   lib(None, h.t(), dz), 2.0 * N * F * D,
                   nb(h, dz) + out(F, D) + 4 * D),
    }
    return {name: (calls[name][0], calls[name][1], key, *calls[name][2:])
            for name, _, key in node_k18_table(N, S, D, F, bf16)}


def check_rows_bwd(label, got, want) -> None:
    """K19's or K20's backward outputs (a tensor or a tuple) against the
    plain version's, float32: the row outputs (dqkv; du, dv) by
    ``check_rows_forward``'s rule, K20's column sums over the rows (dγ, dβ:
    the LayerNorm's gradient leaves, their float32 sum order moving them
    past 1e-4 over 14,080 rows) by the leaves' rule of
    :func:`check_rows_grads` (cosine > 0.999, relative L2 <= 1e-4)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for n, (k, p) in enumerate(zip(got, want)):
        if k.dim() > 1:
            check_rows_forward(f"{label} output {n}", k, p, False)
            continue
        rel = float((k - p).norm() / p.norm().clamp_min(1e-30))
        if not (cosine(k, p) > 0.999 and rel <= 1e-4):
            fail(f"{label} column sums {n}: relative L2 {rel}, cosine "
                 f"{cosine(k, p)}")


K19_BWD_KERNELS = ("ra_bwd_kernel",)
K20_BWD_KERNELS = ("rl_bwd_kernel", "rl_colsum_kernel")


def rows_fwd_calls(qkv, x, S, gamma, beta, rnd, rate=0.5) -> dict:
    """K19's and K20's forward at :func:`rows_bwd_calls`' two shapes:
    {"K19 slot0", ...: (kernel call, plain call, library call, the kernel's
    name, bytes, operations)}: bytes K19 q's Sq rows, k, v and ctx; K20
    res's rows, v, y, γ and β; operations 4 N Sq S D (K19) and 8 R D (K20).
    The library calls, which the port never makes:
    ``scaled_dot_product_attention`` on q [N, 1, Sq, D] and k, v [N, 1, S,
    D] (views of qkv), and ``F.layer_norm`` over v's rows."""
    import torch.nn.functional as Fn

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    D = x.shape[1]
    N = x.shape[0] // S
    kw = dict(rate=rate, seed=3, layer=0)
    t = qkv.view(N, S, 3 * D)[:, None]
    calls = {}
    for shape, Sq in (("slot0", 1), ("full", S)):
        slot0, rows = Sq == 1, N * Sq
        every = S if slot0 else 1
        a = rnd(rows, D)
        calls[f"K19 {shape}"] = (
            lambda slot0=slot0: re.attention_forward(qkv, S, slot0=slot0,
                                                     **kw),
            lambda slot0=slot0: re.attention_forward_plain(
                qkv, S, slot0=slot0, **kw),
            lambda Sq=Sq: Fn.scaled_dot_product_attention(
                t[..., :Sq, :D], t[..., D:2 * D], t[..., 2 * D:]),
            ("ra_fwd_kernel",), 4 * (2 * rows * D + 2 * N * S * D),
            4.0 * rows * S * D)
        calls[f"K20 {shape}"] = (
            lambda a=a, every=every: re.res_ln_forward(
                x, a, gamma, beta, res_every=every, site=re.OUT_SITE, **kw),
            lambda a=a, every=every: re.res_ln_forward_plain(
                x, a, gamma, beta, res_every=every, site=re.OUT_SITE, **kw),
            lambda a=a: Fn.layer_norm(a, (D,), gamma, beta),
            ("rl_fwd_kernel",), 4 * (3 * rows * D + 2 * D), 8.0 * rows * D)
    return calls


def rows_bwd_calls(qkv, x, S, gamma, beta, rnd, rate=0.5) -> dict:
    """K19's and K20's backward at the node step's two shapes, on ``qkv``
    [N·S, 3D], the layer input ``x`` [N·S, D] and random cotangents
    (``rnd(*shape)``): "slot0", the slot-0 layer's attention over N
    neighborhoods and its first LayerNorm over slot 0's N rows (res every
    S-th row of x), and "full", a full layer's (Sq = S over N·S rows, res
    every row).  {"K19 slot0", ...: (kernel call, plain call, library call,
    the kernels' names, bytes, operations)}: bytes each input read once and
    each output written once (K19: q's Sq rows, k, v, dctx, dqkv; K20: g,
    res's rows, v, du, dv, γ and dγ, dβ), operations 10 N Sq S D (K19: the
    scores, dattn, dq, dk, dv) and 12 R D (K20).  The library calls, which
    the port never makes: the backward of ``scaled_dot_product_attention``
    on the forward's q, k, v views of a leaf copy of qkv (every kernel that
    autograd launches for it, its views' gradients scattered into the
    leaf's), and ``torch.ops.aten.native_layer_norm_backward`` on u = res +
    drop(v)."""
    import torch
    import torch.nn.functional as Fn

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    D = x.shape[1]
    N = x.shape[0] // S
    kw = dict(rate=rate, seed=3, layer=0)
    calls = {}
    for shape, Sq in (("slot0", 1), ("full", S)):
        slot0, rows = Sq == 1, N * Sq
        every = S if slot0 else 1
        dctx, a, g = rnd(rows, D), rnd(rows, D), rnd(rows, D)
        leaf = qkv.detach().clone().requires_grad_()
        t = leaf.view(N, S, 3 * D)[:, None]
        att = Fn.scaled_dot_product_attention(
            t[..., :Sq, :D], t[..., D:2 * D], t[..., 2 * D:])
        gatt = rnd(*att.shape)
        u = re._res_rows(x, every) + re.dropout(a, rate, 3, 0, re.OUT_SITE)
        _, mean, rstd = torch.ops.aten.native_layer_norm(u, [D], gamma, beta,
                                                         1e-5)
        calls[f"K19 {shape}"] = (
            lambda dctx=dctx, slot0=slot0: re.attention_backward(
                qkv, dctx, S, slot0=slot0, **kw),
            lambda dctx=dctx, slot0=slot0: re.attention_backward_plain(
                qkv, dctx, S, slot0=slot0, **kw),
            lambda att=att, leaf=leaf, gatt=gatt: torch.autograd.grad(
                att, leaf, gatt, retain_graph=True),
            K19_BWD_KERNELS, 4 * (2 * rows * D + 5 * N * S * D),
            10.0 * rows * S * D)
        bwd = dict(res_every=every, site=re.OUT_SITE, **kw)
        calls[f"K20 {shape}"] = (
            lambda g=g, a=a, bwd=bwd: re.res_ln_backward(g, x, a, gamma, beta,
                                                         **bwd),
            lambda g=g, a=a, bwd=bwd: re.res_ln_backward_plain(
                g, x, a, gamma, beta, **bwd),
            lambda g=g, u=u, mean=mean, rstd=rstd:
                torch.ops.aten.native_layer_norm_backward(
                    g, u, [D], mean, rstd, gamma, beta, [True, True, True]),
            K20_BWD_KERNELS, 4 * (5 * rows * D + 4 * D), 12.0 * rows * D)
    return calls


def rows_timings(dev, t, step_shapes, bf16=False) -> dict:
    """Each of K18-K20 at the node step's launches (the trainer ``t``'s
    shapes).  K18: every launch of :func:`node_k18_table`, each first
    checked to launch K18 once with its table key, then its device ms a
    launch (profiler), its launches a step (``step_shapes``, the keys the
    profiled node steps counted, which must be the table's), its bounds
    and one library call's time; K18's entry is the step's largest launch,
    k and v over every row, with its wrapper's and its plain version's
    time, the launches under ``per_launch`` and their sum a step weighted
    by the counted launches.  Float32: the 3xTF32 tensor-core and the
    float32 CUDA-core bounds, the library call ``torch.addmm`` or
    ``torch.mm`` (allow_tf32 False).  bf16 (``bf16``, K18 alone): the bf16
    bound (989 TFLOP/s, the operands' bytes as they lie in memory) and the
    library call :func:`bf16_mm` on bf16 copies.  K19 the slot-0 attention
    forward, K20 the first LayerNorm forward over slot 0's rows, each one's
    backward at that shape (``backward``), and both at a full layer's
    (``forward_full``, ``backward_full``; :func:`rows_fwd_calls`,
    :func:`rows_bwd_calls`; float32 only).  Per kernel:
    device ms a launch, the wrapper's ms (CUDA events), the plain version's,
    one library call's (``torch.addmm``, ``scaled_dot_product_attention``
    on q [N, 1, 1, D] and k, v [N, 1, S, D], ``F.layer_norm``; for the
    backward launches the device ms of SDPA's backward and of
    ``native_layer_norm_backward``; yardsticks the port never calls), and
    the bound from this launch's bytes and operations."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    if torch.backends.cuda.matmul.allow_tf32:
        fail("rows_timings: the library products must run in float32 "
             "(torch.backends.cuda.matmul.allow_tf32 is set)")
    N, S = t.batch.n_pad, t.cfg.data.num_neighbors + 1
    D, F = t.ds.feature_dim, t.cfg.model.ff_hidden_size
    launches = node_k18_launches(dev, N, S, D, F, bf16=bf16)
    keys = {v[2] for v in launches.values()}
    if set(step_shapes) != keys:
        fail(f"rows_timings: the node step launched K18 as {step_shapes}; "
             f"node_k18_table has {sorted(keys)}")
    tag = "bf16" if bf16 else "float32"
    lib_name = BF16_MM if bf16 else "torch.addmm/mm, allow_tf32 False"
    per = {}
    for name, (fn, lib, key, f, b) in launches.items():
        re.K18.shapes.clear()
        fn()
        if dict(re.K18.shapes) != {key: 1}:
            fail(f"rows_timings: {name} launched K18 as "
                 f"{dict(re.K18.shapes)}, the step as {key}")
        n = step_shapes[key]
        if bf16:
            bms, by = bound(b, f, BF16_FLOP_PER_S)
            bounds = {"bound_ms": bms, "bound_by": by}
        else:
            bounds = k18_bounds(b, f)
        per[name] = dict(ms=device_ms(fn, 10, K18_KERNELS), per_step=n,
                         library_ms=time_ms(lib, 10), flops=f, bytes=b,
                         **bounds)
        v = per[name]
        print(f"# K18 {tag} {name}: {v['ms']:.4f} ms a launch, {n} a step "
              f"(counted); bound {v['bound_ms']:.5f} ("
              + ("989 TFLOP/s bf16" if bf16 else "3xTF32 on the tensor cores"
                 f"), {v['bound_f32_ms']:.5f} (float32 CUDA cores")
              + f"); library {v['library_ms']:.4f} (one {lib_name})",
              flush=True)
    kv = launches["kv nn"][0]
    with plain_pieces():
        kv_plain = time_ms(kv, 10)
    steps_n = sum(v["per_step"] for v in per.values())
    out = {"K18": dict(
        per["kv nn"], wrapper_ms=time_ms(kv, 10), plain_ms=kv_plain,
        ms_per_step=sum(v["ms"] * v["per_step"] for v in per.values()),
        library_ms_per_step=sum(v["library_ms"] * v["per_step"]
                                for v in per.values()),
        excess_ms_per_launch=sum(v["per_step"] * (v["ms"] - v["bound_ms"])
                                 for v in per.values()) / steps_n,
        library=lib_name, per_launch=per)}
    print(f"# K18 {tag} a node step: {out['K18']['ms_per_step']:.4f} ms over "
          f"{steps_n} counted launches (library "
          f"{out['K18']['library_ms_per_step']:.4f}); kv nn wrapper "
          f"{out['K18']['wrapper_ms']:.4f}, plain {kv_plain:.4f}", flush=True)
    if bf16:
        return out
    g = torch.Generator().manual_seed(5)
    x = torch.randn(N * S, D, generator=g).to(dev)
    p = [a.detach()[0] for a in t.model.encoders[0].stacked()]
    qkv = re.gemm(x, p[0], bias=p[1])
    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    # forward and backward at the slot-0 layer's shape, which the node step
    # launches, and a full layer's; the backward first held to its plain
    # version, its library call timed by the device time of its kernels
    for kind, calls in (("forward", rows_fwd_calls(qkv, x, S, p[4], p[5],
                                                   rnd)),
                        ("backward", rows_bwd_calls(qkv, x, S, p[4], p[5],
                                                    rnd))):
        bwd = kind == "backward"
        for name, (fn, plain, lib, names, b, f) in calls.items():
            key, shape = name.split()
            if bwd:
                check_rows_bwd(f"{name} backward", fn(), plain())
            ms = device_ms(fn, 10, names)
            bms, by = bound(b, f, F32_FLOP_PER_S)
            v = dict(ms=ms, wrapper_ms=time_ms(fn, 10),
                     plain_ms=time_ms(plain, 10),
                     library_ms=(device_ms(lib, 10, ("",)) if bwd
                                 else time_ms(lib, 10)),
                     bound_ms=bms, bound_by=by, bytes=b, flops=f)
            if shape == "full":
                out[key][f"{kind}_full"] = v
            elif bwd:
                out[key][kind] = v
            else:
                out[key] = v
            print(f"# {key} {kind} at the {shape} shape: "
                  f"{ms:.4f} ms a launch (wrapper {v['wrapper_ms']:.4f}, "
                  f"plain {v['plain_ms']:.4f}, library {v['library_ms']:.4f}"
                  f", bound {bms:.5f} by {by}, {bms / ms:.1%} of it)",
                  flush=True)
    return out


ROWS_META = {
    "K18": ("rows gemm", "graph_transformer_tpu_torch/ops/csrc/rows_gemm.cu",
            "graph_transformer_tpu/ops/pallas_u2gnn.py:266 (D > 128; also "
            ":316, pallas_encoder.py:196, :214, pallas_ffn.py:70, :97)"),
    "K19": ("rows attention",
            "graph_transformer_tpu_torch/ops/csrc/rows_attention.cu",
            "graph_transformer_tpu/ops/pallas_u2gnn.py:266 (D > 128; also "
            ":316, pallas_encoder.py:196, :214)"),
    "K20": ("rows layer norm",
            "graph_transformer_tpu_torch/ops/csrc/rows_ln.cu",
            "graph_transformer_tpu/ops/pallas_u2gnn.py:266 (D > 128; also "
            ":316, pallas_encoder.py:196, :214, pallas_ffn.py:70, :97)"),
}


def node_phases(root, dev) -> tuple:
    """The node path's phases (slice 16): K18-K20 at the node widths, the
    routes past D = 128, K18's bf16 products at each width, the node CLI at
    Cora's shape, timed and profiled steps, two runs bit for bit, and
    K18-K20's timings; then the CLI, the steps and K18's timings again in
    bf16.  Returns (errors by kernel, numbers, kernels-line entries)."""
    import torch

    t0 = time.perf_counter()
    errs = check_rows_kernels(dev)
    errs.update(check_rows_routes(dev))
    errs.update(check_k18_bf16(dev))
    labels = write_planetoid_like(root)
    print(f"# node data: Planetoid files at Cora's shape under {root}: "
          f"{len(labels)} nodes, classes {np.bincount(labels).tolist()}",
          flush=True)
    out = {"cli": node_cli(root)}
    steps = node_steps(root)
    t = steps.pop("trainer")
    shapes = steps.pop("k18_shapes")
    out["steps"] = steps
    timing = rows_timings(dev, t, shapes)
    del t
    # the bf16 twin (--compute_dtype bfloat16): the CLI, the steps, K18
    out["cli_bf16"] = node_cli(root, NODE_BF16_FLAGS, "node CLI bf16")
    steps = node_steps(root, flags=NODE_BF16_FLAGS, label="node steps bf16")
    t = steps.pop("trainer")
    shapes = steps.pop("k18_shapes")
    out["steps_bf16"] = steps
    timing_bf16 = rows_timings(dev, t, shapes, bf16=True)["K18"]
    del t
    entries = []
    for key, (name, source, replaces) in ROWS_META.items():
        tm = timing[key]
        errs_k = [v for k, v in errs.items() if k[0] == key]
        launches = out["cli"]["launches"].get(key, 0)
        entries.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(e[0] for e in errs_k),
            "max_rel_err": max(e[1] for e in errs_k), **tm,
            "excess_ms": launches * tm.get("excess_ms_per_launch",
                                           tm["ms"] - tm["bound_ms"])})
    # K18's bf16 products: their own kernel, launched by the bf16 CLI
    name, source, replaces = ROWS_META["K18"]
    errs_k = [v for k, v in errs.items()
              if k[0] == "K18" and k[2] == "torch.bfloat16"]
    launches = out["cli_bf16"]["launches"].get("K18", 0)
    entries.append({
        "name": f"K18 {name} (bf16 products)", "route": "cuda",
        "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": max(e[0] for e in errs_k),
        "max_rel_err": max(e[1] for e in errs_k), **timing_bf16,
        "excess_ms": launches * timing_bf16["excess_ms_per_launch"]})
    print(f"# node phases: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    return errs, out, entries


# ---------------------------------------------------- the multiplex path
# the reference's run_node_classification.py setup (SURVEY row 22: UCI
# mfeat, contrastive, siamese) through the multiplex CLI on files of mfeat's
# published shape (write_mfeat_like): K = 8, T = 1, ff 1024, D = size_x =
# 8, float32; 2,000 nodes in 6 views fold into 12,000 neighborhoods of 9
# slots, 108,000 rows a step
ML_FLAGS = ["--ml_dataset", "uci_mfeat", "--loss_type", "contrastive",
            "--ml_model_type", "siamese", "--eval_mode", "kmeans",
            "--num_epochs", "20", "--eval_every", "5", "--num_neighbors",
            "8"]
# a siamese step: one encoder call over the folded views; evaluation reads
# the weight table and launches nothing
ML_STEP_LAUNCHES = {"K4t": 1, "K8s": 1}
# multi mode with the GAE loss at T = 2: an encoder call a view
ML_MULTI_FLAGS = ["--ml_model_type", "multi", "--loss_type", "gae",
                  "--num_timesteps", "2", "--num_epochs", "5"]
ML_MULTI_LAUNCHES = {"K4t": 6, "K8s": 6, "K8": 6}
# the k-means gate: the JAX package's CPU reading on the same files and
# flags without --spectral_baselines (0.1340, best of the four k-means
# evaluations), less this.  Both packages read chance (10 classes) after
# 20 steps: the loss sits at 6 log(1,999), the weight table barely moves
# (PERF.md, Findings)
ML_KMEANS_JAX_CPU = 0.1340
ML_GATE_BELOW_JAX = 0.05
KARCHER_RTOL = 1e-10


def ml_args(root, flags):
    from graph_transformer_tpu_torch.cli import node_classification as nc

    return nc.parser().parse_args(flags + ["--ml_data_path", root])


def cli_losses(text: str) -> list:
    return [float(line.split("|")[1].split()[1])
            for line in text.splitlines() if line.startswith("epoch ")]


def run_counted(fn) -> tuple:
    """(fn()'s value, its stdout, every kernel's launches in it): the counts
    set to 0 just before and read just after."""
    import contextlib
    import io

    import torch

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue(), {k: c.launches for k, c in counters.items()}


class kept_output:
    """Within the block, ``module.<name>`` (the ``train_evaluate_*`` entry
    that a CLI calls) also keeps what it returns (history, best metric,
    trainer) in the dict the block receives; the function is restored
    after."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.out = {}

    def __enter__(self):
        def keep(*a, **kw):
            out = self.real(*a, **kw)
            self.out.update(out)
            return out

        setattr(self.module, self.name, keep)
        return self.out

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


# the step seeds at which a trained model's loss is held below its initial
# one (the same candidates, dropout masks and neighborhoods before and
# after): at the CLIs' learning rate the per-step losses move less than
# their noise from one step's draws to the next, and the plateau rule cuts
# the rate (to 1e-8 within 20 steps on the node CLI's baselines), so their
# printed run does not fall in either package (ROADMAP.md, Known differences)
PROBE_SEEDS = (12345, 777, 31337)


def check_fell(label, loss_at, fresh, trained, steps, losses) -> dict:
    """``steps`` finite step losses, and the mean loss at the
    ``PROBE_SEEDS`` seeds lower with the trained parameters than with the
    initial ones (``loss_at(trainer, seed)``)."""
    import torch

    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"{label}: losses {losses}")
    with torch.no_grad():
        before = [float(loss_at(fresh, s)) for s in PROBE_SEEDS]
        after = [float(loss_at(trained, s)) for s in PROBE_SEEDS]
    print(f"# {label}: losses at the probe seeds, initial -> trained: "
          + ", ".join(f"{b!r} -> {a!r}" for b, a in zip(before, after)),
          flush=True)
    if not np.mean(after) < np.mean(before):
        fail(f"{label}: the trained loss's mean at the probe seeds is not "
             f"below the initial one's: {before} -> {after}")
    return {"probe_before": before, "probe_after": after}


def check_multiplex_kernels(dev) -> dict:
    """K4t and K8s against their plain versions at the siamese step's shape
    (12,000 neighborhoods of S = 9, D = 8, F = 1,024, float32, rates 0 and
    0.5: equal draws; ``check_two_pass``'s rules)."""
    _, params, x2d = random_case(N=12000, S=9, D=8, C=8, F=1024, Tn=1,
                                 stored=1, seed=18, dev=dev)
    errs = check_two_pass("multiplex 108,000 rows", params, x2d.float(), 9,
                          1, dev)
    return {(k[0], "multiplex") + k[1:]: v for k, v in errs.items()}


def check_karcher(ds_m) -> dict:
    """The geometric-mean Laplacian on the card against the same function
    on the CPU at the gaussian loader's N = 200, S = 4 (relative 1e-10, and
    equal spectral metrics from both); then its iterations and seconds on
    the card at ``ds_m``'s (mfeat's N = 2,000, S = 6)."""
    import torch

    from graph_transformer_tpu_torch.data.multiplex import gaussian_multiplex
    from graph_transformer_tpu_torch.utils import laplacian as lp
    from graph_transformer_tpu_torch.utils.metrics import (
        spectral_eval_from_laplacian)

    ds = gaussian_multiplex()
    gm_c, it_c = lp.geometric_mean_laplacian(ds.lap, device="cuda",
                                             return_iters=True)
    gm_h, it_h = lp.geometric_mean_laplacian(ds.lap, device="cpu",
                                             return_iters=True)
    rel = float(np.abs(gm_c - gm_h).max() / np.abs(gm_h).max())
    if not rel <= KARCHER_RTOL or it_c != it_h:
        fail(f"Karcher mean: card against CPU relative {rel}, iterations "
             f"{it_c} and {it_h}")
    k = ds.num_classes
    m_c = spectral_eval_from_laplacian(gm_c, ds.labels, k)
    m_h = spectral_eval_from_laplacian(gm_h, ds.labels, k)
    if m_c != m_h:
        fail(f"Karcher mean: spectral metrics differ: card {m_c}, CPU {m_h}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, iters = lp.geometric_mean_laplacian(ds_m.lap, device="cuda",
                                           return_iters=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n, _, s = ds_m.lap.shape
    print(f"# Karcher mean: card against CPU at N={ds.num_nodes}, "
          f"S={ds.num_views}: relative {rel:.3e}, {it_c} iterations, "
          f"spectral metrics equal {m_c}; at N={n}, S={s}: {iters} "
          f"iterations, {sec:.2f} s on the card", flush=True)
    return {"relative_200": rel, "iterations_200": it_c, "metrics_200": m_c,
            "iterations": iters, "seconds": sec, "N": n, "S": s}


def multiplex_cli(root, emb_path) -> dict:
    """``cli.node_classification.main`` with ``ML_FLAGS`` and the spectral
    baselines on the mfeat-like files: finite losses, the trained loss below
    the initial one at the probe seeds (on one batch of neighborhoods),
    exactly ``ML_STEP_LAUNCHES`` a step and nothing else, the best k-means
    accuracy at least the gate, the embeddings saved."""
    from graph_transformer_tpu_torch.cli import node_classification as nc
    from graph_transformer_tpu_torch.train.ml_node_trainer import (
        MultiplexNodeTrainer)

    flags = ML_FLAGS + ["--ml_data_path", root, "--spectral_baselines",
                        "--save_embeddings", emb_path, "--device", "cuda"]
    t0 = time.perf_counter()
    with kept_output(nc, "train_evaluate_multiplex") as out:
        best, text, launches = run_counted(lambda: nc.main(flags))
    sec = time.perf_counter() - t0
    steps = int(ML_FLAGS[ML_FLAGS.index("--num_epochs") + 1])
    losses = [h["loss"] for h in out["history"]]
    trained = out["trainer"]
    fresh = MultiplexNodeTrainer(trained.ds, trained.cfg, device="cuda")
    batch = fresh.next_batch()
    probe = check_fell("multiplex CLI",
                       lambda t, s: t.model.loss(batch, s), fresh, trained,
                       steps, losses)
    unsup_counts("multiplex CLI", launches, steps, ML_STEP_LAUNCHES)
    gate = ML_KMEANS_JAX_CPU - ML_GATE_BELOW_JAX
    if not best >= gate:
        fail(f"multiplex CLI: best k-means accuracy {best} below the gate "
             f"{gate}")
    emb = np.load(emb_path)
    if emb.shape != (2000, 8) or not np.isfinite(emb).all():
        fail(f"multiplex CLI: saved embeddings {emb.shape}")
    spectral = [line for line in text.splitlines()
                if line.startswith("spectral[")]
    if len(spectral) != 2:
        fail(f"multiplex CLI: spectral lines {spectral}")
    print(f"# multiplex CLI: losses {losses[0]!r} -> {losses[-1]!r}, best"
          f" k-means {best:.4f} (gate {gate:.4f}), embeddings {emb.shape} "
          f"saved, {sec:.1f} s with the spectral baselines", flush=True)
    return {"losses": losses, **probe, "best_kmeans": best, "gate": gate,
            "seconds": sec, "spectral": spectral,
            "launches": {k: v for k, v in launches.items() if v}}


def multiplex_multi(root) -> dict:
    """Multi mode, GAE, T = 2 for 5 steps through the CLI: exactly
    ``ML_MULTI_LAUNCHES`` a step."""
    from graph_transformer_tpu_torch.cli import node_classification as nc

    flags = ML_FLAGS + ML_MULTI_FLAGS + ["--ml_data_path", root, "--device",
                                         "cuda"]
    _, text, launches = run_counted(lambda: nc.main(flags))
    steps = int(ML_MULTI_FLAGS[ML_MULTI_FLAGS.index("--num_epochs") + 1])
    losses = cli_losses(text)
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"multiplex multi: losses {losses}")
    unsup_counts("multiplex multi", launches, steps, ML_MULTI_LAUNCHES)
    return {"losses": losses}


def multiplex_steps(root, ds, n=20) -> dict:
    """A ``MultiplexNodeTrainer`` of the CLI's configuration: ``n`` whole
    steps (the host's neighborhood draws included) timed by CUDA events
    after 3 warm-up steps, the host's draws' ms a step beside them, device
    busy and operations a step from torch.profiler over 5; then two
    trainers of 5 steps each, losses, parameters and Adam moments equal bit
    for bit."""
    import torch

    from graph_transformer_tpu_torch.cli import node_classification as nc
    from graph_transformer_tpu_torch.train.ml_node_trainer import (
        MultiplexNodeTrainer)

    cfg = nc.experiment_config(ml_args(root, ML_FLAGS))
    t = MultiplexNodeTrainer(ds, cfg, device="cuda")
    for _ in range(3):
        t.train_step(t.next_batch(), t.next_seed())
    torch.cuda.synchronize()
    t.batch_ms.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        loss = t.train_step(t.next_batch(), t.next_seed())
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(loss)):
        fail(f"multiplex steps: loss {float(loss)}")
    ms = start.elapsed_time(end) / n
    batch_ms = float(np.mean(t.batch_ms))
    prof = profile_busy(lambda: [t.train_step(t.next_batch(), t.next_seed())
                                 for _ in range(5)], 5)
    print(f"# multiplex steps: {ms:.3f} ms a step ({n} steps, CUDA events), "
          f"of which the host's neighborhood draws {batch_ms:.3f} ms; "
          f"12,000 neighborhoods x 9 slots, D=8, F=1024", flush=True)
    runs = []
    for _ in range(2):
        r = MultiplexNodeTrainer(ds, cfg, device="cuda")
        losses = [r.train_epoch() for _ in range(5)]
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().clone()
                              for p in r.model.parameters()],
                     [m.clone() for m in r.opt.mu + r.opt.nu]))
    (la, pa, ma), (lb, pb, mb) = runs
    if not (la == lb and all(torch.equal(a, b)
                             for a, b in zip(pa + ma, pb + mb))):
        fail(f"two multiplex runs of 5 steps differ: losses {la} {lb}")
    print(f"# multiplex: two runs of 5 steps equal bit for bit (losses {la})",
          flush=True)
    return {"ms_per_step": ms, "batch_ms_per_step": batch_ms,
            "profile": prof}


def baseline_runs(cora_root, name, n=20) -> dict:
    """The node CLI with ``--node_model name`` (GCN or GAT, the default
    loss) on the Cora-shaped files for 20 steps: finite losses, the trained
    loss below the initial one at the probe seeds, and no kernel of the
    port launched (the baselines' JAX functions reach no Pallas kernel);
    ``n`` steps of a fresh trainer timed by CUDA events with a profile of
    5; two 5-step runs equal bit for bit (the segment reductions of
    ``ops/sparse.py`` on the card)."""
    import torch

    from graph_transformer_tpu_torch.cli import train_node
    from graph_transformer_tpu_torch.train.node_trainer import NodeTrainer

    flags = NODE_FLAGS + ["--citation_dir", cora_root, "--node_model", name]
    t0 = time.perf_counter()
    with kept_output(train_node, "train_evaluate_node") as out:
        _, text, launches = run_counted(lambda: train_node.main(
            flags + ["--device", "cuda"]))
    sec = time.perf_counter() - t0
    if any(launches.values()):
        fail(f"{name} CLI launched {launches}")
    losses = [h["loss"] for h in out["history"]]
    trained = out["trainer"]
    t = NodeTrainer(trained.ds, trained.cfg, device="cuda")
    probe = check_fell(f"{name} CLI", lambda tr, s: tr.loss(s), t, trained,
                       int(NODE_FLAGS[NODE_FLAGS.index("--num_epochs") + 1]),
                       losses)
    for _ in range(3):
        t.train_step(t.next_seed())
    torch.cuda.synchronize()
    seeds = [t.next_seed() for _ in range(n)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in seeds:
        loss = t.train_step(s)
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(loss)):
        fail(f"{name} steps: loss {float(loss)}")
    ms = start.elapsed_time(end) / n
    prof = profile_busy(lambda: [t.train_step(t.next_seed())
                                 for _ in range(5)], 5)
    runs = []
    for _ in range(2):
        r = NodeTrainer(trained.ds, trained.cfg, device="cuda")
        ls = [r.train_epoch() for _ in range(5)]
        torch.cuda.synchronize()
        runs.append((ls, [p.detach().clone() for p in r.model.parameters()],
                     [m.clone() for m in r.opt.mu + r.opt.nu]))
    (la, pa, ma), (lb, pb, mb) = runs
    if not (la == lb and all(torch.equal(a, b)
                             for a, b in zip(pa + ma, pb + mb))):
        fail(f"two {name} runs of 5 steps differ: losses {la} {lb}")
    print(f"# {name}: CLI losses {losses[0]!r} -> {losses[-1]!r} "
          f"({sec:.1f} s), {ms:.3f} ms a step ({n} steps, CUDA events), two "
          f"runs of 5 steps equal bit for bit", flush=True)
    return {"losses": losses, **probe, "ms_per_step": ms, "profile": prof,
            "cli_seconds": sec}


def multiplex_phases(root, cora_root, dev) -> tuple:
    """The multiplex phases: K4t/K8s at the siamese step's shape, the Karcher
    mean on the card, the multiplex CLI on mfeat-shaped files (siamese, and
    multi with the GAE at T = 2), timed and profiled steps with two runs bit
    for bit, and the node CLI's GCN and GAT baselines at Cora's shape.
    Returns (errors by kernel, numbers)."""
    from graph_transformer_tpu_torch.data.multiplex import uci_mfeat

    t0 = time.perf_counter()
    errs = check_multiplex_kernels(dev)
    labels = write_mfeat_like(root)
    ds = uci_mfeat(root)
    widths = [len(open(os.path.join(root, f)).readline().split())
              for f in MFEAT_WIDTHS]
    print(f"# multiplex data: mfeat-shaped files under {root}: "
          f"{len(labels)} rows, widths {widths}; "
          f"{ds.num_nodes} nodes, {ds.num_views} views, adjacency "
          f"{ds.adj.nbytes / 1e6:.1f} MB", flush=True)
    out = {"karcher": check_karcher(ds),
           "cli": multiplex_cli(root, os.path.join(root, "emb.npy")),
           "multi": multiplex_multi(root),
           "steps": multiplex_steps(root, ds)}
    if not os.path.exists(os.path.join(cora_root, "ind.cora.graph")):
        write_planetoid_like(cora_root)
    for name in ("gcn", "gat"):
        out[name] = baseline_runs(cora_root, name)
    out["seconds"] = time.perf_counter() - t0
    print(f"# multiplex phases: {out['seconds']:.1f} s", flush=True)
    return errs, out


# ------------------------------------- the remaining single-device modules
# (slice 19): the C++ batch assembler's host timing, the graph-level GCN
# baseline, OrthoNet, torch-convention weights and the HPO CLI
BATCHER_BATCHES = 30
# the loss of a trained OrthoNet against the CPU's: the CPU's own float32
# fits at 1, 4 and 8 threads read histories within 2.7e-4 of their largest
# value and final losses within 1.4% of each other (mfeat-shaped view 0,
# 200 epochs); Adam's first steps move a weight by ±lr whatever the size of
# its gradient, so the fits part by the rounding of near-zero gradients
ORTHO_HISTORY_TOL, ORTHO_FINAL_TOL, ORTHO_GRAM_TOL = 1e-3, 0.05, 1e-3
# the README's HPO commands (README.md:92-93), cut to a few trials of one
# epoch: each trial a full UnsupTrainer (K7, K4tw, K8ws, K8w past T = 1) or
# NodeTrainer (K18-K20)
HPO_UNSUP_FLAGS = ["--dataset", "IMDBBINARY", "--total_trials", "2",
                   "--trial_epochs", "1"]
HPO_NODE_FLAGS = ["--pipeline", "node", "--node_dataset", "cora",
                  "--total_trials", "2", "--trial_epochs", "1"]


def batcher_timing(ds) -> dict:
    """Host ms a batch of each backend of ``BatchBuilder`` at the bench's
    shape (64 REDDIT-like graphs, batch 16, K = 8), ``StepTimer`` over
    ``BATCHER_BATCHES`` batches after 3; the backends' batches equal but
    for the neighborhoods (each backend's own draws)."""
    import torch

    from graph_transformer_tpu_torch.data.batching import BatchBuilder
    from graph_transformer_tpu_torch.utils.profiling import StepTimer

    out, first = {}, {}
    for backend in ("native", "numpy"):
        bb = BatchBuilder(ds, BATCH, K, seed=0, backend=backend)
        timer = StepTimer(warmup=3)
        timer.start()
        for _ in range(BATCHER_BATCHES + 3):
            bb.sample()
            timer.mark()
        out[backend] = timer.summary()
        first[backend] = bb.build(np.arange(BATCH))
    a, b = first["native"], first["numpy"]
    if not torch.equal(a.x, b.x) or torch.equal(a.neigh, b.neigh):
        fail("batch assembler: the backends' features differ or their "
             "draws are equal")
    print("# host batching at the bench's shape (64 graphs, batch 16, K=8, "
          f"N_pad {BatchBuilder(ds, BATCH, K).n_pad}): "
          + ", ".join(f"{b} {s['mean_step_ms']:.3f} ms a batch (p50 "
                      f"{s['p50_step_ms']:.3f}, max {s['max_step_ms']:.3f})"
                      for b, s in out.items()), flush=True)
    return out


def gcn_unsup_phase(ds, n=20) -> dict:
    """The graph-level GCN baseline (``UnsupTrainer(model="gcn_unsup")``)
    on the IMDBBINARY-like file at the README's unsup flags with H = 1,024
    and 2 layers: ``n`` steps after 3 (``StepTimer``, each on a new batch),
    no kernel of the port launched, the loss at the probe seeds on the
    first batch lower after training, busy share and operations a step
    over 5 profiled steps, the probe's mean, two 5-step runs bit for bit."""
    import torch

    from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer
    from graph_transformer_tpu_torch.utils.profiling import StepTimer

    cfg = unsup_config(UNSUP_FLAGS, model="gcn_unsup", num_hidden_layers=2)
    fresh = UnsupTrainer(ds, cfg, device="cuda")
    # every trainer's first batch
    batch = fresh.builder.sample().to(fresh.device)
    t = UnsupTrainer(ds, cfg, device="cuda")

    def steps():
        timer, losses = StepTimer(warmup=3), []
        timer.start()
        for _ in range(n + 3):
            loss = t.train_step(t.builder.sample().to(t.device),
                                t.next_seed())
            timer.mark(loss)
            losses.append(float(loss))
        return timer, losses

    (timer, losses), _, launches = run_counted(steps)
    if any(launches.values()):
        fail(f"gcn_unsup launched {launches}")
    probe = check_fell("gcn_unsup", lambda tr, s: tr.loss(batch, s), fresh,
                       t, n + 3, losses)
    step = timer.summary(nodes_per_step=float(batch.node_mask.sum()))
    prof = profile_busy(lambda: t.train_batches(5), 5)
    t0 = time.perf_counter()
    mean, std = t.evaluate()
    probe_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        r = UnsupTrainer(ds, cfg, device="cuda")
        loss = r.train_batches(5)
        torch.cuda.synchronize()
        runs.append((float(loss), [p.detach().clone()
                                   for p in r.model.parameters()],
                     [m.clone() for m in r.opt.mu + r.opt.nu]))
    (la, pa, ma), (lb, pb, mb) = runs
    if not (la == lb and all(torch.equal(a, b)
                             for a, b in zip(pa + ma, pb + mb))):
        fail(f"two gcn_unsup runs of 5 steps differ: losses {la} {lb}")
    print(f"# gcn_unsup (2 layers, H={cfg.model.ff_hidden_size}, "
          f"V={ds.num_nodes}, table {tuple(t.model.ss.weight.shape)}): "
          f"{step['mean_step_ms']:.3f} ms a step "
          f"(p50 {step['p50_step_ms']:.3f}; StepTimer over {n}), no kernel "
          f"launched; probe {mean:.4f} ± {std:.4f} (random labels) in "
          f"{probe_s:.2f} s; two runs of 5 steps equal bit for bit",
          flush=True)
    return {"step": step, "profile": prof, **probe, "probe_mean": mean,
            "probe_std": std, "probe_s": probe_s}


def orthonet_phase(mfeat_root, epochs=200) -> dict:
    """OrthoNet fitted on the card and on the CPU from the same seed, on
    the Laplacian of the mfeat-shaped files' first view (N = 2,000, its
    kNN graph from ``data/multiplex.uci_mfeat``) with the six views'
    features: the initial loss within the float32 rule of a float64 one
    (1e-4, or twice the CPU's distance), the histories within
    ``ORTHO_HISTORY_TOL`` of their largest value, the final losses within
    ``ORTHO_FINAL_TOL`` relative, both fits' outputs orthogonal
    (|YᵀY/m − I| ≤ ``ORTHO_GRAM_TOL``), the loss fallen; the card's fit
    timed."""
    import torch

    from graph_transformer_tpu_torch.data.multiplex import uci_mfeat
    from graph_transformer_tpu_torch.models.orthonet import OrthoNet

    ds = uci_mfeat(mfeat_root)
    x = ds.x.reshape(ds.num_nodes, -1)
    lap = ds.lap[:, :, 0]
    kw = dict(input_dim=x.shape[1], hidden_dim=128, output_dim=10,
              epochs=epochs, lr=1e-3, seed=42)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = OrthoNet(**kw, device="cuda").fit(x, lap)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = OrthoNet(**kw, device="cpu").fit(x, lap)
    cpu_s = time.perf_counter() - t0
    mlp = OrthoNet(**kw).init_mlp()  # the fits' initial weights
    z = x.astype(np.float64)
    for i, layer in enumerate(mlp):
        z = z @ layer.w.detach().double().numpy() + layer.b.detach(
            ).double().numpy()
        if i < len(mlp) - 1:
            z = np.maximum(z, 0.0)
    r = np.linalg.cholesky(z.T @ z).T
    y = z @ (np.sqrt(ds.num_nodes) * np.linalg.inv(r))
    loss64 = float(np.trace(y.T @ lap @ y))
    err0 = [abs(float(h[0]) - loss64) / abs(loss64)
            for h in (card.history, cpu.history)]
    hist = float(np.abs(card.history - cpu.history).max()
                 / np.abs(cpu.history).max())
    final = abs(float(card.history[-1] - cpu.history[-1])) / abs(
        float(cpu.history[-1]))
    grams = []
    for net in (card, cpu):
        out = net.predict(x).astype(np.float64)
        grams.append(float(np.abs(out.T @ out / ds.num_nodes
                                  - np.eye(kw["output_dim"])).max()))
    print(f"# OrthoNet at N={ds.num_nodes} ({x.shape[1]} features, "
          f"{epochs} epochs): card {card_s:.2f} s, CPU {cpu_s:.2f} s; loss "
          f"{cpu.history[0]:.2f} -> {cpu.history[-1]:.4f} (CPU), "
          f"{card.history[-1]:.4f} (card); initial loss from float64: card "
          f"{err0[0]:.3e}, CPU {err0[1]:.3e}; histories {hist:.3e} of their "
          f"largest value (tol {ORTHO_HISTORY_TOL}), final losses {final:.3e}"
          f" (tol {ORTHO_FINAL_TOL}); |YᵀY/m - I| card {grams[0]:.3e}, CPU "
          f"{grams[1]:.3e}", flush=True)
    if not (err0[0] <= max(1e-4, 2 * err0[1]) and hist <= ORTHO_HISTORY_TOL
            and final <= ORTHO_FINAL_TOL and max(grams) <= ORTHO_GRAM_TOL
            and card.history[-1] < card.history[0] / 10):
        fail("OrthoNet: the card's fit is not the CPU's")
    return {"card_s": card_s, "cpu_s": cpu_s, "initial_rel_err": err0,
            "history_rel": hist, "final_rel": final, "gram_err": grams,
            "final_loss": [float(card.history[-1]), float(cpu.history[-1])]}


def torch_compat_phase(dev) -> dict:
    """``nn.TransformerEncoder`` (eval, ReLU, post-norm, T = 2, D = 68,
    ff 1,024, 9 slots of 512 neighborhoods) and the port's encoder fed its
    converted weights (``utils/torch_compat``), both on the card: with one
    head the port runs K9w each timestep, with two the plain attention and
    K11 (nothing else launched); the port's output against the encoder
    in float64 by the float32 rule (within 1e-4, or twice the float32
    encoder's own distance)."""
    import copy

    import torch

    from graph_transformer_tpu_torch.ops.attention import transformer_encoder
    from graph_transformer_tpu_torch.utils.torch_compat import (
        encoder_params_from_torch_encoder)

    D, F, T2, S, B = 68, 1024, 2, 9, 512
    out = {}
    for heads, want in ((1, {"K9w": T2}), (2, {"K11": T2})):
        torch.manual_seed(heads)
        layer = torch.nn.TransformerEncoderLayer(D, heads, F, dropout=0.5)
        enc = torch.nn.TransformerEncoder(
            layer, T2, enable_nested_tensor=False).eval()
        x = torch.randn(S, B, D)
        with torch.no_grad():
            ref = copy.deepcopy(enc).double()(x.double())
        enc = enc.to(dev)
        p = encoder_params_from_torch_encoder(enc)
        xd = x.to(dev)

        def port():
            with torch.no_grad():
                return transformer_encoder(
                    p.stacked(), xd.transpose(0, 1).contiguous(), heads,
                    rate=0.0).transpose(0, 1)

        got, _, launches = run_counted(port)
        with torch.no_grad():
            lib = enc(xd)
        err_k = float((got.double().cpu() - ref).abs().max())
        err_l = float((lib.double().cpu() - ref).abs().max())
        launches = {k: v for k, v in launches.items() if v}
        print(f"# torch_compat, {heads} head(s): port {err_k:.3e}, "
              f"nn.TransformerEncoder {err_l:.3e} from float64; launches "
              f"{launches}", flush=True)
        if launches != want:
            fail(f"torch_compat {heads} heads: launches {launches}, "
                 f"expected {want}")
        if not err_k <= max(1e-4, 2 * err_l):
            fail(f"torch_compat {heads} heads: the port's encoder is "
                 f"{err_k:.3e} from float64, the library's {err_l:.3e}")
        out[heads] = {"err": err_k, "library_err": err_l}
    return out


def hpo_run(flags, json_path, want) -> tuple:
    """``cli.hpo.main(flags)`` on the card with each trial's launches
    counted (every count set to 0 just before the trial and read just
    after) and timed; fails unless every trial's launches are
    ``want(params)``: exactly those counts (a dict), or those kernels at
    least once each (a set), and nothing else.  Returns (trials as the JSON
    holds them, per-trial launches and seconds)."""
    import torch

    from graph_transformer_tpu_torch.cli import hpo

    real, per_trial = hpo.optimize, []

    def counted(space, evaluate, **kw):
        def trial(params):
            t0 = time.perf_counter()
            value, _, launches = run_counted(lambda: evaluate(params))
            torch.cuda.synchronize()
            per_trial.append({"params": params, "value": value,
                              "seconds": time.perf_counter() - t0,
                              "launches": {k: v for k, v in launches.items()
                                           if v}})
            return value

        return real(space, trial, **kw)

    hpo.optimize = counted
    try:
        hpo.main(flags + ["--device", "cuda", "--results_json", json_path])
    finally:
        hpo.optimize = real
    for r in per_trial:
        print(f"# hpo trial: {r['params']} value {r['value']:.5f}, "
              f"{r['seconds']:.1f} s, launches {r['launches']}", flush=True)
        expect, got = want(r["params"]), r["launches"]
        if (set(got) if isinstance(expect, set) else got) != expect:
            fail(f"hpo trial {r['params']}: launches {got}, expected "
                 f"{expect}")
    with open(json_path) as f:
        return json.load(f)["trials"], per_trial


def hpo_phases(ds, data, cora_root, root) -> dict:
    """The README's HPO commands through ``cli.hpo.main`` on the card: the
    unsup pipeline (``HPO_UNSUP_FLAGS``) on the IMDBBINARY-like file twice,
    the two trial logs equal byte for byte, each trial exactly K7 a step,
    K4tw and K8ws a step and layer, K8w (T − 1) a step and layer; the node
    pipeline (``HPO_NODE_FLAGS``) on the Cora-shaped files, each trial on
    K18-K20 only."""
    steps = -(-ds.num_graphs // 4)  # an epoch in the CLI's batches of 4

    def unsup_want(p):
        k, t = p["num_hidden_layers"], p["num_timesteps"]
        want = {"K7": steps, "K4tw": k * steps, "K8ws": k * steps}
        if t > 1:
            want["K8w"] = k * (t - 1) * steps
        return want

    flags = HPO_UNSUP_FLAGS + ["--data_dir", data]
    logs, out = [], {}
    for run in ("a", "b"):
        path = os.path.join(root, f"hpo_unsup_{run}.json")
        trials, per_trial = hpo_run(flags, path, unsup_want)
        with open(path, "rb") as f:
            logs.append(f.read())
        out[f"unsup_{run}"] = per_trial
    if logs[0] != logs[1]:
        fail("two HPO runs of one seed wrote different trial logs")
    best = max(t["accuracy"] for t in trials)
    print(f"# hpo unsup: two runs wrote the same trial log ({len(logs[0])} "
          f"bytes, best accuracy {best:.5f})", flush=True)
    old = os.environ.get("GT_TPU_CITATION")
    os.environ["GT_TPU_CITATION"] = cora_root
    try:
        _, out["node"] = hpo_run(HPO_NODE_FLAGS, os.path.join(
            root, "hpo_node.json"), lambda p: {"K18", "K19", "K20"})
    finally:
        if old is None:
            os.environ.pop("GT_TPU_CITATION")
        else:
            os.environ["GT_TPU_CITATION"] = old
    return out


def slice19_phases(ds_bench, unsup_root, mfeat_root, cora_root, dev) -> dict:
    """This slice's phases: host batching's ms by backend, the GCN graph
    baseline, OrthoNet, torch-convention weights and the HPO CLI."""
    t0 = time.perf_counter()
    ds, data = unsup_data(unsup_root)
    out = {"batcher": batcher_timing(ds_bench),
           "gcn_unsup": gcn_unsup_phase(ds),
           "orthonet": orthonet_phase(mfeat_root),
           "torch_compat": torch_compat_phase(dev)}
    out["hpo"] = hpo_phases(ds, data, cora_root, unsup_root)
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice-19 phases: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------- the parallel layer
# section 9f: the four regimes of parallel/dryrun.py at real widths, in NCCL
# at world size 1 in this process, then in PAR_RANKS spawned ranks over gloo
# that share cuda:0 (one card: NCCL takes one rank a device)
PAR_RANKS = 4
PAR_TIMEOUT_S = 300
# regimes 2-3 on the Cora-shaped files: the node CLI's K = 4, T = 1, ff 1024,
# 512 candidates, float32; two U2GNN layers, as JAX's dry run
HALO_K, HALO_LAYERS, HALO_T, HALO_CANDIDATES = 4, 2, 1, 512
HALO_TIMED_STEPS = 3
# a U2GNN layer's per-layer encoder past D = 128 at T = 1 (every row out):
# forward K18 4, K19 1, K20 2; backward K18 12, K19 2, K20 3
# (ops/rows_encoder.py)
ROWS_LAYER_LAUNCHES = {"K18": 16, "K19": 3, "K20": 5}


def halo_neighborhoods(g, K, seed) -> np.ndarray:
    """[N, K+1] neighborhoods of one graph: self, then K neighbors drawn
    with replacement from each node's edges (self where it has none)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    deg = g.degrees.astype(np.int64)
    pick = rng.integers(0, np.maximum(deg, 1)[:, None], size=(n, K))
    nbr = g.nbr_ids[g.nbr_offsets[:n, None] + pick]
    nbr = np.where(deg[:, None] > 0, nbr, np.arange(n)[:, None])
    return np.concatenate([np.arange(n)[:, None], nbr], 1).astype(np.int32)


def parallel_inputs(ds, cora_root, ds_cv):
    """The regimes' inputs: regime 1 at the bench's shapes (bench.py:65-105:
    the REDDITMULTI5K-like set, batch 16, K = 8, T = 4, ff 1024; the parity
    step in float32, the step at rate 0.5 in the bench's bf16); regimes 2-3
    on the Cora-shaped files (2,708 nodes, D = 1,433; 2,708 = 4 x 677, and
    regime 3 on the edge-balanced partition, padded to multiples of 8);
    regime 4 the README's 10-fold command on the PTC-like file, 2 epochs
    (as :func:`cv_cli` runs it)."""
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.batching import BatchBuilder
    from graph_transformer_tpu_torch.data.citation import load_planetoid
    from graph_transformer_tpu_torch.data.splits import (
        stratified_kfold_indices)
    from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
    from graph_transformer_tpu_torch.parallel import dryrun as dr

    cfg = ExperimentConfig(
        data=DataConfig(batch_size=BATCH, num_neighbors=K),
        model=ModelConfig(num_timesteps=T, num_hidden_layers=1,
                          ff_hidden_size=FF, compute_dtype="float32"),
        train=TrainConfig(num_epochs=1))
    batch = BatchBuilder(ds, BATCH, K, seed=0).build(np.arange(BATCH))
    model = U2GNNSup(ds.feature_dim, ds.num_classes, cfg.model, seed=0)
    r1 = dr.Regime1(cfg, ds.feature_dim, ds.num_classes,
                    {k: v.clone() for k, v in model.state_dict().items()},
                    batch, seed=7, train_dtype="bfloat16")
    g = load_planetoid("cora", cora_root).graph
    x = np.ascontiguousarray(g.node_feat, np.float32)
    neigh = halo_neighborhoods(g, HALO_K, seed=3)
    halo = dict(layers=HALO_LAYERS, ff_hidden=FF, num_timesteps=HALO_T,
                nsampled=HALO_CANDIDATES)
    r2 = dr.Halo(x, neigh, seed=11, param_seed=2, **halo)
    r3 = dr.Halo(x, neigh, seed=13, param_seed=4, deg=g.degrees,
                 pad_multiple=8, **halo)
    r4 = dr.Regime4(ds_cv, cv_config(2),
                    stratified_kfold_indices(ds_cv.labels, 10, seed=0),
                    epochs=2)
    print(f"# parallel inputs: regime 1 N={batch.n_pad}, D={ds.feature_dim}, "
          f"{BATCH} graphs; regimes 2-3 N={g.num_nodes}, D={x.shape[1]}, "
          f"K={HALO_K}, {HALO_LAYERS} layers; regime 4 {len(r4.folds)} folds "
          f"of the PTC-like file", flush=True)
    return dr.Inputs(r1, r2, r3, r4, timed_steps=HALO_TIMED_STEPS)


def parallel_expect(inputs) -> dict:
    """Each regime's exact launches a step on every rank: regime 1 K4t, K8s
    and T - 1 K8 (D = 4); regime 2 and the masked blocking step
    ROWS_LAYER_LAUNCHES a U2GNN layer, the overlapped step twice that (an
    encoder call for the interior rows and one for the boundary rows);
    regime 4 K7, K4t, K8s and 2 x K8 a step and K4 an eval batch of the
    rank's folds."""
    sup = {"K4t": 1, "K8s": 1, "K8": inputs.r1.cfg.model.num_timesteps - 1}
    layers = inputs.r2.layers * inputs.r2.num_timesteps
    halo = {k: v * layers for k, v in ROWS_LAYER_LAUNCHES.items()}
    r4 = inputs.r4
    B, Tcv = r4.cfg.data.batch_size, r4.cfg.model.num_timesteps

    def cv(res):
        n = res["r4"]["ranks"]
        evals = r4.epochs * sum(-(-len(te) // B)
                                for _, te in r4.folds[res["rank"]::n])
        steps = res["r4"]["steps"]
        return {"K7": steps, "K4t": steps, "K8s": steps,
                "K8": (Tcv - 1) * steps, "K4": evals}

    return {"r1": sup, "r1_train": sup, "r2": halo,
            "r3_overlap": {k: 2 * v for k, v in halo.items()},
            "r3_blocking": halo, "r4": cv}


def parallel_phases(ds, cora_root, ds_cv) -> tuple:
    """Section 9f: (a) ``dryrun_multichip(1, "nccl", "cuda")`` in this
    process (regime 1 against the model's own pass on one device, regime 2
    against the step without a group, regime 3 overlapped against blocking,
    regime 4 the unsharded runner), then the group destroyed; (b) one job
    of PAR_RANKS ranks over gloo on cuda:0 (regime 1 on a (2, 2) mesh, 2-3
    on 4 node ranges, 4 on 2 ranks, 5 folds a rank) held to (a): losses
    within 1e-5 relative, every gradient leaf by the leaf rule, the
    overlapped rows equal bit for bit to the blocking ones and the
    gradients within relative L2 1e-5, the folds bit for bit, each
    regime's launches a step exact on every rank.  Returns (a)'s regime 4
    (the unsharded runner, which ``cv_runners`` reuses) and the numbers."""
    import torch

    from graph_transformer_tpu_torch.parallel import dryrun as dr
    from graph_transformer_tpu_torch.parallel.launch import launch

    inputs = parallel_inputs(ds, cora_root, ds_cv)
    expect = parallel_expect(inputs)
    t0 = time.perf_counter()
    try:
        one = dr.dryrun_multichip(1, "nccl", "cuda", inputs,
                                  timeout_s=PAR_TIMEOUT_S)
        ref = one["results"][0]
        dr.check_launches([ref], expect)
    except AssertionError as e:
        fail(f"9f (a): {e}")
    t_one = time.perf_counter() - t0
    print(f"# 9f (a) NCCL at world size 1: {t_one:.1f} s (regimes "
          + ", ".join(f"{ref[f'r{i}_s']:.1f}" for i in range(1, 5))
          + " s); launches a step " + json.dumps(dr.per_step_launches(ref)),
          flush=True)
    if torch.distributed.is_initialized():
        fail("the NCCL group of (a) is still up")
    t0, wall0 = time.perf_counter(), time.time()
    ranks = launch(dr.run_regimes, PAR_RANKS, inputs, backend="gloo",
                   device="cuda", timeout_s=PAR_TIMEOUT_S)
    t_job = time.perf_counter() - t0
    t_up = max(r["start"] for r in ranks) - wall0
    try:
        deltas = dr.check(ref, ranks, expect=expect)
    except AssertionError as e:
        fail(f"9f (b): {e}")
    for r in ranks:
        print(f"# 9f (b) rank {r['rank']} ({r['backend']} on {r['device']}, "
              f"one card shared by {PAR_RANKS} ranks, not gated): regime 1 "
              f"rate-0.5 step {r['r1']['ms_train']:.1f} ms; regime 3 "
              f"{r['r3']['ms_blocking']:.3f} ms a step blocking, "
              f"{r['r3']['ms_overlap']:.3f} overlapped, of which the "
              f"gradients' all-reduces ({r['r3']['grad_bytes']:,} bytes, leaf "
              f"by leaf) {r['r3']['ms_grad_all_reduce']:.3f} ms; regimes "
              + ", ".join(f"{r[f'r{i}_s']:.1f}" for i in range(1, 5))
              + f" s, meshes {r['meshes_s']:.1f} s", flush=True)
    print(f"# 9f (b) {PAR_RANKS} gloo ranks on cuda:0: {t_job:.1f} s, of "
          f"which {t_up:.1f} s until the last rank ran (spawn, imports, CUDA, "
          f"the group); regime 3 rows differing from blocking "
          f"{deltas['r3_rows_differing']} of "
          f"{sum(r['r3']['rows'] for r in ranks)}", flush=True)
    r3 = ranks[0]["r3"]
    out = {"world1_s": t_one, "job_s": t_job, "ranks_up_s": t_up,
           "ranks": PAR_RANKS,
           "deltas": {k: v for k, v in deltas.items() if k != "launches"},
           "launches": {"world1": dr.per_step_launches(ref),
                        **deltas["launches"]},
           "ms_blocking": [r["r3"]["ms_blocking"] for r in ranks],
           "ms_overlap": [r["r3"]["ms_overlap"] for r in ranks],
           "ms_grad_all_reduce": [r["r3"]["ms_grad_all_reduce"]
                                  for r in ranks],
           "grad_bytes": r3["grad_bytes"],
           "world1_ms_blocking": ref["r3"]["ms_blocking"],
           "world1_ms_overlap": ref["r3"]["ms_overlap"],
           "world1_ms_grad_all_reduce": ref["r3"]["ms_grad_all_reduce"],
           "halo_rows": [r["r2"]["halo_rows"] for r in ranks],
           "cost_model": ranks[0]["r2"]["cost"],
           "partition": {k: r3[k] for k in ("n_local", "halo_rows",
                                            "interior", "valid_fraction")},
           "losses": {"r1": ref["r1"]["loss"], "r2": ref["r2"]["loss"],
                      "r3": ref["r3"]["loss_overlap"]}}
    return ref["r4"], out


# ------------------------------------------------ one-dispatch training
REPLAY_STEPS = 20
REPLAY_CASES = ("bench fused", "quickstart float32", "hpo arm", "act",
                "unsup")


def replay_cases(root, small=False) -> dict:
    """Makers of fresh trainers for the paths JAX trains in one dispatch,
    at full width (``small``: fewer graphs, for the card tests), on files
    written under ``root``: the bench's fused flags (K1-K3, D = 4, bf16),
    the README quickstart (two-pass float32, D = 68), the MUTAG HPO arm (two
    U2GNN layers, 16 graphs a batch), ACT (16 graphs) and the README's
    unsup command."""
    from graph_transformer_tpu_torch.cli.common import (
        base_parser, config_from_args)
    from graph_transformer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from graph_transformer_tpu_torch.data.tu import (
        load_tu_dataset, synthetic_powerlaw_dataset)
    from graph_transformer_tpu_torch.train.sup_trainer import SupTrainer
    from graph_transformer_tpu_torch.train.unsup_trainer import UnsupTrainer

    data = os.path.join(root, "data")
    write_imdb_like_tu(data, num_graphs=100 if small else 1000)
    write_mutag_like_tu(data)
    imdb = load_tu_dataset("IMDBBINARY", data_dir=data)
    mutag = load_tu_dataset("MUTAG", data_dir=data, degree_as_tag=True)
    mutag_act = load_tu_dataset("MUTAG", data_dir=data)
    bench = synthetic_powerlaw_dataset(
        "REDDITMULTI5K-like", num_graphs=16 if small else 64,
        mean_nodes=509, seed=0)
    bench_cfg = ExperimentConfig(
        data=DataConfig(batch_size=BATCH, num_neighbors=K),
        model=ModelConfig(num_timesteps=T, num_hidden_layers=1,
                          ff_hidden_size=FF, compute_dtype="bfloat16",
                          use_pallas=True, use_pallas_whole_encoder=True,
                          use_fused_sampler=True, use_stored_bwd=True,
                          use_folded=True),
        train=TrainConfig(num_epochs=1))

    def cli(flags):
        return config_from_args(base_parser("replay").parse_args(flags))

    return {
        "bench fused": lambda: SupTrainer(
            bench, bench_cfg, train_idx=np.arange(bench.num_graphs),
            test_idx=np.arange(8), device="cuda"),
        "quickstart float32": lambda: SupTrainer(
            imdb, cli(QUICKSTART_FLAGS), device="cuda"),
        "hpo arm": lambda: SupTrainer(
            mutag, cli(TWO_PASS_FLAGS["MUTAG"] + ["--batch_size", "16"]),
            device="cuda"),
        "act": lambda: SupTrainer(
            mutag_act, cli(PER_LAYER_FLAGS["act"] + ["--batch_size", "16"]),
            device="cuda"),
        "unsup": lambda: UnsupTrainer(imdb, unsup_config(UNSUP_FLAGS),
                                      device="cuda"),
    }


def trainer_leaves(t) -> list:
    """(name, tensor) of what a training step changes: the parameters,
    Adam's moments and its count."""
    names = [n for n, _ in t.model.named_parameters()]
    return (list(zip(names, t.model.parameters()))
            + [(f"mu {n}", m) for n, m in zip(names, t.opt.mu)]
            + [(f"nu {n}", v) for n, v in zip(names, t.opt.nu)]
            + [("count", t.opt.count_t)])


def save_leaves(t) -> list:
    return [x.detach().clone() for _, x in trainer_leaves(t)]


def load_leaves(t, saved) -> None:
    import torch

    with torch.no_grad():
        for (_, x), s in zip(trainer_leaves(t), saved):
            x.copy_(s)


def first_difference(label, t, want, losses_want, losses_got) -> None:
    """Fail naming the first loss or leaf of ``t`` that differs from
    ``want`` (saved leaves) in a bit."""
    import torch

    if not torch.equal(losses_want, losses_got):
        i = int((losses_want != losses_got).nonzero()[0])
        fail(f"{label}: step {i}'s loss {float(losses_got[i])!r} replayed "
             f"against {float(losses_want[i])!r} eager")
    for (name, x), w in zip(trainer_leaves(t), want):
        if not torch.equal(x.detach(), w):
            fail(f"{label}: leaf {name} differs between the replayed and "
                 "the eager steps")


def replay_against_eager(label, make, n=REPLAY_STEPS) -> dict:
    """``n`` replayed steps against ``n`` eager steps of the trainer
    ``make()`` makes, from one saved state, one list of batches (drawn by
    its builder) and one seed list: every loss and every leaf bit for bit
    (the first run captures), the launches a step alike, then each way
    timed by CUDA events (after a run of each), profiled over 5 steps.  The
    eager step is the captured one (``StepGraph.step``) run eagerly, each
    batch copied to the card first, as ``train_epoch`` copies it."""
    import torch

    from graph_transformer_tpu_torch.ops.random import device_seed
    from graph_transformer_tpu_torch.train.step_graph import stack_batches

    t = make()
    dev = t.device
    batches = [t.builder.sample() for _ in range(n)]
    seeds = [t.next_seed() for _ in range(n)]
    edges = float(np.mean([float(b.edge_mask.sum()) for b in batches]))
    g = t.step_graph(n)
    s0 = save_leaves(t)
    counters = launch_counters()

    def eager(k=n):
        return torch.stack([g.step(b.to(dev), device_seed(s, dev))
                            for b, s in zip(batches[:k], seeds[:k])])

    def replay(k=n):
        return g.run(stack_batches(batches, dev), range(k), seeds[:k])

    def timed(fn):
        load_leaves(t, s0)
        for c in counters.values():
            c.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return (out, start.elapsed_time(end) / n,
                {k: c.launches for k, c in counters.items() if c.launches})

    losses_e = eager()
    want = save_leaves(t)
    load_leaves(t, s0)
    t0 = time.perf_counter()
    losses_r = replay()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_difference(label, t, want, losses_e, losses_r)
    if not bool(torch.isfinite(losses_e).all()):
        fail(f"{label}: losses not finite: {losses_e}")
    out_e, ms_e, launches_e = timed(eager)
    out_r, ms_r, launches_r = timed(replay)
    first_difference(label + " (timed)", t, want, losses_e, out_r)
    if not torch.equal(out_e, losses_e):
        fail(f"{label}: the eager steps do not repeat")
    if launches_e != launches_r or not launches_r:
        fail(f"{label}: launches eager {launches_e}, replayed {launches_r}")
    k = min(5, n)
    load_leaves(t, s0)
    prof_e = profile_busy(lambda: eager(k), k)
    load_leaves(t, s0)
    prof_r = profile_busy(lambda: replay(k), k)
    load_leaves(t, s0)
    out = {"eager_ms": ms_e, "replay_ms": ms_r,
           "eager_edges_per_s": edges * 1e3 / ms_e,
           "replay_edges_per_s": edges * 1e3 / ms_r,
           "edges_per_step": edges, "first_run_s": first_s,
           "launches_per_step": {k: v / n for k, v in launches_r.items()},
           "eager_profile": prof_e, "replay_profile": prof_r}
    busy = [p and (p["busy_share"], p["ops_per_step"]) for p in
            (prof_e, prof_r)]
    print(f"# replay {label}: {n} losses and {len(want)} leaves bit for bit;"
          f" eager {ms_e:.3f} ms a step ({out['eager_edges_per_s']:.1f} "
          f"edges/s), replayed {ms_r:.3f} ({out['replay_edges_per_s']:.1f});"
          f" busy share, device operations a step: eager {busy[0]}, "
          f"replayed {busy[1]}; capture and first {n} steps {first_s:.2f} s;"
          f" launches a step {out['launches_per_step']}", flush=True)
    return out


def replay_phases(root) -> dict:
    """Section 9g: :func:`replay_against_eager` on every case of
    :func:`replay_cases` at full width."""
    t0 = time.perf_counter()
    out = {name: replay_against_eager(name, make)
           for name, make in replay_cases(root).items()}
    print(f"# replay phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    "rows_gemm": ("rg_wgmma_bf16_kernel", "rg_tf32_kernel"),
}


def hmma_counts(_build) -> dict:
    """HMMA or HGMMA (tensor-core: mma.sync, wgmma) instructions in the
    SASS of each kernel of MMA_KERNELS (``cuobjdump -sass`` of the built
    library), by library and instantiation; fails where one holds none or a
    kernel is missing."""
    counts = {}
    for name, kernels in MMA_KERNELS.items():
        funcs = sass_functions(_build.lib_path(name))
        for func, insts in funcs.items():
            if any(k in func for k in kernels):
                counts[(name, func)] = sum("HMMA" in op or "HGMMA" in op
                                           for _, op, _, _ in insts)
        missing = [k for k in kernels
                   if not any(k in f for (n, f) in counts if n == name)]
        if missing:
            fail(f"{name}: no SASS function of {missing}")
    if not all(counts.values()):
        fail(f"tensor-core kernels without HMMA/HGMMA instructions: "
             f"{counts}")
    for (name, func), n in counts.items():
        print(f"# SASS {name}: {n} HMMA/HGMMA instructions in {func}",
              flush=True)
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
    # ---- 9g. one-dispatch training: each path JAX scans, 20 replayed
    # steps of the captured step against 20 eager ones, bit for bit, timed
    # and profiled both ways
    replay = replay_phases(os.path.join(here, "build", "replay"))
    # ---- 9b. the unsupervised path (the README's unsup command through the
    # CLI, the fused flags, two U2GNN layers, a vocabulary past 32,768, the
    # probe on learnable labels); its kernel checks join the errors that the
    # kernel line reads
    errs_u, unsup = unsup_phases(data_cv, os.path.join(here, "build", "unsup"),
                                 dev)
    errs.update(errs_u)
    # ---- 9c. the node path past D = 128 (K18-K20)
    _, node, node_kernels = node_phases(
        os.path.join(here, "build", "node", "cora"), dev)
    # ---- 9d. the multiplex path (the mfeat-shaped CLI runs, K4t/K8s at
    # its shape, the Karcher mean on the card) and the GCN/GAT baselines
    errs_m, multiplex = multiplex_phases(
        os.path.join(here, "build", "multiplex"),
        os.path.join(here, "build", "node", "cora"), dev)
    errs.update(errs_m)
    # ---- 9e. the remaining single-device modules: host batching by
    # backend, the graph-level GCN baseline, OrthoNet, torch-convention
    # weights and the HPO CLI's two pipelines
    rest = slice19_phases(ds, os.path.join(here, "build", "unsup"),
                          os.path.join(here, "build", "multiplex"),
                          os.path.join(here, "build", "node", "cora"), dev)
    # ---- 9f. the parallel layer: its four regimes in NCCL at world size 1,
    # then in 4 gloo ranks sharing the card, each held to world size 1
    t0 = time.perf_counter()
    r4_ref, parallel = parallel_phases(
        ds, os.path.join(here, "build", "node", "cora"), ds_cv)
    print(f"# parallel phases: {time.perf_counter() - t0:.1f} s", flush=True)

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
    kernels += node_kernels
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
    cv = cv_phases(ds_cv, data_cv, os.path.join(here, "build", "tenfold"),
                   r4_ref)
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
                      "node": node,
                      "multiplex": multiplex,
                      "slice19": rest,
                      "parallel": parallel,
                      "replay": replay,
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
