#!/usr/bin/env python3
"""A/B of two checkouts of the port's kernels on one NVIDIA H100 (run on the
card):

    python3 scripts/torch_ab_kernels.py [--only wide_fwd|narrow_fwd|stored_bwd|sampler|rows_gemm] ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Both are built first, in parallel, each into its own ``build/kernels/``,
with ``nvcc -Xptxas -v``; each build's compiler log goes to
``chiprun_out/ptxas-<n>.log`` (``n``: the ROOT's place among the distinct
ones).  Then, for each ROOT in the order given, a fresh process imports
that checkout's package and times, by torch.profiler device time a launch
(10 launches after one warm-up, ``chip_smoke.device_ms``):

- K12 and K11 at the node axis's rows (5,760 float32 rows, D=68, F=1024,
  rate 0.5): K12 whole, its row kernel (``ff_bwd_kernel``) and its split-K
  weight products with their partial sums;
- K8, K8s, K9 (the forward layer K8 recomputes), K2 and K3 (K8's and
  K8s's body on stored residuals, bf16) at the MUTAG HPO arm's 16-graph batch (512
  neighborhoods x S=17, D=6, float32, F=1024, rate 0.5) and at the A/B
  scripts' rows (79,488 bf16 rows, S=9, D=4), K8 also split into its row
  kernels (before this slice one fused launch; since, the forward launch,
  also apart, and the body) and its partial sums; K10 at the ACT run's rows
  (512 x S=9, D=7, float32);
- K8w, K8ws and K10w at the README quickstart's two-pass batch (640
  neighborhoods x S=9 = 5,760 float32 one-hot rows, D=68, F=1024, T=4,
  rate 0.5): the whole launch, the row kernel (``wd_recompute_bwd_kernel``)
  and the split-K weight products with their partial sums;
- K17 and K15 at the A/B scripts' workload (79,488 bf16 rows, S=9, D=4,
  F=1024, T=4, rate 0.5) and ``torch.nn.TransformerEncoder`` in training on
  the same rows (host clock with CUDA events, ``chip_smoke.time_ms``);
- K14 on those rows and K14w on the same rows at the quickstart's width
  (one-hot D=68, bf16), 3 launches;
- the float32 accuracy of K12 at the node axis's rows and of K8w at D=40
  and D=68 (rate 0.5): the worst
  gradient leaf's max |k - ref| and relative L2 distance against the
  float64 function (autograd of the plain layer in float64), beside the
  plain float32 version's;
- the wide forward family (``wd_encoder_fwd_kernel``; ``--only wide_fwd``
  times nothing else): K4tw, the wide K4 and K9w at the README quickstart's
  two-pass batch (640 neighborhoods x S=9 = 5,760 float32 rows, D=68,
  F=1024, T=4, rate 0.5), K5 and K13w on 640 sampled neighborhoods of a
  one-hot D=68 codebook, K17 at the A/B rows with D=68 (79,488 bf16 rows),
  K4tw and K9w again with bf16 rows;
  K4tw and K9w with float32 rows at D=65 (the quickstart's real width);
  each whole and with the FFN skipped (the same call with F=0: the
  attention part; the FFN is the difference), and the float32 distance of
  K4tw's and K9w's outputs from the float64 function beside the plain
  version's, K4tw's also on the float32 card test's random rows
  (``test_wide_forward_kernels_at_quickstart_batch``, case seeds 3-7);
  then whether float32 K4tw, K4w and K9w (D=68, 65) and K6/K6s on the
  plain forward's residuals give the first two checkouts' outputs bit for
  bit;
- the thread-per-row forward layer's family (``--only narrow_fwd`` builds
  eight sources and times nothing else, :func:`narrow_fwd`): K4t at the MUTAG
  HPO arm's batch (512 x S=17, D=6, T=5, float32), K9 at ACT's (512 x S=9,
  D=7, float32), K4t with bf16 rows at 8,832 x S=9, D=4, K1 and K13 at the
  bench's rows (rate 0.5 and 0, K1 also 0.3), K4 at eval, K15-K17 on the
  A/B rows, K8 and K14 at the HPO arm's batch, K10 at ACT's; K4t's and
  K9's float32 distance from float64; and the layer at 8,704 to 79,488
  rows (:func:`row_sweep`: both FFN branches in a checkout that has two);
- the stored backward and the split-K weight products (``--only
  stored_bwd`` builds seven sources and times nothing else,
  :func:`stored_bwd`): K6 and K6s at the README quickstart's batch (640
  neighborhoods x S=9, one-hot D=68, F=1024, T=4, rate 0.5) on K5's bf16
  residuals and on K17's float32 ones, each whole, its row kernel
  (``wd_stored_bwd_kernel``), its weight products with their partial sums,
  and the products' kernel alone; the same four parts of K8w, K8ws and
  K10w at the quickstart's float32 two-pass batch and of K12 at the node
  axis's 5,760 float32 rows; K14w on the A/B rows at the quickstart's
  width (8,832 x S=9 one-hot bf16 rows, D=68), whole and its products;
  single products (``ffn.weight_product``) of 5,760 rows at h^T dz's and
  x^T dqkv's shapes (1,024 x 68, 68 x 204) in float32 and bf16;
- the two-pass path's sampling stage (``--only sampler`` builds
  ``sampler.cu`` alone and times nothing else, :func:`sampler`) at DD's
  counts on generated data: 334,925 dataset nodes in graphs of 284, a
  batch of 16 graphs (4,544 real rows, 4,608 with padding), D=89 float32,
  K=8; a step's stage is K7, the feature gather and one re-gather between
  two U2GNN layers, forward and backward (a checkout whose sampler writes
  batch slots re-gathers by them; an older one gathers the batch's table
  rows first, then re-gathers by global id through ``global_regather``);
- the encoder past D = 128 (``--only rows_gemm`` builds ``rows_gemm.cu``,
  ``rows_attention.cu`` and ``rows_ln.cu`` and times nothing else,
  :func:`rows_gemm`): K18 at each launch of the node step at Cora's shape
  (``chip_smoke.node_k18_launches`` without views: N = 2,816, S = 5, D =
  1,433, F = 1,024, float32, contiguous operands, since an older K18 takes
  no row strides) and at the two shapes a checkout
  that forms q on every row launches instead (Q/K/V [14,080 x 1,433] .
  [1,433 x 4,299] and dW_in over 14,080 rows), with one library call each,
  its float32 outputs compared bit for bit between the first two
  checkouts; then each launch again with bf16 products (x in bf16, the
  other operands float32, as the bf16 node step's; library: one bf16
  ``torch.mm`` with a float32 result); then the node step on Planetoid
  files of Cora's shape (``chip_smoke.write_planetoid_like``, the node
  CLI's configuration), float32 and ``--compute_dtype bfloat16``: 20 steps
  by CUDA events after 3, and a profile of 5 (busy share, K18's device ms
  a step); before the steps, K19 and K20, forward and backward, at the
  slot-0 layer's and a full layer's shape (:func:`k19_k20`), each device ms
  a launch and the bytes bound's share of it.

Prints one line a checkout and a JSON line of every number, then the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device kernels by part; a name absent from a checkout adds nothing
ROW = ("wd_recompute_bwd_kernel",)
PRODUCTS = ("wd_reduce_small_kernel", "wd_wgrad_kernel", "wd_wgrad_mma_kernel",
            "gt_reduce_partials_kernel", "wd_wgrad_reduce_kernel")
K6_ROW = ("wd_stored_bwd_kernel",)
WGRAD = ("wd_wgrad_kernel", "wd_wgrad_mma_kernel")  # the products alone
FWD = ("gt_encoder_fwd_kernel", "wd_encoder_fwd_kernel")
# K8: one fused row kernel (gt_recompute_bwd_kernel) before this slice, a
# forward launch and the body (gt_layer_bwd_kernel) since
K8_ROW = ("gt_recompute_bwd_kernel", "gt_recompute_fwd_kernel",
          "gt_layer_bwd_kernel")
K8_FWD = ("gt_recompute_fwd_kernel",)
REDUCE = ("gt_reduce_partials_kernel",)
K12_ROW = ("ff_bwd_kernel",)
K12_PRODUCTS = ("wd_wgrad_kernel", "wd_wgrad_mma_kernel",
                "gt_reduce_partials_kernel", "wd_wgrad_reduce_kernel")
# the sources a family needs (``--only``); all of them otherwise
ONLY_SOURCES = {"wide_fwd": ("wide_fwd", "encoder_layer", "stored_fwd",
                             "fused_sampled_fwd"),
                "narrow_fwd": ("encoder_fwd", "encoder_layer", "sampled_fwd",
                               "fused_sampled_fwd", "folded_fwd",
                               "stored_fwd", "recompute_bwd", "mega_bwd"),
                "stored_bwd": ("stored_fwd", "stored_bwd", "recompute_bwd",
                               "encoder_layer", "ffn", "wide_fwd",
                               "mega_bwd"),
                "sampler": ("sampler",),
                "rows_gemm": ("rows_gemm", "rows_attention", "rows_ln")}
# K18's float32 product kernel before it ran on the tensor cores, and its
# bf16 product kernel before it ran on wgmma (K18's kernels in any
# checkout: these and chip_smoke.K18_KERNELS)
K18_F32_BEFORE = "rg_f32_kernel"
# K20's backward partial sums' kernel before a row took a block of 8 warps
K20_BWD_BEFORE = ("rl_reduce_kernel",)
K18_BF16_BEFORE = "rg_bf16_kernel"
# DD (public TU statistics: 1,178 graphs, 334,925 nodes, 89 node labels)
# cut to graphs of 284 nodes, a batch of 16, K=8
DD = dict(nodes=334925, graph_nodes=284, batch=16, D=89, K=8)
NARROW = ("gt_encoder_fwd_kernel",)


def part_ms(fn, kernels, reps=10):
    """Device ms a call of ``fn`` spends in ``kernels`` (torch.profiler), 0.0
    where the checkout launches none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in kernels))
    return us / reps / 1e3


def f64_worst(fwd, x, g, p, grads_k, grads_p):
    """The kernel's and the plain version's float32 gradients (dx, then the
    12 leaves) against the float64 autograd of the plain layer ``fwd``: the
    largest max |a - ref| over the leaves, and the largest relative L2
    distance |a - ref| / |ref| (a relu that float32 rounding flips moves
    both versions' max alike; the L2 distance shows the sums' order)."""
    import torch

    x64 = x.double().requires_grad_(True)
    p64 = [a.double().requires_grad_(True) for a in p]
    out = fwd(x64, p64)
    ref = torch.autograd.grad((out * g.double()).sum(), [x64] + p64)
    worst = {}
    for who, gr in (("kernel", grads_k), ("plain", grads_p)):
        d = [(a.double().reshape(-1) - b.reshape(-1)) for a, b in
             zip(gr, ref)]
        worst[who] = max(float(e.abs().max()) for e in d)
        worst[who + "_l2"] = max(float(e.norm() / max(b.norm(), 1e-300))
                                 for e, b in zip(d, ref))
    worst["ref_max"] = max(float(b.abs().max()) for b in ref)
    return worst


def no_ffn(params):
    """The same parameters with F=0: the layer without its FFN."""
    p = list(params)
    p[6], p[7], p[8] = p[6][..., :0], p[7][..., :0], p[8][..., :0, :]
    return p


def f64_forward(out_k, out_p, ref):
    """max |a - ref| and the relative L2 distance of the kernel's and the
    plain version's float32 outputs from the float64 function."""
    res = {}
    for who, a in (("kernel", out_k), ("plain", out_p)):
        d = a.double().reshape(-1) - ref.reshape(-1)
        res[who] = float(d.abs().max())
        res[who + "_l2"] = float(d.norm() / ref.norm())
    res["ref_max"] = float(ref.abs().max())
    return res


def tensors(*xs):
    """The tensors in ``xs`` and its (nested) lists and tuples, in order."""
    out = []
    for x in xs:
        out += tensors(*x) if isinstance(x, (list, tuple)) else [x]
    return out


def wide_fwd(cs, dev, seed, rate, keep_path=None):
    """The wide forward family's timings and float32 accuracy; with
    ``keep_path``, saves there the outputs that keep their sums across
    checkouts (float32 K4tw, K4w and K9w at D=68 and 65; K6/K6s on the
    plain forward's residuals) for :func:`bit_equal`."""
    import numpy as np
    import torch

    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops.attention import layer_forward
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder, u2gnn_encoder_plain, u2gnn_encoder_train,
        u2gnn_encoder_train_plain)

    out = {}
    N, S, D, T, F = 640, 9, 68, 4, 1024
    si, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                   seed=21, dev=dev, one_hot=True)
    rng = np.random.default_rng(21)
    x = torch.eye(D, device=dev)[torch.tensor(rng.integers(0, D, N * S),
                                              device=dev)]
    xd = torch.randn(N * S, D, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(21))
    xb, xdb = x.to(torch.bfloat16), xd.to(torch.bfloat16)
    p0 = [a[0] for a in params]
    Nab = 8832
    xab = torch.eye(D, device=dev)[torch.tensor(
        rng.integers(0, D, Nab * S), device=dev)].to(torch.bfloat16)
    calls = {
        "K4tw": lambda p: u2gnn_encoder_train(x, p, S, T, rate, seed),
        "K4w": lambda p: u2gnn_encoder(x, p, S, T),
        "K9w": lambda p: el.encoder_layer_forward(xd, [a[0] for a in p], S,
                                                  rate, seed, 0),
        "K5": lambda p: st.stored_forward(*si, p, S, T, rate, seed),
        "K13w": lambda p: fs.fused_sampled_forward(*si, p, S, T, rate, seed),
        "K17_d68": lambda p: st.stored_rows_forward(xab, p, S, T, rate, seed),
        "K4tw_bf16": lambda p: u2gnn_encoder_train(xb, p, S, T, rate, seed),
        "K9w_bf16": lambda p: el.encoder_layer_forward(
            xdb, [a[0] for a in p], S, rate, seed, 0),
    }
    # float32 K4tw and K9w at D=65, the README quickstart's real width
    _, p65, _ = cs.random_case(N=N, S=S, D=65, C=65, F=F, Tn=T, stored=T,
                               seed=22, dev=dev)
    x65 = torch.randn(N * S, 65, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(22))
    calls = {k: (fn, params) for k, fn in calls.items()}
    calls["K4tw_d65"] = (
        lambda p: u2gnn_encoder_train(x65, p, S, T, rate, seed), p65)
    calls["K9w_d65"] = (lambda p: el.encoder_layer_forward(
        x65, [a[0] for a in p], S, rate, seed, 0), p65)
    for key, (fn, pk) in calls.items():
        out[key] = {"ms": cs.device_ms(lambda: fn(pk), 10, FWD),
                    "attn_ms": cs.device_ms(lambda: fn(no_ffn(pk)), 10, FWD)}
        out[key]["ffn_ms"] = out[key]["ms"] - out[key]["attn_ms"]
    out["K4tw_f64"] = f64_forward(
        u2gnn_encoder_train(x, params, S, T, rate, seed)[0],
        u2gnn_encoder_train_plain(x, params, S, T, rate, seed)[0],
        cs.plain_f64(x, params, S, T, rate, seed))
    # the float32 card test's case (random rows, case seed 3, the dropout
    # seed of check_two_pass) and four more case seeds
    for cseed in (3, 4, 5, 6, 7):
        _, pq, xq = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                   seed=cseed, dev=dev)
        xq = xq.float()
        for r in (0.0, 0.5):
            out[f"K4tw_f64_case{cseed}_rate{r}"] = f64_forward(
                u2gnn_encoder_train(xq, pq, S, T, r, 97531)[0],
                u2gnn_encoder_train_plain(xq, pq, S, T, r, 97531)[0],
                cs.plain_f64(xq, pq, S, T, r, 97531))
    if keep_path:
        _, res = st.stored_forward_plain(*si, params, S, T, rate, seed)
        g = torch.randn(N, D, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(23))
        torch.save({
            "K4tw": tensors(u2gnn_encoder_train(x, params, S, T, rate, seed)),
            "K4tw_d65": tensors(
                u2gnn_encoder_train(x65, p65, S, T, rate, seed)),
            "K4w": tensors(u2gnn_encoder(x, params, S, T)),
            "K9w": tensors(el.encoder_layer_forward(xd, p0, S, rate, seed,
                                                    0)),
            "K9w_d65": tensors(el.encoder_layer_forward(
                x65, [a[0] for a in p65], S, rate, seed, 0)),
            "K6_K6s": tensors(st.stored_encoder_backward(res, g, params, T,
                                                         rate, seed)),
        }, keep_path)
    out["K4w_f64"] = f64_forward(u2gnn_encoder(x, params, S, T),
                                 u2gnn_encoder_plain(x, params, S, T),
                                 cs.plain_f64(x, params, S, T, 0.0, None))
    out["K9w_f64"] = f64_forward(
        el.encoder_layer_forward(xd, p0, S, rate, seed, 0),
        el.encoder_layer_forward_plain(xd, p0, S, rate, seed, 0),
        layer_forward(xd.double().view(N, S, D), [a.double() for a in p0],
                      layer=0, rate=rate, seed=seed, mm=torch.float32,
                      slot0=False)[0])
    return out


def narrow_fwd(cs, dev, seed, rate):
    """The thread-per-row forward layer's family: device ms a launch of K4t
    at the MUTAG HPO arm's batch (512 x S=17, D=6, T=5, float32), K9 at
    ACT's (512 x S=9, D=7, float32), K4t with bf16 rows at 8,832 x S=9, D=4,
    T=4, K1 and K13 at the bench's rows (8,832 sampled neighborhoods, S=9,
    D=4, T=4; also at rate 0, and K1 at 0.3), K4 at eval on such rows (rate
    0), K15, K16 and K17 on them, K8 (whole, and its forward launch) and
    K14 at the HPO arm's batch, K10 at ACT's; F=1024, ``rate`` elsewhere.
    The float32 distance of K4t's and K9's outputs from the float64
    function beside the plain version's.  The layer at the rows of
    :func:`row_sweep`."""
    import torch

    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import fused_sampled_encoder as fs
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.ops.attention import layer_forward
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder, u2gnn_encoder_train, u2gnn_encoder_train_plain)

    out, F = {}, 1024
    gen = torch.Generator(device=dev).manual_seed(31)
    _, ph, xh = cs.random_case(N=512, S=17, D=6, C=6, F=F, Tn=5, stored=5,
                               seed=31, dev=dev)
    xh = xh.float()
    _, pa, xa = cs.random_case(N=512, S=9, D=7, C=7, F=F, Tn=1, stored=1,
                               seed=32, dev=dev)
    xa, pa0 = xa.float(), [a[0] for a in pa]
    sib, pb, xb = cs.random_case(N=8832, S=9, D=4, C=4, F=F, Tn=4, stored=4,
                                 seed=33, dev=dev)
    _, xsh = u2gnn_encoder_train(xh, ph, 17, 5, rate, seed)
    gh = torch.randn(512, 17, 6, device=dev, generator=gen)
    gh0 = torch.randn(512, 6, device=dev, generator=gen)
    ga = torch.randn(512 * 9, 7, device=dev, generator=gen)
    calls = {
        "K4t_hpo": (lambda: u2gnn_encoder_train(xh, ph, 17, 5, rate, seed),
                    NARROW),
        "K9_act": (lambda: el.encoder_layer_forward(xa, pa0, 9, rate, seed,
                                                    0),
                   ("gt_layer_fwd_kernel",)),
        "K4t_bf16_ab": (lambda: u2gnn_encoder_train(xb, pb, 9, 4, rate, seed),
                        NARROW),
        "K1_bench": (lambda: se.sampled_forward(*sib, pb, 9, 4, rate, seed),
                     NARROW),
        "K13_bench": (lambda: fs.fused_sampled_forward(*sib, pb, 9, 4, rate,
                                                       seed), NARROW),
        "K1_bench_rate0": (lambda: se.sampled_forward(*sib, pb, 9, 4, 0.0,
                                                      seed), NARROW),
        "K13_bench_rate0": (lambda: fs.fused_sampled_forward(
            *sib, pb, 9, 4, 0.0, seed), NARROW),
        "K1_bench_rate03": (lambda: se.sampled_forward(*sib, pb, 9, 4, 0.3,
                                                       seed), NARROW),
        "K4_eval": (lambda: u2gnn_encoder(xb, pb, 9, 4), NARROW),
        "K15_ab": (lambda: fe.folded_stored_forward(xb, pb, 9, 4, rate, seed),
                   NARROW),
        "K16_ab": (lambda: fe.folded_forward(xb, pb, 9, 4, rate, seed),
                   NARROW),
        "K17_ab": (lambda: st.stored_rows_forward(xb, pb, 9, 4, rate, seed),
                   NARROW),
        "K8_hpo": (lambda: ut.layer_recompute_backward(
            xh.view(512, 17, 6), gh, ph, 0, rate, seed), K8_ROW + REDUCE),
        "K14_hpo": (lambda: ut.mega_recompute_backward(
            xh, xsh, gh0, ph, 17, 5, rate, seed),
            ("gt_mega_bwd_kernel", "gt_mega_reduce_kernel")),
        "K10_act": (lambda: el.encoder_layer_backward(xa, ga, pa0, 9, rate,
                                                      seed, 1),
                    K8_ROW + REDUCE),
    }
    for key, (fn, kern) in calls.items():
        out[key] = {"ms": cs.device_ms(fn, 10, kern)}
    out["K8_hpo"]["fwd_ms"] = part_ms(calls["K8_hpo"][0], K8_FWD)
    out["K4t_hpo_f64"] = f64_forward(
        u2gnn_encoder_train(xh, ph, 17, 5, rate, seed)[0],
        u2gnn_encoder_train_plain(xh, ph, 17, 5, rate, seed)[0],
        cs.plain_f64(xh, ph, 17, 5, rate, seed))
    out["K9_act_f64"] = f64_forward(
        el.encoder_layer_forward(xa, pa0, 9, rate, seed, 0),
        el.encoder_layer_forward_plain(xa, pa0, 9, rate, seed, 0),
        layer_forward(xa.double().view(512, 9, 7), [a.double() for a in pa0],
                      layer=0, rate=rate, seed=seed, mm=torch.float32,
                      slot0=False)[0])
    out.update({f"rows {k}": v for k, v in row_sweep(cs, dev).items()})
    return out


# rows at which the forward layer is timed (the HPO arm's 512 x S=17 to the
# bench's 8,832 x S=9) and the gate values that send a checkout that has
# two branches (_build.set_fwd_mma_rows) to one of them
SWEEP_ROWS = (8704, 16384, 32768, 49152, 79488)
BRANCH_GATES = (("mma", 2 ** 31 - 1), ("cuda", 1))


def row_sweep(cs, dev) -> dict:
    """Device ms a launch of K4t with float32 rows at the HPO arm's shape
    (S=17, D=6, T=5), of K4t with bf16 rows at the bench's (S=9, D=4, T=4)
    and of K9 with float32 rows at ACT's (S=9, D=7), F=1024, rate 0.5, at
    each of SWEEP_ROWS: in a checkout whose layer has two FFN branches
    (tensor cores, "mma"; a thread per row on the CUDA cores, "cuda") each
    branch, its gate moved and put back; else the one layer ("one")."""
    import torch

    from graph_transformer_tpu_torch.ops import _build
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train)

    shapes = {"K4t f32 S17 D6": (17, 6, 5, torch.float32),
              "K4t bf16 S9 D4": (9, 4, 4, torch.bfloat16),
              "K9 f32 S9 D7": (9, 7, 1, torch.float32)}
    libs = ("encoder_fwd", "encoder_layer")
    two = hasattr(_build, "set_fwd_mma_rows")
    out = {}
    try:
        for key, (S, D, Tn, dt) in shapes.items():
            for rows in SWEEP_ROWS:
                N = -(-rows // S)
                _, p, x = cs.random_case(N=N, S=S, D=D, C=D, F=1024, Tn=Tn,
                                         stored=Tn, seed=18, dev=dev)
                x = x.to(dt)
                if key.startswith("K9"):
                    p0 = [a[0] for a in p]
                    fn = (lambda: el.encoder_layer_forward(
                        x, p0, S, 0.5, 5, 0))
                    kern = ("gt_layer_fwd_kernel",)
                else:
                    fn = (lambda: u2gnn_encoder_train(x, p, S, Tn, 0.5, 5))
                    kern = ("gt_encoder_fwd_kernel",)
                res = {}
                for branch, gate in (BRANCH_GATES if two else (("one", 0),)):
                    if two:
                        _build.set_fwd_mma_rows(gate, libs)
                    res[branch] = cs.device_ms(fn, 10, kern)
                out[f"{key} {N * S}"] = res
    finally:
        if two:
            _build.set_fwd_mma_rows(0, libs)
    return out


def parts(cs, fn, row):
    """Device ms a launch of ``fn`` whole, in its row kernel ``row``, in its
    split-K weight products with their partial sums and in the products'
    kernel alone."""
    return {"ms": cs.device_ms(fn, 10, row + PRODUCTS),
            "row_ms": cs.device_ms(fn, 10, row),
            "products_ms": cs.device_ms(fn, 10, PRODUCTS),
            "mma_ms": cs.device_ms(fn, 10, WGRAD)}


def stored_bwd(cs, dev, seed, rate):
    """K6 and K6s at the quickstart's batch on K5's bf16 and K17's float32
    residuals; K8w, K8ws, K10w and K12, each whole, its row kernel, its
    weight products with their partial sums and the products' kernel alone;
    K14w."""
    import numpy as np
    import torch

    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import ffn
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut

    out = {}
    N, S, D, T, F = 640, 9, 68, 4, 1024
    gen = torch.Generator(device=dev).manual_seed(41)
    si, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                   seed=41, dev=dev, one_hot=True)
    x32 = torch.randn(N * S, D, device=dev, generator=gen)
    g = torch.randn(N, S, D, device=dev, generator=gen)
    g0 = torch.randn(N, D, device=dev, generator=gen)
    _, res_b = st.stored_forward(*si, params, S, T, rate, seed)
    _, res_f = st.stored_rows_forward(x32, params, S, T, rate, seed)
    kinds = ("xs", "qkv", "attn", "strip", "h")
    for tag, res in (("bf16", res_b), ("f32", res_f)):
        a0 = [res[k][0] for k in kinds]
        a0[0] = a0[0].reshape(N, S, D)
        al = [res[k][T - 1] for k in kinds]
        al[0] = al[0].reshape(N, S, D)
        out[f"K6_{tag}"] = parts(cs, lambda: st.stored_layer_backward(
            *a0, g, params, 0, rate, seed), K6_ROW)
        out[f"K6s_{tag}"] = parts(cs, lambda: st.stored_slot0_backward(
            *al, g0, params, T - 1, rate, seed), K6_ROW)
    # the quickstart's float32 two-pass batch (one-hot rows)
    rng = np.random.default_rng(42)
    x = torch.eye(D, device=dev)[torch.tensor(rng.integers(0, D, N * S),
                                              device=dev)].view(N, S, D)
    p0 = [a[0] for a in params]
    out["K8w"] = parts(cs, lambda: ut.wide_layer_recompute_backward(
        x, g, params, 0, rate, seed), ROW)
    out["K8ws"] = parts(cs, lambda: ut.wide_slot0_recompute_backward(
        x, g0, params, T - 1, rate, seed), ROW)
    out["K10w"] = parts(cs, lambda: el.wide_encoder_layer_backward(
        x.view(N * S, D), g.view(N * S, D), p0, S, rate, seed), ROW)
    # K12 at the node axis's rows
    M = N * S
    pf = [torch.tensor(rng.standard_normal(sh) * 0.3, dtype=torch.float32,
                       device=dev) for sh in ((D, F), (F,), (F, D), (D,),
                                              (D,), (D,))]
    pf[4] = pf[4] + 1.0
    k12 = lambda: ffn.ffn_backward(  # noqa: E731
        x32, g.view(M, D), *pf, rate, seed, 1)
    out["K12"] = {"ms": cs.device_ms(k12, 10, K12_ROW + K12_PRODUCTS),
                  "row_ms": cs.device_ms(k12, 10, K12_ROW),
                  "products_ms": cs.device_ms(k12, 10, K12_PRODUCTS),
                  "mma_ms": cs.device_ms(k12, 10, WGRAD)}
    out["K14w"] = k14w(cs, dev, rng, seed, rate)
    # single products (ffn.weight_product) at the wide backward's shapes
    for M1, N1 in ((1024, 68), (68, 204)):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(M, M1, device=dev, generator=gen).to(dt)
            b = torch.randn(M, N1, device=dev, generator=gen).to(dt)
            fn = lambda: ffn.weight_product(a, b)  # noqa: E731
            out[f"wgrad_{M1}x{N1}_{str(dt)[6:]}"] = {
                "ms": cs.device_ms(fn, 10, PRODUCTS),
                "mma_ms": cs.device_ms(fn, 10, WGRAD)}
    return out


def k14w(cs, dev, rng, seed, rate):
    """K14w on the A/B rows at the quickstart's width (one-hot D=68, bf16),
    whole (3 launches) and its split-K weight products."""
    import torch

    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train)

    N, S, D, T, F = 8832, 9, 68, 4, 1024
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                  seed=9, dev=dev, one_hot=True)
    x2d = torch.eye(D, device=dev)[torch.tensor(
        rng.integers(0, D, N * S), device=dev)].to(torch.bfloat16)
    _, xs = u2gnn_encoder_train(x2d, params, S, T, rate, seed)
    g = torch.randn(N, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    fn = lambda: ut.mega_recompute_backward(  # noqa: E731
        x2d, xs, g, params, S, T, rate, seed)
    return {"ms": cs.device_ms(fn, 3, ("wd_mega_bwd_kernel",) + PRODUCTS
                               + ("gt_mega_reduce_kernel",)),
            "products_ms": cs.device_ms(fn, 3, PRODUCTS)}


def stage_profile(cs, fn, reps=20) -> dict:
    """Device ms and device operations a call of ``fn`` (every device
    record of a torch.profiler session, summed; the stage runs in order on
    one stream), with the host's ms a call by CUDA events, and the device ms
    a call of its six costliest device operations, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": sum(e.time_range.end - e.time_range.start
                             for e in dev) / reps / 1e3,
            "ops": len(dev) / reps, "host_ms": cs.time_ms(fn, reps),
            **{f"[{name}]": us / reps / 1e3 for name, us in top}}


def sampler(cs, dev, seed):
    """The two-pass sampling stage at DD's counts (``DD``): the dataset's
    neighbor table (each node's 128 entries drawn from its own graph, its
    first ``deg`` entries its neighbors, deg 1-10), degrees and float32
    features on the card, a batch of 16 whole graphs.  Times, per step, the
    stage (K7, the feature gather, one re-gather forward and backward), K7's
    kernel alone, and in an older checkout the per-batch gather of the
    batch's table rows, which ``train_epoch`` runs every step."""
    import torch

    from graph_transformer_tpu_torch.ops.sparse import global_regather
    from graph_transformer_tpu_torch.sampling import neighbor_table as nt

    n, gn, D, K = DD["nodes"], DD["graph_nodes"], DD["D"], DD["K"]
    G = n // gn
    gen = torch.Generator(device=dev).manual_seed(seed)
    node = torch.arange(n, device=dev)
    graph = (node // gn).clamp(max=G - 1)
    size = torch.where(graph == G - 1, n - (G - 1) * gn, gn)
    table = (graph[:, None] * gn + (torch.rand(n, 128, device=dev,
                                               generator=gen)
                                    * size[:, None]).long()).int()
    deg = torch.randint(1, 11, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    x_global = torch.randn(n, D, device=dev, generator=gen)
    picked = torch.randperm(G - 1, device=dev, generator=gen)[:DD["batch"]]
    real = (picked[:, None] * gn + torch.arange(gn, device=dev)).reshape(-1)
    N = -(-real.numel() // 128) * 128
    gidx = torch.zeros(N, dtype=torch.int32, device=dev)
    gidx[:real.numel()] = real.int()
    mask = (torch.arange(N, device=dev) < real.numel()).float()
    g64 = gidx.long()
    out = torch.randn(N, D, device=dev, generator=gen, requires_grad=True)
    cot = torch.randn(N, K + 1, D, device=dev, generator=gen)
    res = {}
    if hasattr(nt, "sample_neighborhoods"):
        def stage():
            feat, slots, _ = nt.sample_neighborhoods(seed, table, deg,
                                                     x_global, gidx, mask, K)
            return feat, torch.autograd.grad(out[slots], out, cot)

        def k7():
            return nt.sample_neighborhoods(seed, table, deg, x_global, gidx,
                                           mask, K)
    else:
        rows, deg_b = table[g64], deg[g64]

        def stage():
            neigh = nt.sample_neighbors(seed, rows, deg_b, gidx, K)
            feat = x_global[neigh.to(torch.int64)]
            r = global_regather(out, gidx, mask, neigh, n)
            return feat, torch.autograd.grad(r, out, cot)

        def k7():
            return nt.sample_neighbors(seed, rows, deg_b, gidx, K)

        res["batch"] = stage_profile(cs, lambda: (table[g64], deg[g64]))
    res["stage"] = stage_profile(cs, stage)
    res["k7"] = {"ms": cs.device_ms(k7, 20, ("gt_sample_kernel",))}
    return res


def node_step(cs, root, flags, k18) -> dict:
    """The node step of ``flags`` on Planetoid files of Cora's shape: 20
    steps by CUDA events after 3, and a profile of 5 (K18's kernels
    ``k18``)."""
    import torch

    from graph_transformer_tpu_torch.cli import train_node
    from graph_transformer_tpu_torch.train.node_trainer import NodeTrainer

    root_d = os.path.join(root, "build", "node", "cora")
    cs.write_planetoid_like(root_d)
    cfg, args = cs.node_config(flags + ["--citation_dir", root_d])
    t = NodeTrainer(train_node.load(args), cfg, device="cuda")
    for _ in range(3):
        t.train_step(t.next_seed())
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        t.train_step(t.next_seed())
    end.record()
    end.synchronize()
    prof = cs.profile_busy(lambda: [t.train_step(t.next_seed())
                                    for _ in range(5)], 5, sum_of=k18)
    node = {"ms_per_step": start.elapsed_time(end) / 20}
    if prof:
        node.update(busy_share=prof["busy_share"],
                    busy_ms_per_step=prof["busy_ms_per_step"],
                    k18_ms_per_step=prof["ms_per_step_of"])
    return node


def rows_gemm(cs, dev, root) -> dict:
    """K18 at the node step's launches (and the full-q shapes), each
    device ms a launch beside one library call, float32 then bf16 (x in
    bf16, the other operands float32, as the bf16 step's); the float32
    outputs kept under ``build/ab_k18.pt`` for :func:`bit_equal_k18`; then
    the node step in float32 and in bf16."""
    import torch

    from graph_transformer_tpu_torch.ops import rows_encoder as re

    k18_all = cs.K18_KERNELS + (K18_F32_BEFORE, K18_BF16_BEFORE)
    N, S, D, F = 2816, 5, 1433, 1024
    launches = cs.node_k18_launches(dev, N, S, D, F, views=False)
    keep = {}
    for name, (fn, *_) in launches.items():
        got = fn()
        keep[name] = [t.detach().cpu() for t in
                      (got if isinstance(got, tuple) else (got,))]
    torch.save(keep, os.path.join(root, "build", "ab_k18.pt"))
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(N * S, D, device=dev, generator=g)
    w = torch.randn(D, 3 * D, device=dev, generator=g) * 0.016
    b = torch.randn(3 * D, device=dev, generator=g)
    dqkv = torch.randn(N * S, 3 * D, device=dev, generator=g)
    launches["qkv nn (full q)"] = (lambda: re.gemm(x, w, bias=b),
                                   lambda: torch.addmm(b, x, w), 0, 0, 0)
    launches["dW_in tn (full q)"] = (lambda: re.weight_grad(x, dqkv),
                                     lambda: torch.mm(x.t(), dqkv), 0, 0, 0)
    launches.update({f"bf16 {k}": v for k, v in cs.node_k18_launches(
        dev, N, S, D, F, views=False, bf16=True).items()})
    k18, lib = {}, {}
    for name, (fn, ref, *_) in launches.items():
        k18[name] = cs.device_ms(fn, 10, k18_all)
        lib[name] = cs.time_ms(ref, 10)
    del x, w, b, dqkv, launches
    ms, share = k19_k20(cs, dev, N, S, D)
    return {"K18": k18, "library": lib, "K19_K20_ms": ms,
            "K19_K20_share_of_bound": share,
            "node": node_step(cs, root, cs.NODE_FLAGS, k18_all),
            "node_bf16": node_step(cs, root, cs.NODE_BF16_FLAGS, k18_all)}


def k19_k20(cs, dev, N, S, D) -> tuple:
    """K19's and K20's forward and backward at ``chip_smoke``'s two shapes
    (``rows_fwd_calls``, ``rows_bwd_calls``: the slot-0 layer's and a full
    layer's, float32, rate 0.5) on random rows: device ms a launch (K20's
    backward with its partial sums' kernel, whichever a checkout has) and
    the bytes bound's share of it."""
    import torch

    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    x, qkv = rnd(N * S, D), rnd(N * S, 3 * D)
    gamma, beta = 1.0 + 0.1 * rnd(D), 0.1 * rnd(D)
    ms, share = {}, {}
    for kind, calls in (("forward", cs.rows_fwd_calls(qkv, x, S, gamma, beta,
                                                      rnd)),
                        ("backward", cs.rows_bwd_calls(qkv, x, S, gamma, beta,
                                                       rnd))):
        for name, (fn, _, _, names, b, f) in calls.items():
            label = f"{name} {kind}"
            ms[label] = cs.device_ms(fn, 10, names + K20_BWD_BEFORE)
            share[label] = cs.bound(b, f, cs.F32_FLOP_PER_S)[0] / ms[label]
    return ms, share


def worker(root: str, only: str = "") -> dict:
    """The timings of the checkout at ``root`` (``only``: one family)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from graph_transformer_tpu_torch.ops import encoder_layer as el
    from graph_transformer_tpu_torch.ops import ffn
    from graph_transformer_tpu_torch.ops import folded_encoder as fe
    from graph_transformer_tpu_torch.ops import sampled_encoder as se
    from graph_transformer_tpu_torch.ops import stored_encoder as st
    from graph_transformer_tpu_torch.ops import u2gnn_train as ut
    from graph_transformer_tpu_torch.ops.attention import layer_forward
    from graph_transformer_tpu_torch.ops.u2gnn_encoder import (
        u2gnn_encoder_train)

    assert os.path.dirname(os.path.dirname(st.__file__)).startswith(
        os.path.abspath(root)), st.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    seed, rate, out = 2024, 0.5, {}
    F = 1024

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    if only == "narrow_fwd":
        return narrow_fwd(cs, dev, seed, rate)
    if only == "stored_bwd":
        return stored_bwd(cs, dev, seed, rate)
    if only == "sampler":
        return sampler(cs, dev, seed)
    if only == "rows_gemm":
        return rows_gemm(cs, dev, root)
    out.update(wide_fwd(cs, dev, seed, rate,
                        os.path.join(root, "build", "ab_keep.pt")))
    if only == "wide_fwd":
        return out
    out.update(narrow_fwd(cs, dev, seed, rate))
    # K12 and K11 at the node axis's rows
    M, D = 5760, 68
    rng = np.random.default_rng(3)
    pf = [torch.tensor(rng.standard_normal(s) * 0.3, dtype=torch.float32,
                       device=dev) for s in ((D, F), (F,), (F, D), (D,),
                                             (D,), (D,))]
    pf[4] = pf[4] + 1.0
    x = torch.randn(M, D, device=dev, generator=gen(3))
    g = torch.randn(M, D, device=dev, generator=gen(4))
    k12 = lambda: ffn.ffn_backward(x, g, *pf, rate, seed, 1)  # noqa: E731
    out["K12"] = {"ms": cs.device_ms(k12, 10, K12_ROW + K12_PRODUCTS),
                  "row_ms": cs.device_ms(k12, 10, K12_ROW),
                  "products_ms": cs.device_ms(k12, 10, K12_PRODUCTS)}
    out["K11"] = {"ms": cs.device_ms(
        lambda: ffn.ffn_forward(x, *pf, rate, seed, 1), 10,
        ("ff_fwd_kernel",))}

    def ffn64(xx, pp):
        """K11's function in float64, unrounded (chip_smoke.check_ffn)."""
        h = ffn.dropout(torch.relu(xx @ pp[0] + pp[1]), rate, seed, 1,
                        ffn.HIDDEN_SITE)
        u = xx + ffn.dropout(h @ pp[2] + pp[3], rate, seed, 1, ffn.OUT_SITE)
        mu = u.mean(-1, keepdim=True)
        var = ((u - mu) ** 2).mean(-1, keepdim=True)
        return (u - mu) / torch.sqrt(var + 1e-5) * pp[4] + pp[5]

    dxk, gk = k12()
    dxp, gp = ffn.ffn_backward_plain(x, g, *pf, rate, seed, 1)
    out["K12_f64"] = f64_worst(ffn64, x, g, pf, (dxk,) + tuple(gk),
                               (dxp,) + tuple(gp))

    # K8, K8s, K9, K2 at the HPO arm's batch and at the A/B rows
    for tag, (N, S, D, dt) in {"hpo": (512, 17, 6, torch.float32),
                               "ab": (8832, 9, 4, torch.bfloat16)}.items():
        _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=4,
                                      stored=4, seed=11, dev=dev)
        x = torch.randn(N, S, D, device=dev, generator=gen(5)).to(dt)
        g = torch.randn(N, S, D, device=dev, generator=gen(6))
        p0 = [a[0] for a in params]
        p3 = [a[3] for a in params]
        k8 = lambda: ut.layer_recompute_backward(  # noqa: E731
            x, g, params, 0, rate, seed)
        k8s = lambda: ut.slot0_recompute_backward(  # noqa: E731
            x, g[:, 0], params, 3, rate, seed)
        _, res = layer_forward(x.float(), p0, layer=0, rate=rate, seed=seed,
                               mm=torch.bfloat16, slot0=False)
        xb = x.to(torch.bfloat16)
        k2 = lambda: se.layer_backward(  # noqa: E731
            xb, res["qkv"], res["attn"], res["strip"], g, params, 0, rate,
            seed)
        x2 = x.reshape(N * S, D)
        k9 = lambda: el.encoder_layer_forward(x2, p0, S, rate, seed, 0)  # noqa
        out[f"K8_{tag}"] = {"ms": cs.device_ms(k8, 10, K8_ROW + REDUCE),
                            "row_ms": cs.device_ms(k8, 10, K8_ROW),
                            "fwd_ms": part_ms(k8, K8_FWD),
                            "reduce_ms": cs.device_ms(k8, 10, REDUCE)}
        out[f"K8s_{tag}"] = {"ms": cs.device_ms(k8s, 10, K8_ROW + REDUCE)}
        _, res0 = layer_forward(x.float(), p3, layer=3, rate=rate, seed=seed,
                                mm=torch.bfloat16, slot0=True)
        out[f"K3_{tag}"] = {"ms": cs.device_ms(
            lambda: se.slot0_backward(xb, res0["qkv"], res0["attn"],
                                      res0["strip"], g[:, 0], params, 3, rate,
                                      seed),
            10, ("gt_layer_bwd_kernel",) + REDUCE)}
        out[f"K9_{tag}"] = {"ms": cs.device_ms(k9, 10,
                                               ("gt_layer_fwd_kernel",))}
        out[f"K2_{tag}"] = {"ms": cs.device_ms(
            k2, 10, ("gt_layer_bwd_kernel",) + REDUCE),
            "row_ms": cs.device_ms(k2, 10, ("gt_layer_bwd_kernel",))}
    # K10 at the ACT run's rows
    N, S, D = 512, 9, 7
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=1, stored=1,
                                  seed=12, dev=dev)
    x = torch.randn(N * S, D, device=dev, generator=gen(7))
    g = torch.randn(N * S, D, device=dev, generator=gen(8))
    p0 = [a[0] for a in params]
    out["K10"] = {"ms": cs.device_ms(
        lambda: el.encoder_layer_backward(x, g, p0, S, rate, seed, 1), 10,
        K8_ROW + REDUCE)}

    # the quickstart's two-pass batch
    N, S, D, T = 640, 9, 68, 4
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                  seed=7, dev=dev, one_hot=True)
    rng = np.random.default_rng(7)
    x = torch.eye(D, device=dev)[torch.tensor(rng.integers(0, D, N * S),
                                              device=dev)].view(N, S, D)
    g = torch.randn(N, S, D, device=dev, generator=gen(7))
    p0 = [a[0] for a in params]
    calls = {
        "K8w": lambda: ut.wide_layer_recompute_backward(x, g, params, 0, rate,
                                                        seed),
        "K8ws": lambda: ut.wide_slot0_recompute_backward(
            x, g[:, 0], params, T - 1, rate, seed),
        "K10w": lambda: el.wide_encoder_layer_backward(
            x.view(N * S, D), g.view(N * S, D), p0, S, rate, seed),
    }
    for key, fn in calls.items():
        out[key] = {"ms": cs.device_ms(fn, 10, ROW + PRODUCTS),
                    "row_ms": cs.device_ms(fn, 10, ROW),
                    "products_ms": cs.device_ms(fn, 10, PRODUCTS)}

    # the float32 accuracy of K8w against the float64 function
    for D in (40, 68):
        N, S = 256, 9
        _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=1,
                                      stored=1, seed=13, dev=dev)
        x = torch.randn(N, S, D, device=dev, generator=gen(9))
        g = torch.randn(N, S, D, device=dev, generator=gen(10))
        p0 = [a[0] for a in params]
        dxk, gk = ut.wide_layer_recompute_backward(x, g, params, 0, rate,
                                                   seed)
        dxp, gp = ut.layer_recompute_backward_plain(
            x, g, p0, layer=0, rate=rate, seed=seed, mm=torch.float32,
            slot0=False)
        out[f"K8w_f64_D{D}"] = f64_worst(
            lambda xx, pp: layer_forward(xx, pp, layer=0, rate=rate,
                                         seed=seed, mm=torch.float32,
                                         slot0=False)[0],
            x, g, p0, (dxk,) + tuple(gk), (dxp,) + tuple(gp))

    # the A/B scripts' rows
    N, S, D = 8832, 9, 4
    _, params, x2d = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                    seed=8, dev=dev)
    lib = cs.library_encoder(params, S, T, D, F, dev, torch.bfloat16, rate)
    x3 = x2d.view(N, S, D)
    out["K17"] = {"ms": cs.device_ms(
        lambda: st.stored_rows_forward(x2d, params, S, T, rate, seed), 10,
        FWD)}
    out["K15"] = {"ms": cs.device_ms(
        lambda: fe.folded_stored_forward(x2d, params, S, T, rate, seed), 10,
        FWD)}
    out["library"] = {"ms": cs.time_ms(lambda: lib(x3), 10)}
    _, xs = u2gnn_encoder_train(x2d, params, S, T, rate, seed)
    g = torch.randn(N, D, device=dev, generator=gen(9))
    out["K14"] = {"ms": cs.device_ms(
        lambda: ut.mega_recompute_backward(x2d, xs, g, params, S, T, rate,
                                           seed), 3,
        ("gt_mega_bwd_kernel", "gt_mega_reduce_kernel"))}

    # the same rows at the quickstart's width
    D = 68
    _, params, _ = cs.random_case(N=N, S=S, D=D, C=D, F=F, Tn=T, stored=T,
                                  seed=9, dev=dev, one_hot=True)
    x2d = torch.eye(D, device=dev)[torch.tensor(
        rng.integers(0, D, N * S), device=dev)].to(torch.bfloat16)
    _, xs = u2gnn_encoder_train(x2d, params, S, T, rate, seed)
    g = torch.randn(N, D, device=dev, generator=gen(9))
    out["K14w"] = {"ms": cs.device_ms(
        lambda: ut.mega_recompute_backward(x2d, xs, g, params, S, T, rate,
                                           seed), 3,
        ("wd_mega_bwd_kernel",) + PRODUCTS + ("gt_mega_reduce_kernel",))}
    return out


def bit_equal(root_a: str, root_b: str) -> dict:
    """Whether the outputs :func:`wide_fwd` kept at two checkouts are equal
    bit for bit, by kernel."""
    import torch

    a, b = (torch.load(os.path.join(r, "build", "ab_keep.pt"))
            for r in (root_a, root_b))
    return {k: len(a[k]) == len(b[k]) and all(
        torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}


def bit_equal_k18(root_a: str, root_b: str) -> dict:
    """Whether K18's float32 outputs that :func:`rows_gemm` kept at two
    checkouts are equal bit for bit, by launch."""
    import torch

    a, b = (torch.load(os.path.join(r, "build", "ab_k18.pt"))
            for r in (root_a, root_b))
    return {k: len(a[k]) == len(b[k]) and all(
        torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}


def main() -> int:
    import torch

    args = sys.argv[1:]
    only = ""
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
    if len(args) > 1 and args[0] == "--worker":
        print(json.dumps(worker(args[1], only)))
        return 0
    if not torch.cuda.is_available():
        print("torch_ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    logs = os.path.join(HERE, "chiprun_out")
    os.makedirs(logs, exist_ok=True)
    builds = []
    for n, r in enumerate(dict.fromkeys(roots)):
        log = open(os.path.join(logs, f"ptxas-{n}.log"), "w")
        log.write(f"# {r}\n")
        log.flush()
        names = ONLY_SOURCES.get(only)
        builds.append(subprocess.Popen(
            [sys.executable, "-c", "from graph_transformer_tpu_torch.ops "
             "import _build; print(_build.build_all("
             + (f"{names!r}, " if names else "") + "verbose=True))"], cwd=r,
            stdout=log, stderr=subprocess.STDOUT))
    if any(b.wait() for b in builds):
        print("torch_ab_kernels: a build failed (chiprun_out/ptxas-*.log)",
              file=sys.stderr)
        return 1
    runs = []
    for r in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *(["--only", only] if only else []),
                              "--worker", r], capture_output=True, text=True,
                             cwd=r)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
            return 1
        t = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"root": r, **t})
        print(f"# {r}: " + "; ".join(
            f"{k} " + ", ".join(f"{n} {v:.4g}" for n, v in d.items())
            for k, d in t.items()), flush=True)
    if len(roots) > 1 and roots[1] != roots[0] and only in ("", "wide_fwd"):
        eq = bit_equal(roots[0], roots[1])
        print(f"# bit for bit, {roots[1]} against {roots[0]}: " + ", ".join(
            f"{k} {'equal' if v else 'differ'}" for k, v in eq.items()),
            flush=True)
        runs.append({"bit_equal": eq})
    if len(roots) > 1 and roots[1] != roots[0] and only == "rows_gemm":
        eq = bit_equal_k18(roots[0], roots[1])
        print(f"# K18 float32 bit for bit, {roots[1]} against {roots[0]}: "
              + ", ".join(f"{k} {'equal' if v else 'differ'}"
                          for k, v in eq.items()), flush=True)
        runs.append({"bit_equal_k18": eq})
    print(json.dumps({"runs": runs}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
