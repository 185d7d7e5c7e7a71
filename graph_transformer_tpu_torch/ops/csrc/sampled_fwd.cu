// K1 — sampled encoder forward with residuals.
//
// Replaces graph_transformer_tpu/ops/pallas_folded.py:_folded_sampled_fwd_kernel
// (entry folded_u2gnn_encoder_sampled).  Per neighborhood: draw S-1 neighbor
// tags uniformly from the node's 128-wide tag row (degree clamped to
// [1, 128]), build x0 = bf16(codebook[tag]), run T post-norm encoder layers
// (the last one for slot 0 only) and write the residuals that K2/K3 read:
// layer inputs (bf16), q/k/v, attention probabilities and the LayerNorm strip
// [ctx, y1, uhat1, uhat2, rstd1, rstd2].  The FFN hidden is not stored.
//
// Bound on the H100: at the bench shapes (N=8.2K, S=9, D=4, F=1024, T=4) the
// FFN is ~3.8 GFLOP of bf16 products against ~20 MB of residual writes, so the
// bound is the bytes (~6 us at 3.35 TB/s).  It runs the forward layer of
// common.cuh (gt_fwd_layer): a thread per row for the row-wise steps, the
// FFN on the tensor cores over all the block's warps, the blocks sized to
// fill whole waves of the card (_build.pick_fwd_groups).  The FFN hidden's
// dropout draws an integer hash per element (~253 M at those shapes); the
// kernel is bound by those integer instructions, not by memory or the
// products (PERF.md).
#include "common.cuh"

extern "C" size_t gt_k1_smem_bytes(int G, int S, int D) {
  return gt_fwd_smem_bytes(G, S, D);
}

extern "C" int gt_k1_sampled_fwd(
    const int* tag_rows, int table_w, const int* deg, const int* self_tag,
    const float* codebook, const int* draws, int* draws_out,
    const float* const* params, int stored, float* out, void* xs, float* qkv,
    float* attn_full, float* attn_last, float* strip_full, float* strip_last,
    int N, int S, int D, int F, int T, int G, float scale, unsigned int seed,
    unsigned int keep24, float keep, int drop_on, void* stream) {
  GtFwdIO io = {};
  io.tag_rows = tag_rows;
  io.deg = deg;
  io.self_tag = self_tag;
  io.codebook = codebook;
  io.draws = draws;
  io.draws_out = draws_out;
  io.table_w = table_w;
  io.x_rows = nullptr;
  io.x_bf16 = 0;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = 1;
  io.xs_first = 0;
  io.qkv = qkv;
  io.attn_full = attn_full;
  io.attn_last = attn_last;
  io.strip_full = strip_full;
  io.strip_last = strip_last;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)gt_dispatch_fwd(io, gt_make_stack(params, stored), dr, N, S, D,
                              F, T, G, scale, /*mmbf=*/1, /*sampled=*/1,
                              (cudaStream_t)stream);
}
