// K13 — the fused sampler with the recompute backward's forward: sample,
// build the layer-0 rows from the codebook and run the T-layer encoder,
// saving every layer's input for the recompute backward (K8/K8w).
//
// Replaces graph_transformer_tpu/ops/pallas_sampled_encoder.py:
// _sampled_fwd_kernel (entry fused_u2gnn_encoder_sampled).  Per
// neighborhood: draw S-1 neighbor tags uniformly from the first min(deg, 128)
// entries of the node's tag row, build x0 = bf16(onehot(tag) @ codebook)
// (a codebook row, rounded to bf16, :160-180), run T post-norm encoder layers
// (the last for slot 0 only) with bf16 product operands whatever the model's
// compute dtype (:263, :272), and write the slot-0 output [N, D] f32 and the
// inputs of layers 0..T-1 [T, N*S, D] in bf16: x0 and the saved_refs, what
// the hybrid backward (kernel 5, here K8s then K8 per earlier layer) reads.
// Nothing else of the forward is written.
//
// The TPU kernel draws neighbors from its on-core PRNG; this one draws them
// with K1's counters (GT_SAMPLER_STREAM, element n*(S-1)+k) and its dropout
// from sites 4t..4t+3, so for one seed its neighborhoods and its output are
// K1's (D <= 32, one thread per row: gt_encoder_fwd_kernel, common.cuh) and
// K5's (32 < D <= 128, a warp per row: wd_encoder_fwd_kernel,
// wide_tc_fwd.cuh),
// bit for bit: the same code runs, minus the residual writes.
//
// Bound on the H100 at the bench shapes (N=8,832, S=9, D=4, F=1024, T=4):
// ~3.8 GFLOP of bf16 products against ~2.6 MB of saved rows, so the
// operations (~4 us at 989 TFLOP/s); at the quickstart's (N=640, S=9, D=68)
// likewise; at the bench's rows the hidden's dropout words bound it, as
// K1.  Up to D = 32 it runs K1's layer (the FFN on the tensor cores); for
// 32 < D <= 80 K5's, on the tensor cores (mma.sync m16n8k16 with bf16
// operands).
#include "wide_tc_fwd.cuh"

extern "C" size_t gt_k13_smem_bytes(int G, int S, int D) {
  return gt_fwd_smem_bytes(G, S, D);
}

extern "C" size_t gt_k13w_smem_bytes(int G, int S, int D) {
  return wt_fwd_smem_bytes_any(G, S, D);
}

// K13.  tag_rows [N, table_w], deg [N], self_tag [N] int32, codebook [C, D]
// f32, draws [N, S-1] made outside (or null: the in-kernel sampler),
// draws_out [N, S-1] (or null); out [N, D] f32, xs [T, N*S, D] bf16.  Rows of
// D <= 32 take the narrow kernel, 32 < D <= 128 the wide one (G is the
// caller's pick for that kernel).
extern "C" int gt_k13_sampled_fwd(
    const int* tag_rows, int table_w, const int* deg, const int* self_tag,
    const float* codebook, const int* draws, int* draws_out,
    const float* const* params, int stored, float* out, void* xs, int N,
    int S, int D, int F, int T, int G, float scale, unsigned int seed,
    unsigned int keep24, float keep, int drop_on, void* stream) {
  const GtStack st = gt_make_stack(params, stored);
  const GtDrop dr{seed, keep24, keep, drop_on};
  if (D > 32) {
    WdFwdIO io = {};
    io.tag_rows = tag_rows;
    io.deg = deg;
    io.self_tag = self_tag;
    io.codebook = codebook;
    io.draws = draws;
    io.draws_out = draws_out;
    io.table_w = table_w;
    io.out = out;
    io.xs = xs;
    io.xs_bf16 = 1;
    return (int)wd_launch_fwd(io, st, dr, N, S, D, F, T, G, scale,
                              /*mmbf=*/1, /*sampled=*/1, (cudaStream_t)stream);
  }
  GtFwdIO io = {};
  io.tag_rows = tag_rows;
  io.deg = deg;
  io.self_tag = self_tag;
  io.codebook = codebook;
  io.draws = draws;
  io.draws_out = draws_out;
  io.table_w = table_w;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = 1;
  return (int)gt_dispatch_fwd(io, st, dr, N, S, D, F, T, G, scale, /*mmbf=*/1,
                              /*sampled=*/1, (cudaStream_t)stream);
}
