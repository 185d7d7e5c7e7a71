// K5 — sampled wide-row encoder forward that stores its residuals, and
// K17 — the same forward on given rows.
//
// Replaces graph_transformer_tpu/ops/pallas_stored_bwd.py:
// _sampled_stored_fwd_kernel (entry fused_u2gnn_encoder_sampled_stored), the
// path of the shapes that the folded kernels (K1-K3) do not take: D up to 128
// (one-hot degree tags of IMDB*, NCI*) and S up to 32.  Per neighborhood: draw
// S-1 neighbor tags uniformly from the first min(deg, 128) entries of the
// node's tag row, build x0 = bf16(codebook[tag]), run T post-norm encoder
// layers (the last for slot 0 only) and write what K6 reads: the layer inputs
// (bf16), q/k/v, the attention probabilities, the LayerNorm strip
// [ctx, y1, uhat1, uhat2, rstd1, rstd2] and the FFN hidden after its dropout,
// h [rows, F] in bf16.  With h stored, K6 needs neither the hidden's
// recompute nor its mask: relu' times the dropout factor is (h > 0) / keep.
// The other three dropout masks are replayed from their counters.
//
// Bound at N=4096, S=9, D=65, F=1024, T=4, from the H100 SXM data sheet's
// rates (3.35 TB/s, 989 TFLOP/s bf16): the stored hidden is 3 x 75 MB + 8 MB
// of writes, so the bytes bound it (~0.08 ms) against ~36 GFLOP of bf16
// products (~0.036 ms).  For 32 < D <= 80 the layer (wt_fwd_layer,
// wide_tc_fwd.cuh) runs its products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulation) and stores the hidden from
// the accumulators; elsewhere on the CUDA cores (wd_fwd_layer).
#include "wide_tc_fwd.cuh"

extern "C" size_t gt_k5_smem_bytes(int G, int S, int D) {
  return wt_fwd_smem_bytes_any(G, S, D);
}

extern "C" int gt_k5_stored_fwd(
    const int* tag_rows, int table_w, const int* deg, const int* self_tag,
    const float* codebook, const int* draws, int* draws_out,
    const float* const* params, int stored, float* out, void* xs, float* qkv,
    float* attn_full, float* attn_last, float* strip_full, float* strip_last,
    void* h_full, void* h_last, int N, int S, int D, int F, int T, int G,
    float scale, unsigned int seed, unsigned int keep24, float keep,
    int drop_on, void* stream) {
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
  io.qkv = qkv;
  io.attn_full = attn_full;
  io.attn_last = attn_last;
  io.strip_full = strip_full;
  io.strip_last = strip_last;
  io.h_full = h_full;
  io.h_last = h_last;
  io.h_bf16 = 1;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)wd_launch_fwd(io, gt_make_stack(params, stored), dr, N, S, D, F,
                            T, G, scale, /*mmbf=*/1, /*sampled=*/1,
                            (cudaStream_t)stream);
}

// K17 — the stored-residual forward on given rows.
//
// Replaces graph_transformer_tpu/ops/pallas_stored_bwd.py:_stored_fwd_kernel
// (entry fused_u2gnn_encoder_stored): K5 without the sampler.  Rows x
// [N*S, D] in bf16 or f32 (x_bf16), products in that dtype, T layers (the
// last for slot 0 only); writes out [N, D] f32, the inputs of layers
// 1..T-1 in the rows' dtype (layer 0's is x), and per layer q/k/v, the
// probabilities and the strip in f32 and the FFN hidden after its dropout
// in the rows' dtype (pallas_stored_bwd.py:167-171; K5 keeps it in bf16),
// which K6 reads back.
//
// Bound on the H100 at the A/B workload (79,488 rows, S=9, D=4, F=1024,
// T=4, bf16): the stored hidden, ~0.5 GB of bf16 writes, bounds it
// (~0.16 ms at 3.35 TB/s) against ~4 GFLOP of products.  For D <= 32 K17
// runs K1's layer (common.cuh: gt_fwd_layer, a thread per row for the
// row-wise steps, the FFN on the tensor cores over the block's 8 warps), as
// K15 does, and the hidden goes to device memory from the mma accumulators,
// two columns a lane; a warp per 4-wide row (K5's layer) left 28 of its 32
// lanes idle in every row-wise step.  Past D = 32 it runs K5's layer loop
// (wide_tc_fwd.cuh: with bf16 rows of D <= 80 the products on the tensor
// cores, mma.sync m16n8k16; with float32 rows on the CUDA cores).
extern "C" size_t gt_k17_smem_bytes(int G, int S, int D) {
  return D <= 32 ? gt_fwd_smem_bytes(G, S, D)
                 : wt_fwd_smem_bytes_any(G, S, D);
}

extern "C" int gt_k17_stored_rows_fwd(
    const void* x_rows, int x_bf16, const float* const* params, int stored,
    float* out, void* xs, float* qkv, float* attn_full, float* attn_last,
    float* strip_full, float* strip_last, void* h_full, void* h_last, int N,
    int S, int D, int F, int T, int G, float scale, unsigned int seed,
    unsigned int keep24, float keep, int drop_on, void* stream) {
  const GtStack st = gt_make_stack(params, stored);
  GtDrop dr{seed, keep24, keep, drop_on};
  if (D <= 32) {
    GtFwdIO io = {};
    io.x_rows = x_rows;
    io.x_bf16 = x_bf16;
    io.out = out;
    io.xs = xs;
    io.xs_bf16 = x_bf16;
    io.xs_first = 1;
    io.qkv = qkv;
    io.attn_full = attn_full;
    io.attn_last = attn_last;
    io.strip_full = strip_full;
    io.strip_last = strip_last;
    io.h_full = h_full;
    io.h_last = h_last;
    io.h_bf16 = x_bf16;
    return (int)gt_dispatch_fwd</*H=*/true>(io, st, dr, N, S, D, F, T, G,
                                              scale, /*mmbf=*/x_bf16,
                                              /*sampled=*/0,
                                              (cudaStream_t)stream);
  }
  WdFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = x_bf16;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = x_bf16;
  io.xs_first = 1;
  io.qkv = qkv;
  io.attn_full = attn_full;
  io.attn_last = attn_last;
  io.strip_full = strip_full;
  io.strip_last = strip_last;
  io.h_full = h_full;
  io.h_last = h_last;
  io.h_bf16 = x_bf16;
  return (int)wd_launch_fwd(io, st, dr, N, S, D, F, T, G, scale,
                            /*mmbf=*/x_bf16, /*sampled=*/0,
                            (cudaStream_t)stream);
}
