// K4 — eval encoder forward over pre-gathered rows, and K4t — the same
// forward in training mode.
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (entry
// fused_u2gnn_encoder): T post-norm encoder layers over rows x [N*S, D] in the
// compute dtype (bf16 or f32; product operands take that dtype), the last
// layer for slot 0 only, output [N, D] f32.  It shares its device code with
// K1 (common.cuh).  K4 writes no residuals; K4t draws its dropout from the
// seed and writes the inputs of layers 1..T-1 in the rows' dtype (the
// kernel's saved_refs), which the recompute backward K8 reads back.
//
// Bound on the H100: at the bench shapes the input is 0.6 MB of bf16 rows and
// the FFN ~3.8 GFLOP of bf16 products, so the bound is the operations
// (~4 us at 989 TFLOP/s); at the MUTAG HPO arm's K4t (8,704 float32 rows,
// S=17, D=6, T=5) likewise, 0.013 ms at 67 TFLOP/s.  A block of 8 warps
// holds few neighborhoods at few rows (the HPO arm), so that the grid fills
// the card, and as many as fill whole waves at many (_build.pick_fwd_groups);
// the FFN runs on the tensor cores (bf16 mma.sync, float32 3xTF32), each
// warp owning a slice of the hidden columns with its output partial in mma
// accumulators (gt_ffn_tc, common.cuh).
#include "common.cuh"

extern "C" size_t gt_k4_smem_bytes(int G, int S, int D) {
  return gt_fwd_smem_bytes(G, S, D);
}

extern "C" int gt_k4_encoder_fwd(const void* x_rows, int x_bf16,
                                 const float* const* params, int stored,
                                 float* out, int N, int S, int D, int F, int T,
                                 int G, float scale, unsigned int seed,
                                 unsigned int keep24, float keep, int drop_on,
                                 void* stream) {
  GtFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = x_bf16;
  io.out = out;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)gt_dispatch_fwd(io, gt_make_stack(params, stored), dr, N, S, D,
                              F, T, G, scale, /*mmbf=*/x_bf16,
                              /*sampled=*/0, (cudaStream_t)stream);
}

// K4t.  xs: [T-1, N*S, D] in the rows' dtype (null when T == 1)
extern "C" int gt_k4t_encoder_fwd(const void* x_rows, int x_bf16,
                                  const float* const* params, int stored,
                                  float* out, void* xs, int N, int S, int D,
                                  int F, int T, int G, float scale,
                                  unsigned int seed, unsigned int keep24,
                                  float keep, int drop_on, void* stream) {
  GtFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = x_bf16;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = x_bf16;
  io.xs_first = 1;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)gt_dispatch_fwd(io, gt_make_stack(params, stored), dr, N, S, D,
                              F, T, G, scale, /*mmbf=*/x_bf16,
                              /*sampled=*/0, (cudaStream_t)stream);
}
