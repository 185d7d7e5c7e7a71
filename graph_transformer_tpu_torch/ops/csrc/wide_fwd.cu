// Wide K4 — eval encoder forward over pre-gathered rows of 32 < D <= 128,
// and K4tw — the same forward in training mode.
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (entry
// fused_u2gnn_encoder) at the widths that K4 (encoder_fwd.cu, one thread per
// row with D floats in registers and all weights in shared memory) cannot
// take.  T post-norm encoder layers over rows x [N*S, D] in bf16 or f32
// (product operands take that dtype), the last layer for slot 0 only, output
// [N, D] f32.  It is K5's layer loop (wide.cuh) without the sampler and
// without residual writes.  K4tw draws its dropout from the seed and writes
// the inputs of layers 1..T-1 in the rows' dtype (the kernel's saved_refs,
// pallas_u2gnn.py:271-281), which the wide recompute backward K8w reads back;
// float32 rows keep float32 products, as the TPU kernel chooses at :271.
//
// Bound at N=4096, S=9, D=65, F=1024, T=4, from the H100 SXM data sheet's
// rates: ~36 GFLOP of bf16 products against 4.8 MB of bf16 rows, so the
// operations bound it (~0.036 ms at 989 TFLOP/s).  The products run on the
// CUDA cores (wide.cuh) and bound this version; tensor-core products are
// later work.
#include "wide.cuh"

extern "C" size_t gt_k4w_smem_bytes(int G, int S, int D) {
  return wd_fwd_smem_bytes(G, S, D);
}

extern "C" int gt_k4w_encoder_fwd(const void* x_rows, int x_bf16,
                                  const float* const* params, int stored,
                                  float* out, int N, int S, int D, int F,
                                  int T, int G, float scale, unsigned int seed,
                                  unsigned int keep24, float keep, int drop_on,
                                  void* stream) {
  WdFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = x_bf16;
  io.out = out;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)wd_launch_fwd(io, gt_make_stack(params, stored), dr, N, S, D, F,
                            T, G, scale, /*mmbf=*/x_bf16, /*sampled=*/0,
                            (cudaStream_t)stream);
}

// K4tw.  xs: [T-1, N*S, D] in the rows' dtype (null when T == 1)
extern "C" int gt_k4tw_encoder_fwd(const void* x_rows, int x_bf16,
                                   const float* const* params, int stored,
                                   float* out, void* xs, int N, int S, int D,
                                   int F, int T, int G, float scale,
                                   unsigned int seed, unsigned int keep24,
                                   float keep, int drop_on, void* stream) {
  WdFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = x_bf16;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = x_bf16;
  io.xs_first = 1;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)wd_launch_fwd(io, gt_make_stack(params, stored), dr, N, S, D, F,
                            T, G, scale, /*mmbf=*/x_bf16, /*sampled=*/0,
                            (cudaStream_t)stream);
}
