// Wide K4 — eval encoder forward over pre-gathered rows of 32 < D <= 128,
// and K4tw — the same forward in training mode.
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (entry
// fused_u2gnn_encoder) at the widths that K4 (encoder_fwd.cu, one thread per
// row with D floats in registers and all weights in shared memory) cannot
// take.  T post-norm encoder layers over rows x [N*S, D] in bf16 or f32
// (product operands take that dtype), the last layer for slot 0 only, output
// [N, D] f32.  It is K5's layer loop (wide_tc_fwd.cuh) without the sampler
// and without residual writes.  K4tw draws its dropout from the seed and
// writes the inputs of layers 1..T-1 in the rows' dtype (the kernel's
// saved_refs, pallas_u2gnn.py:271-281), which the wide recompute backward
// K8w reads back; float32 rows keep float32 products, as the TPU kernel
// chooses at :271.
//
// Bound on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W) at the README
// quickstart's two-pass batch (N=640, S=9, D=68, F=1024, T=4, float32):
// ~5.8 GFLOP of products against ~1.6 MB of rows, so the operations
// (0.087 ms at the 67 TFLOP/s of float32 outside the tensor cores).
// With bf16 rows of D <= 80 the products run on the tensor cores
// (wt_fwd_layer, mma.sync m16n8k16); float32 rows keep float32 FMAs in K
// order on the CUDA cores (wd_fwd_layer, 4 x 4 register tiles), the only
// order found that holds the float32 checks (both in wide_tc_fwd.cuh).
#include "wide_tc_fwd.cuh"

extern "C" size_t gt_k4w_smem_bytes(int G, int S, int D) {
  return wt_fwd_smem_bytes_any(G, S, D);
}

extern "C" int gt_k4w_encoder_fwd(const void* x_rows, int x_bf16,
                                  const float* const* params, int stored,
                                  float* out, int N, int S, int D, int F,
                                  int T, int G, float scale,
                                  const long long* seed, unsigned int keep24,
                                  float keep, int drop_on, void* stream) {
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
                                   const long long* seed, unsigned int keep24,
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
