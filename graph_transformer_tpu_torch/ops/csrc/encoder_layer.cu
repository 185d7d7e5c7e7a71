// K9 — one post-norm encoder layer over rows x [N*S, D], every row out, and
// K10 — its backward recomputed from x; K9w and K10w — the same for rows of
// 32 < D <= 128, a warp per row.
//
// Replace graph_transformer_tpu/ops/pallas_encoder.py:_fwd_kernel and
// _bwd_kernel (entry fused_encoder_layer), which the JAX per-layer encoder
// runs once per timestep (ops/attention.py:_encoder_layer) for single-head,
// unmasked layers: the Universal-Transformer recurrences and the tied
// weights between them.  Attention stays within each node's S rows.
// Contract: x in bf16 or f32 (products take operands in that dtype and
// accumulate in f32), one layer's 12 tensors (KERNEL_ORDER), seed and
// timestep `layer` (dropout streams 4*layer+site).  K9 returns all S rows in
// x's dtype; K10 returns dx [N*S, D] f32 and the 12 weight gradients f32.
//
// The TPU kernel's dense [R, R] block-masked attention is a layout for the
// TPU's matrix unit and is not carried over: K9 is the forward layer code of
// K1/K4/K4t/K8 (gt_fwd_layer, a thread per row for attention and the
// LayerNorms, G neighborhoods a block, the [rows, F] hidden never in device
// memory), run as a full layer and writing every row; K10 is K8's recompute
// backward (recompute.cuh) over one layer's tensors.
//
// Bound on the H100: operations.  A row costs ~4*D*F product operations
// forward (~12*D*F backward) against ~4*D bytes of x and out; at the ACT
// workload's shapes (N = 512 padded nodes, S = 9, D = 7, F = 1024, float32)
// the forward's ~0.27 GFLOP of float32 products take ~4 us at 67 TFLOP/s.
// K9 fills the card with blocks of 8 warps over few neighborhoods
// (_build.pick_fwd_groups) and runs its FFN on the tensor cores (3xTF32 for
// float32 rows), each warp owning a slice of the hidden columns (gt_ffn_tc,
// common.cuh), as K10's recompute forward does.
//
// K9w is the wide forward layer (wide_tc_fwd.cuh) run as a full layer that
// writes every row in the rows' dtype; K10w is K8w's
// recompute backward (wide_recompute.cuh) over one layer's tensors,
// replacing pallas_encoder.py:_bwd_kernel past D=32.  Bound on an H100 SXM
// (NVIDIA H100 80GB HBM3, 700 W) at the quickstart's ACT rows (5,760
// float32 rows, D=68, F=1024): the operations, 1.83 GFLOP forward, 0.027 ms
// at the 67 TFLOP/s of float32 outside the tensor cores (K10w ~0.08 ms).
// With bf16 rows of D <= 80 K9w's four products run on the tensor cores
// (mma.sync m16n8k16), with float32 rows as FMAs in K order on the CUDA
// cores (wide_tc_fwd.cuh); K10w's row kernel's products and the split-K weight
// products (wd_products, wide_mma.cuh) run on the tensor cores, as 3xTF32 for
// float32 rows.
#include "recompute.cuh"
#include "wide_recompute.cuh"
#include "wide_tc_fwd.cuh"

extern "C" size_t gt_k9_smem_bytes(int G, int S, int D) {
  return gt_fwd_smem_bytes(G, S, D);
}

extern "C" size_t gt_k10_smem_bytes(int G, int S, int D) {
  return gt_recompute_smem_bytes(G, S, D, false);
}

template <int DM>
__global__ void __launch_bounds__(GT_BWD_THREADS, GT_FWD_MIN_BLOCKS(DM))
gt_layer_fwd_kernel(const void* x, int x_bf16, void* out, GtLayer w, GtDrop dr,
                    int layer, int N, int S, int D, int F, int G,
                    float scale) {
  extern __shared__ float smem[];
  const int r = threadIdx.x;
  const int g = r / S;
  const int i = r - g * S;
  const int n = blockIdx.x * G + g;
  const bool valid = (r < G * S) && (n < N);
  const size_t row = (size_t)n * S + i;
  float xr[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) xr[d] = 0.f;
  if (valid) gt_load_row<DM>(x, x_bf16, row, D, xr);
  GtLayerOut lo = {};
  gt_fwd_layer<DM>(smem, w, dr, layer, /*last=*/false, lo, xr, N, S, D, F, G,
                   scale, x_bf16);
  if (!valid) return;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < D) {
      if (x_bf16)
        ((__nv_bfloat16*)out)[row * D + d] = __float2bfloat16(xr[d]);
      else
        ((float*)out)[row * D + d] = xr[d];
    }
}

// a block of G neighborhoods, G * S <= GT_BWD_THREADS rows
template <int DM>
static cudaError_t launch_k9(const void* x, int x_bf16, void* out,
                             const GtLayer& w, const GtDrop& dr, int layer,
                             int N, int S, int D, int F, int G, float scale,
                             cudaStream_t stream) {
  if (G < 1 || G * S > GT_BWD_THREADS) return cudaErrorInvalidValue;
  const size_t smem = gt_fwd_smem_bytes(G, S, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gt_layer_fwd_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + G - 1) / G;
  gt_layer_fwd_kernel<DM><<<blocks, GT_BWD_THREADS, smem, stream>>>(
      x, x_bf16, out, w, dr, layer, N, S, D, F, G, scale);
  return cudaGetLastError();
}

// K9.  x, out [N*S, D] (bf16 if x_bf16, else f32); params: one layer's 12
// tensors
extern "C" int gt_k9_layer_fwd(const void* x, int x_bf16, void* out,
                               const float* const* params, int layer, int N,
                               int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  const GtLayer w = gt_layer_at(gt_make_stack(params, 1), 0, D, F);
  const GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 4) return (int)launch_k9<4>(x, x_bf16, out, w, dr, layer, N, S, D, F, G, scale, s);
  if (D <= 8) return (int)launch_k9<8>(x, x_bf16, out, w, dr, layer, N, S, D, F, G, scale, s);
  if (D <= 16) return (int)launch_k9<16>(x, x_bf16, out, w, dr, layer, N, S, D, F, G, scale, s);
  if (D <= 32) return (int)launch_k9<32>(x, x_bf16, out, w, dr, layer, N, S, D, F, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K10.  x [N*S, D] (bf16 if x_bf16, else f32), dout [N*S, D] f32, params:
// one layer's 12 tensors; scratch and outputs as K8 (recompute_bwd.cu)
extern "C" int gt_k10_layer_bwd(const void* x, int x_bf16, const float* dout,
                                const float* const* params, int layer,
                                float* dx, float* qkv, float* attn,
                                float* strip, float* partial, float* grads,
                                int N, int S, int D, int F, int G, float scale,
                                unsigned int seed, unsigned int keep24,
                                float keep, int drop_on, void* stream) {
  return gt_dispatch_recompute<false>(x, x_bf16, dout, params, /*stored=*/1,
                                      layer, dx, qkv, attn, strip, partial,
                                      grads, N, S, D, F, G, scale, seed,
                                      keep24, keep, drop_on, stream);
}

extern "C" size_t gt_k9w_smem_bytes(int G, int S, int D) {
  return wt_fwd_smem_bytes_any(G, S, D);
}

extern "C" size_t gt_k10w_smem_bytes(int G, int S, int D) {
  return wd_recompute_mma_smem_bytes(G, S, D, false);
}

extern "C" size_t gt_k10w_work_bytes(int N, int S, int D, int F, int G,
                                     int slot0, int x_bf16) {
  WdBwdWork w;
  return wd_bwd_work(N, S, D, F, G, slot0 != 0, x_bf16, true, nullptr, &w);
}

// K9w.  x, out [N*S, D] (bf16 if x_bf16, else f32); params: one layer's 12
// tensors; dropout streams of timestep `layer`
extern "C" int gt_k9w_layer_fwd(const void* x, int x_bf16, void* out,
                                const float* const* params, int layer, int N,
                                int S, int D, int F, int G, float scale,
                                unsigned int seed, unsigned int keep24,
                                float keep, int drop_on, void* stream) {
  WdFwdIO io = {};
  io.x_rows = x;
  io.x_bf16 = x_bf16;
  io.t0 = layer;
  io.rows_out = out;
  const GtDrop dr{seed, keep24, keep, drop_on};
  return (int)wd_launch_fwd(io, gt_make_stack(params, 1), dr, N, S, D, F,
                            /*T=*/1, G, scale, /*mmbf=*/x_bf16, /*sampled=*/0,
                            (cudaStream_t)stream);
}

// K10w.  x [N*S, D] (bf16 if x_bf16, else f32), dout [N*S, D] f32, params:
// one layer's 12 tensors; work: gt_k10w_work_bytes(..., 0, x_bf16) bytes;
// out: dx [N*S, D] f32, grads [P]
extern "C" int gt_k10w_layer_bwd(const void* x, int x_bf16, const float* dout,
                                 const float* const* params, int layer,
                                 float* dx, void* work, float* grads, int N,
                                 int S, int D, int F, int G, float scale,
                                 unsigned int seed, unsigned int keep24,
                                 float keep, int drop_on, void* stream) {
  return wd_recompute_bwd<false>(x, x_bf16, dout, params, /*stored=*/1, layer,
                                 dx, work, grads, N, S, D, F, G, scale, seed,
                                 keep24, keep, drop_on, stream);
}
