// K6 — backward of one wide-row encoder layer from K5's residuals: one
// kernel templated on SLOT0 (the slot-0 last layer), two entry points.  The
// row body, the split-K weight products and their partial sums live in
// wide_recompute.cuh and wide_mma.cuh, shared with the wide recompute
// backward (K8w).
//
// Replaces graph_transformer_tpu/ops/pallas_stored_bwd.py:_stored_bwd1_kernel
// (entry _stored_bwd1_call, slot0 flag; walked by _stored_bwd_core).  Inputs:
// the layer's input rows, q/k/v, the attention probabilities, the LayerNorm
// strip, the FFN hidden h (rows and h in bf16 from K5, in the rows' dtype
// from K17; products in that dtype) and the output cotangent; in the
// last layer only slot 0 of a neighborhood is a query row, while its keys and
// values span all S slots.  The relu' times dropout factor of the hidden is
// (h > 0) / keep, exact from h alone; the other three dropout masks replay
// from the forward's counters.  Outputs: dx [N*S, D] and the 12 weight
// gradients.
//
// Bound at N=4096, S=9, D=65, F=1024, from the H100 SXM data sheet's rates
// (3.35 TB/s, 989 TFLOP/s bf16): a full layer reads its 75 MB hidden and
// ~15 MB of other residuals for ~27 GFLOP of bf16 products, so the bytes
// bound it (~0.03 ms).  The row kernel runs its eight products on the
// tensor cores (WdMmaGemm: bf16 m16n8k16 for bf16 rows, 3xTF32 for K17's
// float32 ones, the routine of K8w), two blocks an SM; the four weight
// products then run in one launch of the pipelined split-K kernel
// (wd_products) and one reduction.  This version still writes and reads
// back the dhpre [Q, F] (2 x 11.8 MB at the quickstart's bf16 rows).
#include "wide_recompute.cuh"

// the body's shared memory, then the tensor-core products' staging region
// at the next 16-byte boundary
__host__ __device__ inline size_t wd_k6_stage_offset(int G, int S, int D,
                                                     bool slot0) {
  return (wd_bwd_smem_floats(G, S, D, slot0) + 3) / 4 * 4;
}

static inline size_t wd_k6_smem_bytes(int G, int S, int D, bool slot0) {
  return sizeof(float) *
         (wd_k6_stage_offset(G, S, D, slot0) + WM_STAGE_FLOATS);
}

extern "C" size_t gt_k6_smem_bytes(int G, int S, int D) {
  return wd_k6_smem_bytes(G, S, D, false);
}

extern "C" size_t gt_k6s_smem_bytes(int G, int S, int D) {
  return wd_k6_smem_bytes(G, S, D, true);
}

template <bool SLOT0>
__global__ void __launch_bounds__(WD_THREADS, 2)
wd_stored_bwd_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ attn,
                     const float* __restrict__ strip,
                     const void* __restrict__ h,
                     const float* __restrict__ dout, GtLayer w, GtDrop dr,
                     int layer, float* dx, WdBwdWork wk, int N, int S, int D,
                     int F, int G, float scale, int bf) {
  extern __shared__ float smem[];
  const WdMmaGemm mma{smem + wd_k6_stage_offset(G, S, D, SLOT0)};
  wd_bwd_body<SLOT0>(smem, qkv, attn, strip, h, dout, w, dr, layer, dx, wk, N,
                     S, D, F, G, scale, bf, mma);
}

// scratch of a full layer (slot0 0) or the slot-0 layer, for rows and
// hidden in bf16 (x_bf16) or f32
extern "C" size_t gt_k6_work_bytes(int N, int S, int D, int F, int G,
                                   int slot0, int x_bf16) {
  WdBwdWork w;
  return wd_bwd_work(N, S, D, F, G, slot0 != 0, x_bf16, false, nullptr, &w);
}

template <bool SLOT0>
static int wd_bwd(const void* xs, int x_bf16, const float* qkv,
                  const float* attn, const float* strip, const void* h,
                  const float* dout,
                  const float* const* params, int stored, int layer, float* dx,
                  void* work, float* grads, int N, int S, int D, int F, int G,
                  float scale, unsigned int seed, unsigned int keep24,
                  float keep, int drop_on, void* stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32)
    return (int)cudaErrorInvalidValue;
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  const GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  WdBwdWork wk;
  wd_bwd_work(N, S, D, F, G, SLOT0, x_bf16, false, (char*)work, &wk);
  const size_t smem = wd_k6_smem_bytes(G, S, D, SLOT0);
  cudaError_t e = cudaFuncSetAttribute(
      wd_stored_bwd_kernel<SLOT0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + G - 1) / G;
  wd_stored_bwd_kernel<SLOT0><<<blocks, WD_THREADS, smem, s>>>(
      qkv, attn, strip, h, dout, w, dr, layer, dx, wk, N, S, D, F, G, scale,
      x_bf16);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)wd_bwd_products(xs, strip, h, wk, grads, N, S, D, F, G, SLOT0,
                              x_bf16, s);
}

// K6, a full layer.  xs [N*S, D] and h [N*S, F] in bf16 (x_bf16: K5's,
// K17's bf16 rows) or f32 (K17's float32 rows), products in that dtype;
// attn [N*S, S], strip [N*S, 4D+2], dout [N*S, D]; work:
// gt_k6_work_bytes(..., 0, x_bf16) bytes of scratch; grads: [P]
// (KERNEL_ORDER, flattened)
extern "C" int gt_k6_layer_bwd(const void* xs, int x_bf16, const float* qkv,
                               const float* attn, const float* strip,
                               const void* h, const float* dout,
                               const float* const* params, int stored,
                               int layer, float* dx, void* work, float* grads,
                               int N, int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return wd_bwd<false>(xs, x_bf16, qkv, attn, strip, h, dout, params, stored,
                       layer, dx, work, grads, N, S, D, F, G, scale, seed,
                       keep24, keep, drop_on, stream);
}

// K6, the slot-0 last layer.  attn0 [N, S], strip0 [N, 4D+2], h0 [N, F],
// dout [N, D]; work: gt_k6_work_bytes(..., 1, x_bf16) bytes; the rest as
// above
extern "C" int gt_k6_slot0_bwd(const void* xs, int x_bf16, const float* qkv,
                               const float* attn0, const float* strip0,
                               const void* h0, const float* dout,
                               const float* const* params, int stored,
                               int layer, float* dx, void* work, float* grads,
                               int N, int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return wd_bwd<true>(xs, x_bf16, qkv, attn0, strip0, h0, dout, params,
                      stored, layer, dx, work, grads, N, S, D, F, G, scale,
                      seed, keep24, keep, drop_on, stream);
}
