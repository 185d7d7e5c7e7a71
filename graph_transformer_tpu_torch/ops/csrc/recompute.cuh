// The recompute backward of one encoder layer, shared by K8/K8s
// (recompute_bwd.cu, a layer of the whole encoder's [T, ...] stack) and K10
// (encoder_layer.cu, one layer's own tensors), in two launches:
//   1. the layer's forward again (gt_recompute_fwd_kernel), with the
//      forward kernels' layer code (gt_fwd_layer, common.cuh), writing q/k/v,
//      the attention probabilities and the LayerNorm strip to scratch.  Its
//      FFN runs on the tensor cores over all the block's warps (gt_ffn_tc),
//      whose sums do not depend on G, so it recomputes bit for bit the
//      forward that K4t ran and saved the layer inputs of;
//   2. the backward body K2/K3 run on K1's stored residuals
//      (gt_layer_bwd_kernel, layer_bwd.cuh), which replays the four dropout
//      masks from the forward's counters (stream 4*layer+site), and the
//      partial weight gradients summed in block order by gt_reduce_partials
//      (no float atomics: runs repeat bit for bit).
// One launch holding both halves ran the forward at the body's shared memory
// and registers (~113 KB at S=9, D=4, G=14: 2 blocks an SM) and cost more
// than the two apart (PERF.md, PR 8); apart, each takes what it needs.  Both
// launches take the same G; K14 (mega_bwd.cu) runs both halves in one launch
// at that G and repeats this chain bit for bit.
#pragma once

#include "layer_bwd.cuh"

// shared memory of a block of the pair: the larger of the two launches'
static inline size_t gt_recompute_smem_bytes(int G, int S, int D, bool slot0) {
  const size_t f = gt_fwd_smem_bytes(G, S, D);
  const size_t b = sizeof(float) * gt_bwd_smem_floats(G, S, D, slot0);
  return f > b ? f : b;
}

template <int DM, bool SLOT0>
__global__ void __launch_bounds__(GT_BWD_THREADS, GT_FWD_MIN_BLOCKS(DM))
gt_recompute_fwd_kernel(const void* x, int x_bf16, GtLayer w, GtDrop dr,
                        int layer, float* qkv, float* attn, float* strip,
                        int N, int S, int D, int F, int G, float scale) {
  gt_read_seed(dr);
  extern __shared__ float smem[];
  const int r = threadIdx.x;
  const int g = r / S;
  const int i = r - g * S;
  const int n = blockIdx.x * G + g;
  const bool valid = (r < G * S) && (n < N);
  float xr[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) xr[d] = 0.f;
  if (valid) gt_load_row<DM>(x, x_bf16, (size_t)n * S + i, D, xr);
  GtLayerOut lo = {};
  lo.qkv = qkv;
  lo.attn = attn;
  lo.strip = strip;
  lo.out = nullptr;
  gt_fwd_layer<DM>(smem, w, dr, layer, SLOT0, lo, xr, N, S, D, F, G, scale,
                   x_bf16);
}

template <int DM, bool SLOT0>
static cudaError_t gt_launch_recompute(const void* x, int x_bf16,
                                       const float* dout, const GtLayer& w,
                                       const GtDrop& dr, int layer, float* dx,
                                       float* qkv, float* attn, float* strip,
                                       float* partial, float* grads, int N,
                                       int S, int D, int F, int G, float scale,
                                       cudaStream_t stream) {
  if (G < 1 || G * S > GT_BWD_THREADS) return cudaErrorInvalidValue;
  const size_t smem = gt_fwd_smem_bytes(G, S, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gt_recompute_fwd_kernel<DM, SLOT0>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + G - 1) / G;
  gt_recompute_fwd_kernel<DM, SLOT0><<<blocks, GT_BWD_THREADS, smem, stream>>>(
      x, x_bf16, w, dr, layer, qkv, attn, strip, N, S, D, F, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gt_launch_layer_bwd<DM, SLOT0>(x, x_bf16, qkv, attn, strip, dout, w,
                                        dr, layer, dx, partial, grads, N, S, D,
                                        F, G, scale, stream);
}

// Layer `layer` of a stack of `stored` layers (slice layer % stored); its
// dropout streams are those of timestep `layer`.
template <bool SLOT0>
static int gt_dispatch_recompute(const void* x, int x_bf16, const float* dout,
                                 const float* const* params, int stored,
                                 int layer, float* dx, float* qkv, float* attn,
                                 float* strip, float* partial, float* grads,
                                 int N, int S, int D, int F, int G,
                                 float scale, const long long* seed,
                                 unsigned int keep24, float keep, int drop_on,
                                 void* stream) {
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 4) return (int)gt_launch_recompute<4, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 8) return (int)gt_launch_recompute<8, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 16) return (int)gt_launch_recompute<16, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 32) return (int)gt_launch_recompute<32, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  return (int)cudaErrorInvalidValue;
}
