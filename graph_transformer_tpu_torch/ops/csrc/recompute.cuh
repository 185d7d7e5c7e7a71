// The recompute backward of one encoder layer, shared by K8/K8s
// (recompute_bwd.cu, a layer of the whole encoder's [T, ...] stack) and K10
// (encoder_layer.cu, one layer's own tensors): each block of G neighborhoods
// recomputes its rows' q/k/v, attention probabilities and LayerNorm strip
// with the forward's layer code (gt_fwd_layer, common.cuh), writing them to a
// scratch in device memory that only this block touches, then runs the
// backward body K2/K3 run on K1's stored residuals (gt_layer_bwd_body,
// layer_bwd.cuh), which replays the four dropout masks from the forward's
// counters (stream 4*layer+site).  Per-block partial weight gradients are
// summed in block order by gt_reduce_partials (no float atomics: runs repeat
// bit for bit).  Shared memory is the larger of the forward's and the
// backward's needs, and sets G.
#pragma once

#include "layer_bwd.cuh"

static inline size_t gt_recompute_smem_bytes(int G, int S, int D, bool slot0) {
  const size_t f = gt_fwd_smem_floats(G, S, D);
  const size_t b = gt_bwd_smem_floats(G, S, D, slot0);
  return sizeof(float) * (f > b ? f : b);
}

template <int DM, bool SLOT0>
__global__ void __launch_bounds__(128)
gt_recompute_bwd_kernel(const void* x, int x_bf16, const float* dout,
                        GtLayer w, GtDrop dr, int layer, float* dx, float* qkv,
                        float* attn, float* strip, float* partial, int N,
                        int S, int D, int F, int G, float scale) {
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
  // the residuals are the block's own rows; the body begins with a barrier,
  // after which every thread of the block sees them
  __threadfence_block();
  float* part = partial + (size_t)blockIdx.x * gt_grad_offsets(D, F).P;
  gt_layer_bwd_body<DM, SLOT0>(smem, x, x_bf16, qkv, attn, strip, dout, w, dr,
                               layer, dx, part, N, S, D, F, G, scale, x_bf16);
}

template <int DM, bool SLOT0>
static cudaError_t gt_launch_recompute(const void* x, int x_bf16,
                                       const float* dout, const GtLayer& w,
                                       const GtDrop& dr, int layer, float* dx,
                                       float* qkv, float* attn, float* strip,
                                       float* partial, float* grads, int N,
                                       int S, int D, int F, int G, float scale,
                                       cudaStream_t stream) {
  const size_t smem = gt_recompute_smem_bytes(G, S, D, SLOT0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gt_recompute_bwd_kernel<DM, SLOT0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = ((G * S + 31) / 32) * 32;
  const int blocks = (N + G - 1) / G;
  gt_recompute_bwd_kernel<DM, SLOT0><<<blocks, threads, smem, stream>>>(
      x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, N, S, D,
      F, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gt_reduce_partials(partial, blocks, gt_grad_offsets(D, F).P, grads,
                            stream);
}

// Layer `layer` of a stack of `stored` layers (slice layer % stored); its
// dropout streams are those of timestep `layer`.
template <bool SLOT0>
static int gt_dispatch_recompute(const void* x, int x_bf16, const float* dout,
                                 const float* const* params, int stored,
                                 int layer, float* dx, float* qkv, float* attn,
                                 float* strip, float* partial, float* grads,
                                 int N, int S, int D, int F, int G,
                                 float scale, unsigned int seed,
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
