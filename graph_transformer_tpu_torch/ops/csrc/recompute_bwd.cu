// K8 — backward of one full encoder layer (t < T-1) recomputed from its
// input, and K8s — the same for the slot-0 last layer: one kernel, templated
// on SLOT0.
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_bwd1_kernel (entry
// _bwd1_call, driven layer by layer, last first, by _bwd_rule_hybrid).
// Contract: (the layer's input rows x [N*S, D] in bf16 or f32, its 12
// parameters, the output cotangent g, seed, layer) -> (dx [N*S, D] f32, the
// 12 weight gradients f32).  Products take operands in the rows' dtype and
// accumulate in f32, as the TPU kernel does.  Nothing of the forward is kept
// but x: each block of G neighborhoods first recomputes its rows' q/k/v,
// attention probabilities and LayerNorm strip with the forward's layer code
// (gt_fwd_layer, common.cuh), writing them to a scratch in device memory
// that only this block touches, then runs the backward body K2/K3 run on
// K1's stored residuals (gt_layer_bwd_body, layer_bwd.cuh), which replays
// the four dropout masks from the forward's counters (stream 4*layer+site).
// Per-block partial weight gradients are summed in block order by
// gt_reduce_partials (no float atomics: runs repeat bit for bit).
//
// Bound on the H100: operations.  At the two-pass training shapes (D <= 32,
// F = 1024) a row costs ~12*D*F product operations (the FFN recompute, its
// two weight-gradient products and the cotangent's) against ~12*D bytes of
// x, g and dx.  This version runs the products on the CUDA cores, one thread
// per row, with the FFN weights staged in shared memory chunk by chunk; the
// scratch round trip (~(7*D + S) floats a row) stays mostly in L2.  Shared
// memory is the
// larger of the forward's and the backward's needs, and sets G: at S = 32,
// D = 32 one neighborhood (32 threads) a block.  Tensor-core products and
// keeping the recomputed residuals in shared memory are later work.
#include "layer_bwd.cuh"

static inline size_t k8_smem_bytes(int G, int S, int D, bool slot0) {
  const size_t f = gt_fwd_smem_floats(G, S, D);
  const size_t b = gt_bwd_smem_floats(G, S, D, slot0);
  return sizeof(float) * (f > b ? f : b);
}

extern "C" size_t gt_k8_smem_bytes(int G, int S, int D) {
  return k8_smem_bytes(G, S, D, false);
}

extern "C" size_t gt_k8s_smem_bytes(int G, int S, int D) {
  return k8_smem_bytes(G, S, D, true);
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
  GtLayerOut lo;
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
static cudaError_t launch_k8(const void* x, int x_bf16, const float* dout,
                             const GtLayer& w, const GtDrop& dr, int layer,
                             float* dx, float* qkv, float* attn, float* strip,
                             float* partial, float* grads, int N, int S, int D,
                             int F, int G, float scale, cudaStream_t stream) {
  const size_t smem = k8_smem_bytes(G, S, D, SLOT0);
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

template <bool SLOT0>
static int dispatch_k8(const void* x, int x_bf16, const float* dout,
                       const float* const* params, int stored, int layer,
                       float* dx, float* qkv, float* attn, float* strip,
                       float* partial, float* grads, int N, int S, int D,
                       int F, int G, float scale, unsigned int seed,
                       unsigned int keep24, float keep, int drop_on,
                       void* stream) {
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 4) return (int)launch_k8<4, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 8) return (int)launch_k8<8, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 16) return (int)launch_k8<16, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 32) return (int)launch_k8<32, SLOT0>(x, x_bf16, dout, w, dr, layer, dx, qkv, attn, strip, partial, grads, N, S, D, F, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K8.  x [N*S, D] (bf16 if x_bf16, else f32), dout [N*S, D] f32; scratch:
// qkv [N*S, 3D], attn [N*S, S], strip [N*S, 4D+2], partial [ceil(N/G), P];
// out: dx [N*S, D], grads [P] (KERNEL_ORDER, flattened)
extern "C" int gt_k8_layer_bwd(const void* x, int x_bf16, const float* dout,
                               const float* const* params, int stored,
                               int layer, float* dx, float* qkv, float* attn,
                               float* strip, float* partial, float* grads,
                               int N, int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return dispatch_k8<false>(x, x_bf16, dout, params, stored, layer, dx, qkv,
                            attn, strip, partial, grads, N, S, D, F, G, scale,
                            seed, keep24, keep, drop_on, stream);
}

// K8s.  dout [N, D]; scratch attn [N, S], strip [N, 4D+2]; the rest as K8
extern "C" int gt_k8s_slot0_bwd(const void* x, int x_bf16, const float* dout,
                                const float* const* params, int stored,
                                int layer, float* dx, float* qkv, float* attn,
                                float* strip, float* partial, float* grads,
                                int N, int S, int D, int F, int G, float scale,
                                unsigned int seed, unsigned int keep24,
                                float keep, int drop_on, void* stream) {
  return dispatch_k8<true>(x, x_bf16, dout, params, stored, layer, dx, qkv,
                           attn, strip, partial, grads, N, S, D, F, G, scale,
                           seed, keep24, keep, drop_on, stream);
}
