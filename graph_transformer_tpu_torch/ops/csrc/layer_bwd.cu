// K2 — backward of one full encoder layer (t < T-1) from K1's residuals, and
// K3 — backward of the slot-0 last layer: one kernel, templated on SLOT0.
//
// Replaces graph_transformer_tpu/ops/pallas_folded.py:_folded_bwd_kernel
// (K2: _folded_bwd1_call, grads summed by _reduce_folded_grads) and
// _folded_bwd0_kernel (K3: _folded_bwd0_call, grads summed by
// _reduce_slot0_grads), from the residuals K1 stores: the layer's input rows
// (bf16), q/k/v, the attention probabilities and the LayerNorm strip.  The
// body (layer_bwd.cuh) is shared with K8, which recomputes those residuals.
// Blocks run in any order: each writes its partial weight gradients to its
// own row of a [blocks, P] buffer and a second pass sums the rows in block
// order (no float atomics, so runs repeat bit for bit).
//
// Bound on the H100 at the bench shapes: K2 reads ~13 MB of residuals and its
// FFN recompute plus gradients are ~3.3 GFLOP of bf16 products; K3 reads ~4
// MB for ~0.4 GFLOP.  The bytes bound both (a few us).  The body runs its
// FFN products on the tensor cores (layer_bwd.cuh) and writes one partial
// row per block (~22 MB at bench shapes), which the second pass reads back.
#include "layer_bwd.cuh"

extern "C" size_t gt_k2_smem_bytes(int G, int S, int D) {
  return sizeof(float) * gt_bwd_smem_floats(G, S, D, false);
}

extern "C" size_t gt_k3_smem_bytes(int G, int S, int D) {
  return sizeof(float) * gt_bwd_smem_floats(G, S, D, true);
}

template <bool SLOT0>
static int dispatch_bwd(const void* xs, const float* qkv, const float* attn,
                        const float* strip, const float* dout,
                        const float* const* params, int stored, int layer,
                        float* dx, float* partial, float* grads, int N, int S,
                        int D, int F, int G, float scale, unsigned int seed,
                        unsigned int keep24, float keep, int drop_on,
                        void* stream) {
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 4) return (int)gt_launch_layer_bwd<4, SLOT0>(xs, 1, qkv, attn, strip, dout, w, dr, layer, dx, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 8) return (int)gt_launch_layer_bwd<8, SLOT0>(xs, 1, qkv, attn, strip, dout, w, dr, layer, dx, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 16) return (int)gt_launch_layer_bwd<16, SLOT0>(xs, 1, qkv, attn, strip, dout, w, dr, layer, dx, partial, grads, N, S, D, F, G, scale, s);
  if (D <= 32) return (int)gt_launch_layer_bwd<32, SLOT0>(xs, 1, qkv, attn, strip, dout, w, dr, layer, dx, partial, grads, N, S, D, F, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K2.  attn [N*S, S], strip [N*S, 4D+2], dout [N*S, D];
// partial: [ceil(N/G), P] scratch; grads: [P] (KERNEL_ORDER, flattened)
extern "C" int gt_k2_layer_bwd(const void* xs, const float* qkv,
                               const float* attn, const float* strip,
                               const float* dout, const float* const* params,
                               int stored, int layer, float* dx,
                               float* partial, float* grads, int N, int S,
                               int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return dispatch_bwd<false>(xs, qkv, attn, strip, dout, params, stored, layer,
                             dx, partial, grads, N, S, D, F, G, scale, seed,
                             keep24, keep, drop_on, stream);
}

// K3.  attn0 [N, S], strip0 [N, 4D+2], dout [N, D]; the rest as K2
extern "C" int gt_k3_slot0_bwd(const void* xs, const float* qkv,
                               const float* attn0, const float* strip0,
                               const float* dout, const float* const* params,
                               int stored, int layer, float* dx,
                               float* partial, float* grads, int N, int S,
                               int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return dispatch_bwd<true>(xs, qkv, attn0, strip0, dout, params, stored,
                            layer, dx, partial, grads, N, S, D, F, G, scale,
                            seed, keep24, keep, drop_on, stream);
}
