// K8 — backward of one full encoder layer (t < T-1) recomputed from its
// input, and K8s — the same for the slot-0 last layer: one kernel, templated
// on SLOT0 (recompute.cuh, shared with K10).
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_bwd1_kernel (entry
// _bwd1_call, driven layer by layer, last first, by _bwd_rule_hybrid).
// Contract: (the layer's input rows x [N*S, D] in bf16 or f32, its 12
// parameters, the output cotangent g, seed, layer) -> (dx [N*S, D] f32, the
// 12 weight gradients f32).  Products take operands in the rows' dtype and
// accumulate in f32, as the TPU kernel does.  Nothing of the forward is kept
// but x: each block recomputes its residuals and then back-propagates
// through them (recompute.cuh).
//
// Bound on the H100: operations.  At the two-pass training shapes (D <= 32,
// F = 1024) a row costs ~12*D*F product operations (the FFN recompute, its
// two weight-gradient products and the cotangent's) against ~12*D bytes of
// x, g and dx.  This version runs the products on the CUDA cores, one thread
// per row, with the FFN weights staged in shared memory chunk by chunk; the
// scratch round trip (~(7*D + S) floats a row) stays mostly in L2.  At S = 32,
// D = 32 shared memory allows one neighborhood (32 threads) a block.
// Tensor-core products and keeping the recomputed residuals in shared memory
// are later work.
#include "recompute.cuh"

extern "C" size_t gt_k8_smem_bytes(int G, int S, int D) {
  return gt_recompute_smem_bytes(G, S, D, false);
}

extern "C" size_t gt_k8s_smem_bytes(int G, int S, int D) {
  return gt_recompute_smem_bytes(G, S, D, true);
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
  return gt_dispatch_recompute<false>(x, x_bf16, dout, params, stored, layer,
                                      dx, qkv, attn, strip, partial, grads, N,
                                      S, D, F, G, scale, seed, keep24, keep,
                                      drop_on, stream);
}

// K8s.  dout [N, D]; scratch attn [N, S], strip [N, 4D+2]; the rest as K8
extern "C" int gt_k8s_slot0_bwd(const void* x, int x_bf16, const float* dout,
                                const float* const* params, int stored,
                                int layer, float* dx, float* qkv, float* attn,
                                float* strip, float* partial, float* grads,
                                int N, int S, int D, int F, int G, float scale,
                                unsigned int seed, unsigned int keep24,
                                float keep, int drop_on, void* stream) {
  return gt_dispatch_recompute<true>(x, x_bf16, dout, params, stored, layer,
                                     dx, qkv, attn, strip, partial, grads, N,
                                     S, D, F, G, scale, seed, keep24, keep,
                                     drop_on, stream);
}
