// K8 — backward of one full encoder layer (t < T-1) recomputed from its
// input, and K8s — the same for the slot-0 last layer: a forward launch and
// the backward body, templated on SLOT0 (recompute.cuh, shared with K10);
// K8w and K8ws — the same for rows of 32 < D <= 128, a warp per row
// (wide_recompute.cuh, shared with K10w).
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_bwd1_kernel (entry
// _bwd1_call, driven layer by layer, last first, by _bwd_rule_hybrid).
// Contract: (the layer's input rows x [N*S, D] in bf16 or f32, its 12
// parameters, the output cotangent g, seed, layer) -> (dx [N*S, D] f32, the
// 12 weight gradients f32).  Products take operands in the rows' dtype and
// accumulate in f32, as the TPU kernel does.  Nothing of the forward is kept
// but x: a forward launch recomputes the layer's residuals and the backward
// body (K2's) back-propagates through them (recompute.cuh).
//
// Bound on the H100: operations.  At the two-pass training shapes (D <= 32,
// F = 1024) a row costs ~12*D*F product operations (the FFN recompute, its
// two weight-gradient products and the cotangent's) against ~12*D bytes of
// x, g and dx.  The body's FFN products run on the tensor cores over every
// warp of a block (layer_bwd.cuh), the forward's too (recompute.cuh), the row-wise work a thread per row; the scratch round
// trip (~(7*D + S) floats a row) stays mostly in L2.  Blocks hold few
// enough neighborhoods that a launch has >= 264 of them where N allows (the
// HPO arm's 512 neighborhoods: 2 a block).
//
// K8w/K8ws: each block of G neighborhoods (<= 32 rows) recomputes its layer
// with the wide forward row code (wd_fwd_layer, the layer of K5/K4w/K4tw),
// writing q/k/v, the probabilities, the strip and the FFN hidden to a
// block-private scratch, then runs K6's backward body on them and K6's
// split-K weight products; float32 rows keep the hidden, the per-row
// factors and every product operand in float32, as the TPU kernel keeps
// them (pallas_u2gnn.py:331-339).  Bound on the H100 at the quickstart's
// shapes (N=640, S=9, D=68, F=1024, float32): ~10*D*F product operations a
// row against ~12*D bytes of x, g and dx, so the operations (~0.08 ms at
// 67 TFLOP/s); the [rows, F] hidden and its cotangent round-trip device
// memory (~47 MB at 5,760 float32 rows).  The row kernel's eight products
// (q/k/v, w_out, w1, w2 and their transposes) run on the tensor cores
// (WdMmaGemm, wide_mma.cuh: mma.sync, 3xTF32 for float32 rows, bf16 for
// bf16 ones, the weights staged by cp.async); on the CUDA cores they had
// been bound by shared-memory loads at ~1 FMA each.  The split-K weight
// products run on the tensor cores too (wd_products, wide_mma.cuh, shared
// with K6, K12, K14w).
#include "recompute.cuh"
#include "wide_recompute.cuh"

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

extern "C" size_t gt_k8w_smem_bytes(int G, int S, int D) {
  return wd_recompute_mma_smem_bytes(G, S, D, false);
}

extern "C" size_t gt_k8ws_smem_bytes(int G, int S, int D) {
  return wd_recompute_mma_smem_bytes(G, S, D, true);
}

// scratch of K8w (slot0 0) or K8ws (slot0 1) for rows in bf16 (x_bf16) or
// f32
extern "C" size_t gt_k8w_work_bytes(int N, int S, int D, int F, int G,
                                    int slot0, int x_bf16) {
  WdBwdWork w;
  return wd_bwd_work(N, S, D, F, G, slot0 != 0, x_bf16, true, nullptr, &w);
}

// K8w.  x [N*S, D] (bf16 if x_bf16, else f32), dout [N*S, D] f32; work:
// gt_k8w_work_bytes(..., 0, x_bf16) bytes; out: dx [N*S, D] f32, grads [P]
extern "C" int gt_k8w_layer_bwd(const void* x, int x_bf16, const float* dout,
                                const float* const* params, int stored,
                                int layer, float* dx, void* work,
                                float* grads, int N, int S, int D, int F,
                                int G, float scale, unsigned int seed,
                                unsigned int keep24, float keep, int drop_on,
                                void* stream) {
  return wd_recompute_bwd<false>(x, x_bf16, dout, params, stored, layer, dx,
                                 work, grads, N, S, D, F, G, scale, seed,
                                 keep24, keep, drop_on, stream);
}

// K8ws.  dout [N, D]; work: gt_k8w_work_bytes(..., 1, x_bf16) bytes; the
// rest as K8w
extern "C" int gt_k8ws_slot0_bwd(const void* x, int x_bf16, const float* dout,
                                 const float* const* params, int stored,
                                 int layer, float* dx, void* work,
                                 float* grads, int N, int S, int D, int F,
                                 int G, float scale, unsigned int seed,
                                 unsigned int keep24, float keep, int drop_on,
                                 void* stream) {
  return wd_recompute_bwd<true>(x, x_bf16, dout, params, stored, layer, dx,
                                work, grads, N, S, D, F, G, scale, seed,
                                keep24, keep, drop_on, stream);
}
