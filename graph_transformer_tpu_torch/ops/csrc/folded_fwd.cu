// K15 — the folded forward with residuals, and K16 — the same forward
// without them: K1's layer loop (common.cuh) reading given rows instead of
// sampling them.
//
// K15 replaces graph_transformer_tpu/ops/pallas_folded.py:
// _folded_stored_fwd_kernel (entry folded_u2gnn_encoder_grad's forward rule)
// and K16 pallas_folded.py:_folded_kernel (entry folded_u2gnn_encoder).
// Both take rows x [N*S, D] in bf16, run T post-norm encoder layers with
// bf16 product operands and the dropout of the seed (the last layer for
// slot 0 only) and write out [N, D] f32.  K15 also writes what K2/K3 read,
// in K1's layout (the TPU kernel's folded [G, S*D] lanes are a TPU device
// and are not carried over): the layer inputs [T, N*S, D] bf16 (layer 0's
// is x), q/k/v, the attention probabilities and the LayerNorm strip
// [ctx, y1, uhat1, uhat2, rstd1, rstd2].  Fed K1's own x0 rows and seed, K15
// gives K1's output and residuals bit for bit: the layer code, the counters
// and the block layout are K1's.
//
// Bound on the H100 at the A/B workload (79,488 rows, S=9, D=4, F=1024,
// T=4): K15's ~45 MB of rows, weights and residual writes bound it (~14 us
// at 3.35 TB/s) against ~4 GFLOP of bf16 products (~4 us at 989 TFLOP/s);
// K16 reads ~0.8 MB and writes its 0.14 MB output, so the products bound
// it.  Both run K1's layer (the FFN on the tensor cores), bound at those
// rows by the hidden's dropout words, as K1 is.
#include "common.cuh"

extern "C" size_t gt_k15_smem_bytes(int G, int S, int D) {
  return gt_fwd_smem_bytes(G, S, D);
}

// K15.  x_rows [N*S, D] bf16; out [N, D]; xs [T, N*S, D] bf16; qkv
// [T, N*S, 3D]; attn_full [T-1, N*S, S] and strip_full [T-1, N*S, 4D+2]
// (null when T == 1); attn_last [N, S]; strip_last [N, 4D+2]
extern "C" int gt_k15_folded_stored_fwd(
    const void* x_rows, const float* const* params, int stored, float* out,
    void* xs, float* qkv, float* attn_full, float* attn_last,
    float* strip_full, float* strip_last, int N, int S, int D, int F, int T,
    int G, float scale, const long long* seed, unsigned int keep24, float keep,
    int drop_on, void* stream) {
  GtFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = 1;
  io.out = out;
  io.xs = xs;
  io.xs_bf16 = 1;
  io.xs_first = 0;
  io.qkv = qkv;
  io.attn_full = attn_full;
  io.attn_last = attn_last;
  io.strip_full = strip_full;
  io.strip_last = strip_last;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)gt_dispatch_fwd(io, gt_make_stack(params, stored), dr, N, S, D,
                              F, T, G, scale, /*mmbf=*/1, /*sampled=*/0,
                              (cudaStream_t)stream);
}

// K16.  x_rows [N*S, D] bf16; out [N, D]
extern "C" int gt_k16_folded_fwd(const void* x_rows,
                                 const float* const* params, int stored,
                                 float* out, int N, int S, int D, int F, int T,
                                 int G, float scale, const long long* seed,
                                 unsigned int keep24, float keep, int drop_on,
                                 void* stream) {
  GtFwdIO io = {};
  io.x_rows = x_rows;
  io.x_bf16 = 1;
  io.out = out;
  GtDrop dr{seed, keep24, keep, drop_on};
  return (int)gt_dispatch_fwd(io, gt_make_stack(params, stored), dr, N, S, D,
                              F, T, G, scale, /*mmbf=*/1, /*sampled=*/0,
                              (cudaStream_t)stream);
}
