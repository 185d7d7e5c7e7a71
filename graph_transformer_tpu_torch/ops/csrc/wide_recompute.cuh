// The backward of one wide-row encoder layer (a warp per row, D <= 128),
// shared by K6 (stored_bwd.cu: residuals stored by K5's forward) and
// K8w/K8ws/K10w (recompute_bwd.cu, encoder_layer.cu: residuals recomputed by
// the same block from the layer's input).
//
// The body (wd_bwd_body) reads the layer's q/k/v, attention probabilities,
// LayerNorm strip and FFN hidden after its dropout, h, and the output
// cotangent; in the last layer (SLOT0) only slot 0 of a neighborhood is a
// query row, while its keys and values span all S slots.  The relu' times
// dropout factor of the hidden is (h > 0) / keep, exact from h alone; the
// other three dropout masks replay from the forward's counters (stream
// 4*layer+site).  Product operands take the compute dtype (bf: bf16, else
// f32, as the TPU kernels keep float32 rows in float32) and accumulate in
// f32; h and the four per-row factors below are stored in that dtype.
//
// The TPU kernels carry their weight gradients across the sequential grid.
// Blocks here run in any order, and a per-block partial of all 12 gradients
// is 4*(4D^2 + 2DF) bytes (~0.6 MB at D=65, F=1024), too large to write for
// every 27-row block.  So:
//   1. the row kernel (a block per G neighborhoods) computes dx and writes
//      the per-row factors of the four weight products (dqkv, da, dhpre, dz:
//      exactly the rounded operands the products take), plus per-block
//      partial sums of the eight bias and LayerNorm gradients;
//   2. the four weight products (x^T dqkv, ctx^T da, y1^T dhpre, h^T dz) run
//      in one launch as split-K products over the rows, each split writing
//      its own partial tile (wd_products, wide_mma.cuh: a cp.async ring on
//      the tensor cores);
//   3. a second launch sums the partials in split order and the small
//      partials in block order.
// No float atomics, so runs repeat bit for bit.
//
// The recompute kernel (wd_recompute_bwd_kernel: K8w, K8ws, K10w; replaces
// pallas_u2gnn.py:_bwd1_kernel and pallas_encoder.py:_bwd_kernel past D=32)
// first runs the forward layer (wd_fwd_layer) over its block's rows,
// writing q/k/v, the probabilities, the strip and h to a scratch in device
// memory that only this block touches (they do not fit in shared memory
// beside the backward's buffers: ~131 KB for the forward and ~160 KB for
// the backward at D=128, 32 rows), then the body.  Its bound is the
// operations (~10*D*F a row; 0.08 ms at the quickstart's 5,760 float32
// rows at 67 TFLOP/s).  On the CUDA cores its eight products were bound by
// shared-memory loads (a thread per column and 8-row tile, one load a
// FMA, ~4 TFLOP/s); this kernel runs them on the tensor cores instead
// (WdMmaGemm, wide_mma.cuh), through the product template parameter of
// wd_fwd_layer and wd_bwd_body; K14w (mega_bwd.cu) takes the same routine,
// so that it repeats this kernel bit for bit, and K6 (stored_bwd.cu) runs
// the body on it too.  The forward kernels keep wd_gemm for float32 rows.
#pragma once

#include "wide.cuh"
#include "wide_mma.cuh"

// floats of shared memory: per query row dz/da, dy1/du1, dctx (3 x [QP, D]),
// the probabilities, their dropped copies and ds (3 x [QP, S]), and one
// region used in turn by the hidden chunk (2 x [QP, WD_FC]), by q/k/v and
// dqkv ([MP, LQ + 3D]) and by the per-warp column sums ([8, 6, D])
__host__ __device__ inline size_t wd_bwd_smem_floats(int G, int S, int D, bool slot0) {
  const size_t MP = (size_t)wd_pad(G * S);
  const size_t QP = (size_t)wd_pad(slot0 ? G : G * S);
  size_t U = 2 * QP * WD_FC;
  const size_t att = MP * (wd_ldq(D) + 3 * (size_t)D);
  if (att > U) U = att;
  const size_t red = (WD_THREADS / 32) * 6 * (size_t)D;
  if (red > U) U = red;
  return 3 * QP * D + 3 * QP * S + U;
}

__host__ __device__ inline size_t wd_recompute_smem_bytes(int G, int S, int D,
                                             bool slot0) {
  const size_t f = wd_fwd_smem_bytes(G, S, D);
  const size_t b = sizeof(float) * wd_bwd_smem_floats(G, S, D, slot0);
  return f > b ? f : b;
}

// The recompute kernel's: the forward's and the body's shared memory, then
// the tensor-core products' staging region at the next 16-byte boundary.
__host__ __device__ inline size_t wd_mma_stage_offset(int G, int S, int D, bool slot0) {
  return (wd_recompute_smem_bytes(G, S, D, slot0) / sizeof(float) + 3) / 4 * 4;
}

static inline size_t wd_recompute_mma_smem_bytes(int G, int S, int D,
                                                 bool slot0) {
  return sizeof(float) *
         (wd_mma_stage_offset(G, S, D, slot0) + WM_STAGE_FLOATS);
}

// Device memory of one backward: the four per-row factors (in the compute
// dtype), the small partials, the split-K partial tiles and, for the
// recompute kernels, the recomputed residuals.
struct WdBwdWork {
  void *dqkv, *da, *dh, *dz;
  float *small, *split;
  float *qkv, *attn, *strip;  // recompute only: [N*S, 3D], [Q, S], [Q, 4D+2]
  void* h;                    // recompute only: [Q, F]
};

// The four weight products of one layer's backward: dW_in = x^T dqkv over
// all rows, dW_out = ctx^T da, dW1 = y1^T dhpre and dW2 = h^T dz over the
// query rows.  xs: the layer input [N*S, D] and h [Q, F], both in the
// compute dtype; strip [Q, 4D+2] f32; grads null for the sizes alone.
static void wd_bwd_specs(const void* xs, const float* strip, const void* h,
                         const WdBwdWork& wk, float* grads, int N, int S,
                         int D, int F, bool slot0, int bf,
                         WdProductSpec (&ps)[4]) {
  const GtGradOff o = gt_grad_offsets(D, F);
  const int NS = N * S, Q = slot0 ? N : N * S, SW = 4 * D + 2, ex = !bf;
  auto at = [&](int off) { return grads ? grads + off : nullptr; };
  ps[0] = {{xs, bf, D, 0, ex}, {wk.dqkv, bf, 3 * D, 0, 1}, NS, D, 3 * D,
           at(o.w_in)};
  ps[1] = {{strip, 0, SW, 0, ex}, {wk.da, bf, D, 0, 1}, Q, D, D, at(o.w_out)};
  ps[2] = {{strip, 0, SW, D, ex}, {wk.dh, bf, F, 0, 1}, Q, D, F, at(o.w1)};
  ps[3] = {{h, bf, F, 0, 1}, {wk.dz, bf, D, 0, 1}, Q, F, D, at(o.w2)};
}

static size_t wd_bwd_work(int N, int S, int D, int F, int G, bool slot0,
                          int bf, bool recompute, char* base, WdBwdWork* w) {
  const size_t NS = (size_t)N * S;
  const size_t Q = slot0 ? (size_t)N : NS;
  const size_t es = bf ? 2 : 4;
  const size_t blocks = (size_t)(N + G - 1) / G;
  WdProductSpec ps[4];
  wd_bwd_specs(nullptr, nullptr, nullptr, WdBwdWork{}, nullptr, N, S, D, F,
               slot0, bf, ps);
  const size_t split = wd_products_split_floats(ps, 4);
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  w->dqkv = take(NS * 3 * D * es);
  w->da = take(Q * D * es);
  w->dh = take(Q * F * es);
  w->dz = take(Q * D * es);
  w->small = (float*)take(blocks * wd_small_width(D, F) * 4);
  w->split = (float*)take(split * 4);
  w->qkv = w->attn = w->strip = nullptr;
  w->h = nullptr;
  if (recompute) {
    w->qkv = (float*)take(NS * 3 * D * 4);
    w->attn = (float*)take(Q * S * 4);
    w->strip = (float*)take(Q * (4 * D + 2) * 4);
    w->h = take(Q * F * es);
  }
  return off;
}

// The row part of the backward for the block's G neighborhoods.  qkv [N*S,
// 3D], attn [Q, S], strip [Q, 4D+2], h [Q, F] (bf16 if bf, else f32), dout
// [Q, D] with Q = N (SLOT0) or N*S.  Writes dx [N*S, D], the four factors
// and the block's small partials.  Begins with a barrier; reads the
// residuals through plain pointers, since the recompute kernel writes them
// in the same launch.  Its products go through `gemm` (wd_gemm's contract).
template <bool SLOT0, class Gemm = WdCoreGemm>
__device__ __forceinline__ void wd_bwd_body(
    float* smem, const float* qkv, const float* attn, const float* strip,
    const void* h, const float* dout, const GtLayer& w, const GtDrop& dr,
    int layer, float* dx, const WdBwdWork& wk, int N, int S, int D, int F,
    int G, float scale, int bf, const Gemm& gemm = Gemm()) {
  const int MP = wd_pad(G * S);
  const int QP = wd_pad(SLOT0 ? G : G * S);
  const int D3 = 3 * D, LQ = wd_ldq(D), SW = 4 * D + 2, FC = WD_FC;
  float* sDZ = smem;             // [QP, D] rounded dz, later rounded da
  float* sDY1 = sDZ + QP * D;    // [QP, D] du2, then dy1, then du1
  float* sDCTX = sDY1 + QP * D;  // [QP, D] rounded dctx
  float* sA = sDCTX + QP * D;    // [QP, S] probabilities
  float* sAD = sA + QP * S;      // [QP, S] rounded dropped probabilities
  float* sDS = sAD + QP * S;     // [QP, S] rounded ds
  float* sU = sDS + QP * S;
  float* sDH = sU;               // [QP, FC] rounded dhpre chunk
  float* sDHf = sU + QP * FC;    // [QP, FC] dhpre chunk
  float* sQKV = sU;              // [MP, LQ] rounded q/k/v
  float* sDQKV = sU + MP * LQ;   // [MP, 3D] dq/dk/dv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n0 = blockIdx.x * G;
  const int Gv = min(G, N - n0);
  const int Rv = Gv * S;
  const int QR = SLOT0 ? Gv : Rv;
  const size_t row0 = (size_t)n0 * S;
  const size_t q0 = SLOT0 ? (size_t)n0 : row0;  // first query row's index
  float* part = wk.small + (size_t)blockIdx.x * wd_small_width(D, F);
  const uint32_t kA = gt_stream_key(dr.seed, 4 * layer + 0);
  const uint32_t kO = gt_stream_key(dr.seed, 4 * layer + 1);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  const float ikeep = dr.on ? 1.f / dr.keep : 1.f;

  // this warp's column sums of b_out, g1, c1, b2, g2, c2 (lane's columns)
  float cs[6][WD_CPL];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) cs[k][m] = 0.f;

  __syncthreads();  // shared memory's earlier users are done
  // ---- 1. LayerNorm 2 backward, then the FFN-output dropout
  for (int q = warp; q < QR; q += nw) {
    const size_t qi = q0 + q;
    const float* st = strip + qi * SW;
    float gv[WD_CPL], uh[WD_CPL];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      gv[m] = uh[m] = 0.f;
      if (d < D) {
        gv[m] = dout[qi * D + d];
        uh[m] = st[3 * D + d];
        const float gg = gv[m] * w.g2[d];
        m1 += gg;
        m2 += gg * uh[m];
      }
    }
    m1 = wd_warp_sum(m1) / (float)D;
    m2 = wd_warp_sum(m2) / (float)D;
    const float rs2 = st[4 * D + 1];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float du2 = (gv[m] * w.g2[d] - m1 - uh[m] * m2) * rs2;
        const float dz = gt_drop(dr, kZ, (uint32_t)qi * D + d, du2);
        sDY1[q * D + d] = du2;
        sDZ[q * D + d] = gt_rn(dz, bf);
        wd_store(wk.dz, qi * D + d, dz, bf);
        cs[3][m] += dz;
        cs[4][m] += gv[m] * uh[m];
        cs[5][m] += gv[m];
      }
    }
  }

  // ---- 2. FFN backward, WD_FC hidden columns at a time:
  // dhpre = (dz @ w2^T) * (h > 0) / keep; dy1 = du2 + dhpre @ w1^T
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nf = min(FC, F - f0);
    __syncthreads();
    gemm(sDZ, D, QR, D, w.w2 + (size_t)f0 * D, 1, D, nf, bf,
            [&](int q, int c, float acc) {
              const size_t e = (q0 + q) * F + f0 + c;
              const float dhp = wd_ld(h, e, bf) > 0.f ? acc * ikeep : 0.f;
              sDHf[q * FC + c] = dhp;
              sDH[q * FC + c] = gt_rn(dhp, bf);
              wd_store(wk.dh, e, dhp, bf);
            });
    __syncthreads();
    for (int c = tid; c < nf; c += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < QR; ++q) s += sDHf[q * FC + c];
      part[6 * D + f0 + c] = s;
    }
    gemm(sDH, FC, QR, nf, w.w1 + f0, 1, F, D, bf,
            [&](int q, int c, float acc) { sDY1[q * D + c] += acc; });
  }
  __syncthreads();

  // ---- 3. LayerNorm 1 backward, then the attention-output dropout
  for (int q = warp; q < QR; q += nw) {
    const size_t qi = q0 + q;
    const float* st = strip + qi * SW;
    float dy[WD_CPL], uh[WD_CPL];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      dy[m] = uh[m] = 0.f;
      if (d < D) {
        dy[m] = sDY1[q * D + d];
        uh[m] = st[2 * D + d];
        const float gg = dy[m] * w.g1[d];
        m1 += gg;
        m2 += gg * uh[m];
      }
    }
    m1 = wd_warp_sum(m1) / (float)D;
    m2 = wd_warp_sum(m2) / (float)D;
    const float rs1 = st[4 * D];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float du1 = (dy[m] * w.g1[d] - m1 - uh[m] * m2) * rs1;
        const float da = gt_drop(dr, kO, (uint32_t)qi * D + d, du1);
        sDY1[q * D + d] = du1;
        sDZ[q * D + d] = gt_rn(da, bf);
        wd_store(wk.da, qi * D + d, da, bf);
        cs[0][m] += da;
        cs[1][m] += dy[m] * uh[m];
        cs[2][m] += dy[m];
      }
    }
  }
  __syncthreads();

  // dctx = da @ w_out^T; meanwhile load q/k/v (all rows) and the
  // probabilities (query rows)
  gemm(sDZ, D, QR, D, w.w_out, 1, D, D, bf,
          [&](int q, int c, float acc) { sDCTX[q * D + c] = gt_rn(acc, bf); });
  for (int e = tid; e < Rv * D3; e += blockDim.x) {
    const int r = e / D3;
    sQKV[r * LQ + (e - r * D3)] = gt_rn(qkv[row0 * D3 + e], bf);
  }
  for (int e = tid; e < QR * S; e += blockDim.x) sA[e] = attn[q0 * S + e];
  __syncthreads();

  // ---- 4. attention backward, query side: a warp per query row, lane j =
  // key slot j; then dq with lanes over columns
  for (int q = warp; q < QR; q += nw) {
    const int r = SLOT0 ? q * S : q;
    const int kb = (r / S) * S;
    const uint32_t qi = (uint32_t)(q0 + q);
    float a = 0.f, dat = 0.f;
    if (lane < S) {
      a = sA[q * S + lane];
      const bool kp = !dr.on || gt_keep(dr, kA, qi * S + lane);
      sAD[q * S + lane] = gt_rn(dr.on ? (kp ? a / dr.keep : 0.f) : a, bf);
      const float* vv = sQKV + (kb + lane) * LQ + 2 * D;
      float dd = 0.f;
      for (int d = 0; d < D; ++d) dd = fmaf(sDCTX[q * D + d], vv[d], dd);
      dat = dr.on ? (kp ? dd / dr.keep : 0.f) : dd;
    }
    const float sdot = wd_warp_sum(dat * a);
    const float ds = gt_rn(a * (dat - sdot) * scale, bf);
    if (lane < S) sDS[q * S + lane] = ds;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
        if (d < D) acc = fmaf(dsj, sQKV[(kb + j) * LQ + D + d], acc);
      }
      if (d < D) sDQKV[r * D3 + d] = acc;
    }
  }
  __syncthreads();

  // ---- 5. key/value side: a warp per row (key slot i of its neighborhood)
  for (int r = warp; r < Rv; r += nw) {
    const int g = r / S, i = r - g * S;
    const int nq = SLOT0 ? 1 : S;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d >= D) continue;
      float dk = 0.f, dv = 0.f;
      for (int qq = 0; qq < nq; ++qq) {
        const int q = SLOT0 ? g : g * S + qq;   // query row
        const int rq = SLOT0 ? g * S : q;       // its block row
        dv = fmaf(sAD[q * S + i], sDCTX[q * D + d], dv);
        dk = fmaf(sDS[q * S + i], sQKV[rq * LQ + d], dk);
      }
      sDQKV[r * D3 + D + d] = dk;
      sDQKV[r * D3 + 2 * D + d] = dv;
      if (SLOT0 && i != 0) sDQKV[r * D3 + d] = 0.f;
    }
  }
  __syncthreads();

  // ---- 6. b_in, then the rounded dqkv (operand of dx and of dW_in), dx
  for (int c = tid; c < D3; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < Rv; ++r) s += sDQKV[r * D3 + c];
    part[c] = s;
  }
  __syncthreads();
  for (int e = tid; e < Rv * D3; e += blockDim.x) {
    const float b = gt_rn(sDQKV[e], bf);
    sDQKV[e] = b;
    wd_store(wk.dqkv, row0 * D3 + e, b, bf);
  }
  __syncthreads();
  gemm(sDQKV, D3, Rv, D3, w.w_in, 1, D3, D, bf, [&](int r, int c, float acc) {
    float v = acc;
    if (!SLOT0) v += sDY1[r * D + c];
    else if (r % S == 0) v += sDY1[(r / S) * D + c];
    dx[(row0 + r) * D + c] = v;
  });
  __syncthreads();

  // ---- 7. the warps' column sums, added in warp order
  float* sRed = sU;  // [nw, 6, D]
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) sRed[(warp * 6 + k) * D + d] = cs[k][m];
    }
  __syncthreads();
  for (int p = tid; p < 6 * D; p += blockDim.x) {
    const int k = p / D, d = p - k * D;
    float s = 0.f;
    for (int ww = 0; ww < nw; ++ww) s += sRed[(ww * 6 + k) * D + d];
    part[(k < 3 ? 3 * D : 6 * D + F) + (k % 3) * D + d] = s;
  }
}

// Steps 2 and 3 after the row kernel: the four weight products in one
// launch, then one launch that sums their partial tiles in split order and
// the small partials in block order.
static cudaError_t wd_bwd_products(const void* xs, const float* strip,
                                   const void* h, const WdBwdWork& wk,
                                   float* grads, int N, int S, int D, int F,
                                   int G, bool slot0, int bf,
                                   cudaStream_t s) {
  WdProductSpec ps[4];
  wd_bwd_specs(xs, strip, h, wk, grads, N, S, D, F, slot0, bf, ps);
  const WgSmall sm{wk.small, (N + G - 1) / G, D, F, gt_grad_offsets(D, F),
                   grads};
  return wd_products(ps, 4, wk.split, sm, s);
}

// ------------------------------------------------------- recompute kernel
// Its products run on the tensor cores (WdMmaGemm); two blocks an SM at the
// README quickstart's G = 3, S = 9, D = 68 (110 KB of shared memory each).
template <bool SLOT0>
__global__ void __launch_bounds__(WD_THREADS, 2)
wd_recompute_bwd_kernel(const void* x, int x_bf16, const float* dout,
                        GtLayer w, GtDrop dr, int layer, float* dx,
                        WdBwdWork wk, int N, int S, int D, int F, int G,
                        float scale) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * G;
  const int Gv = min(G, N - n0);
  const size_t row0 = (size_t)n0 * S;
  const size_t q0 = SLOT0 ? (size_t)n0 : row0;
  wd_load_rows(smem, x, x_bf16, row0, Gv * S, D);
  WdLayerRes res;
  res.qkv = wk.qkv + row0 * 3 * D;
  res.attn = wk.attn + q0 * S;
  res.strip = wk.strip + q0 * (4 * D + 2);
  res.h = (char*)wk.h + q0 * F * (x_bf16 ? 2 : 4);
  res.h_bf16 = x_bf16;
  res.out = nullptr;
  const WdMmaGemm mma{smem + wd_mma_stage_offset(G, S, D, SLOT0)};
  wd_fwd_layer(smem, w, dr, layer, SLOT0, res, N, S, D, F, G, scale, x_bf16,
               mma);
  // the residuals are the block's own rows; the body begins with a barrier,
  // after which every thread of the block sees them
  __threadfence_block();
  wd_bwd_body<SLOT0>(smem, wk.qkv, wk.attn, wk.strip, wk.h, dout, w, dr,
                     layer, dx, wk, N, S, D, F, G, scale, x_bf16, mma);
}

// Layer `layer` of a stack of `stored` layers (slice layer % stored; its
// dropout streams those of timestep `layer`): the recompute kernel, then
// the products.  work: wd_bwd_work(..., recompute=true) bytes.
template <bool SLOT0>
static int wd_recompute_bwd(const void* x, int x_bf16, const float* dout,
                            const float* const* params, int stored,
                            int layer, float* dx, void* work, float* grads,
                            int N, int S, int D, int F, int G, float scale,
                            unsigned int seed, unsigned int keep24, float keep,
                            int drop_on, void* stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32)
    return (int)cudaErrorInvalidValue;
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  const GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  WdBwdWork wk;
  wd_bwd_work(N, S, D, F, G, SLOT0, x_bf16, true, (char*)work, &wk);
  const size_t smem = wd_recompute_mma_smem_bytes(G, S, D, SLOT0);
  cudaError_t e = cudaFuncSetAttribute(
      wd_recompute_bwd_kernel<SLOT0>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + G - 1) / G;
  wd_recompute_bwd_kernel<SLOT0><<<blocks, WD_THREADS, smem, s>>>(
      x, x_bf16, dout, w, dr, layer, dx, wk, N, S, D, F, G, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)wd_bwd_products(x, wk.strip, wk.h, wk, grads, N, S, D, F, G,
                              SLOT0, x_bf16, s);
}
