// K6 — backward of one wide-row encoder layer from K5's residuals: one
// kernel templated on SLOT0 (the slot-0 last layer), two entry points.
//
// Replaces graph_transformer_tpu/ops/pallas_stored_bwd.py:_stored_bwd1_kernel
// (entry _stored_bwd1_call, slot0 flag; walked by _stored_bwd_core).  Inputs:
// the layer's input rows (bf16), q/k/v, the attention probabilities, the
// LayerNorm strip, the FFN hidden h (bf16) and the output cotangent; in the
// last layer only slot 0 of a neighborhood is a query row, while its keys and
// values span all S slots.  The relu' times dropout factor of the hidden is
// (h > 0) / keep, exact from h alone; the other three dropout masks replay
// from the forward's counters.  Outputs: dx [N*S, D] and the 12 weight
// gradients.
//
// The TPU kernel carries its weight gradients across the sequential grid
// (zeroed at step 0, += at every step).  Blocks here run in any order, and a
// per-block partial of all 12 gradients is 4*(4D^2 + 2DF) bytes (~0.6 MB at
// D=65, F=1024), too large to write for every 27-row block.  So:
//   1. the row kernel (a block per G neighborhoods) computes dx and writes
//      the per-row factors of the four weight products in bf16 (dqkv, da,
//      dhpre, dz: exactly the rounded operands the products take), plus
//      per-block partial sums of the eight bias and LayerNorm gradients;
//   2. the four weight products (x^T dqkv, ctx^T da, y1^T dhpre, h^T dz) run
//      as split-K products over the rows, each split writing its own
//      partial tile (wd_wgrad, wide.cuh);
//   3. a second pass sums the partials in block / split order.
// No float atomics, so runs repeat bit for bit.
//
// Bound at N=4096, S=9, D=65, F=1024, from the H100 SXM data sheet's rates
// (3.35 TB/s, 989 TFLOP/s bf16): a full layer reads its 75 MB hidden and
// ~15 MB of other residuals for ~27 GFLOP of bf16 products, so the bytes
// bound it (~0.03 ms).  This version also writes and reads back the 75 MB
// dhpre, and runs the products on the CUDA cores in f32 with bf16-rounded
// operands; tensor-core products and fusing the dW1 product into the row
// kernel are later work.
#include "wide.cuh"

// ------------------------------------------------------------ row kernel
// floats of shared memory: per query row dz/da, dy1/du1, dctx (3 x [QP, D]),
// the probabilities, their dropped copies and ds (3 x [QP, S]), and one
// region used in turn by the hidden chunk (2 x [QP, WD_FC]), by q/k/v and
// dqkv ([MP, LQ + 3D]) and by the per-warp column sums ([8, 6, D])
static inline size_t wd_bwd_smem_floats(int G, int S, int D, bool slot0) {
  const size_t MP = (size_t)wd_pad(G * S);
  const size_t QP = (size_t)wd_pad(slot0 ? G : G * S);
  size_t U = 2 * QP * WD_FC;
  const size_t att = MP * (wd_ldq(D) + 3 * (size_t)D);
  if (att > U) U = att;
  const size_t red = (WD_THREADS / 32) * 6 * (size_t)D;
  if (red > U) U = red;
  return 3 * QP * D + 3 * QP * S + U;
}

extern "C" size_t gt_k6_smem_bytes(int G, int S, int D) {
  return sizeof(float) * wd_bwd_smem_floats(G, S, D, false);
}

extern "C" size_t gt_k6s_smem_bytes(int G, int S, int D) {
  return sizeof(float) * wd_bwd_smem_floats(G, S, D, true);
}

// per-block partial sums of the small gradients, in this order:
// [b_in 3D | b_out g1 c1 3D | b1 F | b2 g2 c2 3D]
__host__ __device__ inline int wd_small_width(int D, int F) {
  return 9 * D + F;
}

template <bool SLOT0>
__global__ void __launch_bounds__(WD_THREADS)
wd_stored_bwd_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ attn,
                     const float* __restrict__ strip,
                     const __nv_bfloat16* __restrict__ h,
                     const float* __restrict__ dout, GtLayer w, GtDrop dr,
                     int layer, float* dx, __nv_bfloat16* dqkv_b,
                     __nv_bfloat16* da_b, __nv_bfloat16* dh_b,
                     __nv_bfloat16* dz_b, float* small, int N, int S, int D,
                     int F, int G, float scale) {
  extern __shared__ float smem[];
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
  float* part = small + (size_t)blockIdx.x * wd_small_width(D, F);
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
        sDZ[q * D + d] = gt_bfr(dz);
        dz_b[qi * D + d] = __float2bfloat16(dz);
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
    wd_gemm(sDZ, D, QR, D, w.w2 + (size_t)f0 * D, 1, D, nf, 1,
            [&](int q, int c, float acc) {
              const size_t e = (q0 + q) * F + f0 + c;
              const float dhp = __bfloat162float(h[e]) > 0.f ? acc * ikeep : 0.f;
              const float dhb = gt_bfr(dhp);
              sDHf[q * FC + c] = dhp;
              sDH[q * FC + c] = dhb;
              dh_b[e] = __float2bfloat16(dhb);
            });
    __syncthreads();
    for (int c = tid; c < nf; c += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < QR; ++q) s += sDHf[q * FC + c];
      part[6 * D + f0 + c] = s;
    }
    wd_gemm(sDH, FC, QR, nf, w.w1 + f0, 1, F, D, 1,
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
        sDZ[q * D + d] = gt_bfr(da);
        da_b[qi * D + d] = __float2bfloat16(da);
        cs[0][m] += da;
        cs[1][m] += dy[m] * uh[m];
        cs[2][m] += dy[m];
      }
    }
  }
  __syncthreads();

  // dctx = da @ w_out^T; meanwhile load q/k/v (all rows) and the
  // probabilities (query rows)
  wd_gemm(sDZ, D, QR, D, w.w_out, 1, D, D, 1,
          [&](int q, int c, float acc) { sDCTX[q * D + c] = gt_bfr(acc); });
  for (int e = tid; e < Rv * D3; e += blockDim.x) {
    const int r = e / D3;
    sQKV[r * LQ + (e - r * D3)] = gt_bfr(qkv[row0 * D3 + e]);
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
      sAD[q * S + lane] = gt_bfr(dr.on ? (kp ? a / dr.keep : 0.f) : a);
      const float* vv = sQKV + (kb + lane) * LQ + 2 * D;
      float dd = 0.f;
      for (int d = 0; d < D; ++d) dd = fmaf(sDCTX[q * D + d], vv[d], dd);
      dat = dr.on ? (kp ? dd / dr.keep : 0.f) : dd;
    }
    const float sdot = wd_warp_sum(dat * a);
    const float ds = gt_bfr(a * (dat - sdot) * scale);
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
    const float b = gt_bfr(sDQKV[e]);
    sDQKV[e] = b;
    dqkv_b[row0 * D3 + e] = __float2bfloat16(b);
  }
  __syncthreads();
  wd_gemm(sDQKV, D3, Rv, D3, w.w_in, 1, D3, D, 1, [&](int r, int c, float acc) {
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

// the block partials of the small gradients, summed in block order into
// their places in the flat gradient vector
__global__ void wd_reduce_small_kernel(const float* part, int nblk, int D,
                                       int F, GtGradOff o, float* grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int PS = wd_small_width(D, F);
  if (p >= PS) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * PS + p];
  int off;
  if (p < 3 * D) off = o.b_in + p;
  else if (p < 6 * D) off = o.b_out + (p - 3 * D);
  else if (p < 6 * D + F) off = o.b1 + (p - 6 * D);
  else off = o.b2 + (p - 6 * D - F);
  grads[off] = s;
}

// ------------------------------------------------------------- workspace
struct WdBwdWork {
  __nv_bfloat16 *dqkv, *da, *dh, *dz;
  float *small, *split;
};

static size_t wd_bwd_work(int N, int S, int D, int F, int G, bool slot0,
                          char* base, WdBwdWork* w) {
  const size_t NS = (size_t)N * S;
  const size_t Q = slot0 ? (size_t)N : NS;
  const int QI = (int)Q;
  const size_t blocks = (size_t)(N + G - 1) / G;
  size_t split = 0;
  const int dims[4][3] = {{(int)NS, D, 3 * D}, {QI, D, D}, {QI, D, F}, {QI, F, D}};
  for (int k = 0; k < 4; ++k) {
    const size_t f = (size_t)wd_splits(dims[k][0], dims[k][1], dims[k][2]) *
                     dims[k][1] * dims[k][2];
    if (f > split) split = f;
  }
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  w->dqkv = (__nv_bfloat16*)take(NS * 3 * D * 2);
  w->da = (__nv_bfloat16*)take(Q * D * 2);
  w->dh = (__nv_bfloat16*)take(Q * F * 2);
  w->dz = (__nv_bfloat16*)take(Q * D * 2);
  w->small = (float*)take(blocks * wd_small_width(D, F) * 4);
  w->split = (float*)take(split * 4);
  return off;
}

extern "C" size_t gt_k6_work_bytes(int N, int S, int D, int F, int G,
                                   int slot0) {
  WdBwdWork w;
  return wd_bwd_work(N, S, D, F, G, slot0 != 0, nullptr, &w);
}

template <bool SLOT0>
static int wd_bwd(const void* xs, const float* qkv, const float* attn,
                  const float* strip, const void* h, const float* dout,
                  const float* const* params, int stored, int layer, float* dx,
                  void* work, float* grads, int N, int S, int D, int F, int G,
                  float scale, unsigned int seed, unsigned int keep24,
                  float keep, int drop_on, void* stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32)
    return (int)cudaErrorInvalidValue;
  const GtLayer w = gt_layer_at(gt_make_stack(params, stored), layer, D, F);
  const GtDrop dr{seed, keep24, keep, drop_on};
  const GtGradOff o = gt_grad_offsets(D, F);
  cudaStream_t s = (cudaStream_t)stream;
  WdBwdWork wk;
  wd_bwd_work(N, S, D, F, G, SLOT0, (char*)work, &wk);
  const size_t smem = sizeof(float) * wd_bwd_smem_floats(G, S, D, SLOT0);
  cudaError_t e = cudaFuncSetAttribute(
      wd_stored_bwd_kernel<SLOT0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + G - 1) / G;
  wd_stored_bwd_kernel<SLOT0><<<blocks, WD_THREADS, smem, s>>>(
      qkv, attn, strip, (const __nv_bfloat16*)h, dout, w, dr, layer, dx,
      wk.dqkv, wk.da, wk.dh, wk.dz, wk.small, N, S, D, F, G, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int PS = wd_small_width(D, F);
  wd_reduce_small_kernel<<<(PS + 255) / 256, 256, 0, s>>>(wk.small, blocks, D,
                                                          F, o, grads);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int NS = N * S, Q = SLOT0 ? N : N * S, SW = 4 * D + 2;
  // dW_in = x^T dqkv over all rows; dW_out = ctx^T da, dW1 = y1^T dhpre and
  // dW2 = h^T dz over the query rows
  if ((e = wd_wgrad({xs, 1, D, 0}, {wk.dqkv, 1, 3 * D, 0}, NS, D, 3 * D,
                    wk.split, grads + o.w_in, s)) != cudaSuccess)
    return (int)e;
  if ((e = wd_wgrad({strip, 0, SW, 0}, {wk.da, 1, D, 0}, Q, D, D, wk.split,
                    grads + o.w_out, s)) != cudaSuccess)
    return (int)e;
  if ((e = wd_wgrad({strip, 0, SW, D}, {wk.dh, 1, F, 0}, Q, D, F, wk.split,
                    grads + o.w1, s)) != cudaSuccess)
    return (int)e;
  return (int)wd_wgrad({h, 1, F, 0}, {wk.dz, 1, D, 0}, Q, F, D, wk.split,
                       grads + o.w2, s);
}

// K6, a full layer.  attn [N*S, S], strip [N*S, 4D+2], h [N*S, F] (bf16),
// dout [N*S, D]; work: gt_k6_work_bytes(..., 0) bytes of scratch; grads: [P]
// (KERNEL_ORDER, flattened)
extern "C" int gt_k6_layer_bwd(const void* xs, const float* qkv,
                               const float* attn, const float* strip,
                               const void* h, const float* dout,
                               const float* const* params, int stored,
                               int layer, float* dx, void* work, float* grads,
                               int N, int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return wd_bwd<false>(xs, qkv, attn, strip, h, dout, params, stored, layer,
                       dx, work, grads, N, S, D, F, G, scale, seed, keep24,
                       keep, drop_on, stream);
}

// K6, the slot-0 last layer.  attn0 [N, S], strip0 [N, 4D+2], h0 [N, F],
// dout [N, D]; work: gt_k6_work_bytes(..., 1) bytes; the rest as above
extern "C" int gt_k6_slot0_bwd(const void* xs, const float* qkv,
                               const float* attn0, const float* strip0,
                               const void* h0, const float* dout,
                               const float* const* params, int stored,
                               int layer, float* dx, void* work, float* grads,
                               int N, int S, int D, int F, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  return wd_bwd<true>(xs, qkv, attn0, strip0, h0, dout, params, stored, layer,
                      dx, work, grads, N, S, D, F, G, scale, seed, keep24,
                      keep, drop_on, stream);
}
