// Device code of the wide-row encoder kernels (rows of up to 128 features):
// the warp helpers, the product routine on the CUDA cores, the forward
// layer wd_fwd_layer with its row-wise steps, and the row loader.
// wd_fwd_layer is the forward kernels' layer (wide_tc_fwd.cuh) for
// float32 rows, rows past D = 80 and K5's up to D = 32, on the CUDA cores,
// and, on WdMmaGemm, the forward that the recompute backwards (K8w/K8ws,
// K10w, K14w) run; K6's backward body and K11/K12 (ffn.cu) share the
// helpers.
//
// Layout: a block of 256 threads holds G whole neighborhoods (R = G*S <= 32
// rows) in shared memory.  Row-wise work (attention, LayerNorm, dropout) takes
// one warp per row, lane l holding columns l, l+32, l+64 and l+96, so the
// LayerNorm sums and the softmax over the S <= 32 keys are warp shuffles.
// The products go through a routine given as a template parameter: wd_gemm
// (the CUDA cores: FMAs in K order in 4 x 4 or 8 x 1 register tiles) or
// WdMmaGemm (wide_mma.cuh, the tensor cores).  The
// weights are never staged whole: w_in and w_out are 4*D^2 values (256 KB
// in f32 at D=128), more than a block's shared memory.
#pragma once

#include "common.cuh"

#define WD_MAXD 128
#define WD_CPL 4      // columns per lane: WD_MAXD / 32
#define WD_FC 128     // FFN hidden columns per chunk
#define WD_RT 8       // rows of wd_gemm_col8's tile; rows pad to a multiple
#define WD_THREADS 256

__device__ __forceinline__ float wd_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float wd_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows padded to whole product tiles
__host__ __device__ inline int wd_pad(int r) {
  return (r + WD_RT - 1) / WD_RT * WD_RT;
}

// leading dimension of q/k/v rows in shared memory: odd, so the S key rows
// that the lanes of a warp read lie in distinct banks
__host__ __device__ inline int wd_ldq(int D) { return (3 * D) | 1; }

// wd_gemm's tile where the weights' rows are not 16-byte aligned (D=65)
// or not neighbouring (wc != 1): a thread owns one output column and 8
// rows, one weight load feeding 8 FMAs; with A16, 4 K values of an A row a
// shared-memory load.
template <bool A16, class Epi>
__device__ __forceinline__ void wd_gemm_col8(const float* A, int lda, int M,
                                             int K,
                                             const float* __restrict__ w,
                                             int wk, int wc, int Nc, int bf,
                                             Epi epi) {
  const int tiles = (M + WD_RT - 1) / WD_RT;
  for (int item = threadIdx.x; item < Nc * tiles; item += blockDim.x) {
    const int c = item % Nc;
    const int r0 = (item / Nc) * WD_RT;
    float acc[WD_RT];
#pragma unroll
    for (int i = 0; i < WD_RT; ++i) acc[i] = 0.f;
    const float* wp = w + (size_t)c * wc;
    const float* ap = A + (size_t)r0 * lda;
    int k = 0;
    if constexpr (A16) {
      for (; k + 4 <= K; k += 4) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = gt_rn(__ldg(wp + (size_t)(k + j) * wk), bf);
#pragma unroll
        for (int i = 0; i < WD_RT; ++i) {
          const float4 a = *(const float4*)(ap + i * lda + k);
          acc[i] = fmaf(a.x, wv[0], acc[i]);
          acc[i] = fmaf(a.y, wv[1], acc[i]);
          acc[i] = fmaf(a.z, wv[2], acc[i]);
          acc[i] = fmaf(a.w, wv[3], acc[i]);
        }
      }
    }
    for (; k < K; ++k) {
      const float wv = gt_rn(__ldg(wp + (size_t)k * wk), bf);
#pragma unroll
      for (int i = 0; i < WD_RT; ++i) acc[i] = fmaf(ap[i * lda + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < WD_RT; ++i)
      if (r0 + i < M) epi(r0 + i, c, acc[i]);
  }
}

// wd_gemm's tile where the weights' rows are 16-byte aligned: a thread owns
// 4 rows and 4 neighbouring columns, so each weight load (16 bytes) brings
// 4 columns and each A value read from shared memory feeds 4 FMAs; with
// A16, 4 K values of an A row a shared-memory load.
template <bool A16, class Epi>
__device__ __forceinline__ void wd_gemm_44(const float* A, int lda, int M,
                                           int K, const float* __restrict__ w,
                                           int wk, int Nc, int bf, Epi epi) {
  const int tiles = (M + 3) / 4, cg = Nc / 4;
  for (int item = threadIdx.x; item < cg * tiles; item += blockDim.x) {
    const int c0 = (item % cg) * 4, r0 = (item / cg) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
    const float* wp = w + c0;
    const float* ap = A + (size_t)r0 * lda;
    auto wrow = [&](int k) {  // W(k, c0 .. c0 + 3), rounded
      float4 v = __ldg((const float4*)(wp + (size_t)k * wk));
      v.x = gt_rn(v.x, bf);
      v.y = gt_rn(v.y, bf);
      v.z = gt_rn(v.z, bf);
      v.w = gt_rn(v.w, bf);
      return v;
    };
    auto step = [&](float a, const float4& v, float (&r)[4]) {
      r[0] = fmaf(a, v.x, r[0]);
      r[1] = fmaf(a, v.y, r[1]);
      r[2] = fmaf(a, v.z, r[2]);
      r[3] = fmaf(a, v.w, r[3]);
    };
    int k = 0;
    if constexpr (A16) {
      for (; k + 4 <= K; k += 4) {
        const float4 w0 = wrow(k), w1 = wrow(k + 1), w2 = wrow(k + 2),
                     w3 = wrow(k + 3);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *(const float4*)(ap + i * lda + k);
          step(a.x, w0, acc[i]);
          step(a.y, w1, acc[i]);
          step(a.z, w2, acc[i]);
          step(a.w, w3, acc[i]);
        }
      }
    }
    for (; k < K; ++k) {
      const float4 v = wrow(k);
#pragma unroll
      for (int i = 0; i < 4; ++i) step(ap[i * lda + k], v, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < M)
#pragma unroll
        for (int n = 0; n < 4; ++n) epi(r0 + i, c0 + n, acc[i][n]);
  }
}

// C[r][c] = sum_k A[r*lda + k] * W(k, c) with W(k, c) = w[k*wk + c*wc]
// (rounded to bf16 when bf) for rows r < M and columns c < Nc; calls
// epi(r, c, C[r][c]).  A lives in shared memory with wd_pad(M) rows.  The
// sums are FMAs in K order, one accumulator an output, whatever the tile:
// 4 x 4 (wd_gemm_44) where a row of 4 neighbouring weights is one aligned
// 16-byte load, else a column of 8 rows (wd_gemm_col8): with 4-byte
// weight loads in the 4 x 4 tile K4tw ran 31% slower than on the column at
// D=65 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
template <class Epi>
__device__ __forceinline__ void wd_gemm(const float* A, int lda, int M, int K,
                                        const float* __restrict__ w, int wk,
                                        int wc, int Nc, int bf, Epi epi) {
  const bool a16 = lda % 4 == 0 && ((uintptr_t)A & 15) == 0;
  if (wc == 1 && wk % 4 == 0 && Nc % 4 == 0 && ((uintptr_t)w & 15) == 0) {
    if (a16)
      wd_gemm_44<true>(A, lda, M, K, w, wk, Nc, bf, epi);
    else
      wd_gemm_44<false>(A, lda, M, K, w, wk, Nc, bf, epi);
  } else if (a16) {
    wd_gemm_col8<true>(A, lda, M, K, w, wk, wc, Nc, bf, epi);
  } else {
    wd_gemm_col8<false>(A, lda, M, K, w, wk, wc, Nc, bf, epi);
  }
}

// wd_gemm as the product routine of wd_fwd_layer and wd_bwd_body (their
// default, the forward kernels' and K6's; the tensor-core routine is
// WdMmaGemm, wide_mma.cuh)
struct WdCoreGemm {
  template <class Epi>
  __device__ __forceinline__ void operator()(const float* A, int lda, int M,
                                             int K,
                                             const float* __restrict__ w,
                                             int wk, int wc, int Nc, int bf,
                                             Epi epi) const {
    wd_gemm(A, lda, M, K, w, wk, wc, Nc, bf, epi);
  }
};

// LayerNorm statistics of one row held by a warp (u: the lane's columns, 0
// beyond D); u becomes uhat; returns rstd
__device__ __forceinline__ float wd_ln(float* u, int D, int lane) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < WD_CPL; ++m) s += u[m];
  const float mu = wd_warp_sum(s) / (float)D;
  float v = 0.f;
#pragma unroll
  for (int m = 0; m < WD_CPL; ++m)
    if (lane + 32 * m < D) {
      const float c = u[m] - mu;
      v += c * c;
    }
  const float rs = 1.0f / sqrtf(wd_warp_sum(v) / (float)D + 1e-5f);
#pragma unroll
  for (int m = 0; m < WD_CPL; ++m)
    u[m] = (lane + 32 * m < D) ? (u[m] - mu) * rs : 0.f;
  return rs;
}

// ================================================================ forward
// Stores a value of a tensor held in bf16 (bf) or f32, and loads one back.
__device__ __forceinline__ void wd_store(void* p, size_t e, float v, int bf) {
  if (bf)
    ((__nv_bfloat16*)p)[e] = __float2bfloat16(v);
  else
    ((float*)p)[e] = v;
}

__device__ __forceinline__ float wd_ld(const void* p, size_t e, int bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[e])
            : ((const float*)p)[e];
}

// What one forward layer writes, offset to the block's first row (qkv) or
// first query row (the rest); each null where not wanted.
struct WdLayerRes {
  float* qkv;    // [rows, 3D] q/k/v of every row
  float* attn;   // [queries, S] attention probabilities
  float* strip;  // [queries, 4D+2] [ctx, y1, uhat1, uhat2, rstd1, rstd2]
  void* h;       // [queries, F] FFN hidden after dropout, bf16 if h_bf16
  int h_bf16;
  float* out;    // [G, D] slot-0 output of the last layer
};

// shared memory of wd_fwd_layer (the recompute kernels add their own)
__host__ __device__ inline size_t wd_fwd_smem_bytes(int G, int S, int D) {
  const size_t MP = (size_t)wd_pad(G * S);
  return sizeof(float) * MP * (4 * (size_t)D + wd_ldq(D) + WD_FC) +
         sizeof(int) * MP;
}

// The query rows of a layer over the block's G neighborhoods: every row,
// or slot 0 of each neighborhood in the last layer (`last`).  Query row q
// sits at block row qr(q) and has index qi(q) in the layer's dropout and
// residual numbering.
struct WdRows {
  int S, n0, QR;
  size_t row0;
  bool last;
  __device__ WdRows(int N, int S_, int G, bool last_)
      : S(S_), n0(blockIdx.x * G), last(last_) {
    const int Gv = min(G, N - n0);  // the block's neighborhoods
    row0 = (size_t)n0 * S;
    QR = last ? Gv : Gv * S;
  }
  __device__ int qr(int q) const { return last ? q * S : q; }
  __device__ uint32_t qi(int q) const {
    return last ? (uint32_t)(n0 + q) : (uint32_t)(row0 + q);
  }
};

// The row-wise steps of a forward layer, shared by wd_fwd_layer and
// wt_fwd_layer (wide_tc_fwd.cuh), a warp per query row.  put(q, d, v)
// writes operand (q, d) of the next product from the unrounded v, rounding
// it to the products' dtype.

// Attention of the query rows over their neighborhood's keys (lane j = key
// slot j), from q/k/v rounded in sQKV [rows, LQ]; the context goes to
// put and to the strip.
template <class Put>
__device__ __forceinline__ void wd_attention(const float* sQKV, int LQ, int D,
                                             const WdRows& rw, float scale,
                                             const GtDrop& dr, uint32_t kA,
                                             int mmbf, const WdLayerRes& res,
                                             Put put) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int S = rw.S, SW = 4 * D + 2;
  for (int q = threadIdx.x >> 5; q < rw.QR; q += nw) {
    const int r = rw.qr(q);
    const int kb = (r / S) * S;  // the neighborhood's first row
    float s = -INFINITY;
    if (lane < S) {
      const float* qv = sQKV + r * LQ;
      const float* kv = sQKV + (kb + lane) * LQ + D;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qv[d], kv[d], acc);
      s = acc * scale;
    }
    const float mx = wd_warp_max(s);
    const float ex = lane < S ? expf(s - mx) : 0.f;
    const float a = ex / wd_warp_sum(ex);
    float ad = 0.f;
    if (lane < S) {
      if (res.attn) res.attn[(size_t)q * S + lane] = a;
      ad = gt_rn(gt_drop(dr, kA, rw.qi(q) * S + lane, a), mmbf);
    }
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      float c = 0.f;
      for (int j = 0; j < S; ++j) {
        const float aj = __shfl_sync(0xffffffffu, ad, j);
        if (d < D) c = fmaf(aj, sQKV[(kb + j) * LQ + 2 * D + d], c);
      }
      if (d < D) {
        if (res.strip) res.strip[(size_t)q * SW + d] = c;
        put(q, d, c);
      }
    }
  }
}

// LayerNorm 1 of the query rows' residual sums in sZ [rows, D]: y1 to sY1,
// to put and to the strip; sZ becomes zero, the FFN output's accumulator.
template <class Put>
__device__ __forceinline__ void wd_ln1(float* sZ, float* sY1, const GtLayer& w,
                                       int D, const WdRows& rw,
                                       const WdLayerRes& res, Put put) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5, SW = 4 * D + 2;
  for (int q = threadIdx.x >> 5; q < rw.QR; q += nw) {
    float u[WD_CPL];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      u[m] = d < D ? sZ[q * D + d] : 0.f;
      if (d < D) sZ[q * D + d] = 0.f;
    }
    const float rs = wd_ln(u, D, lane);
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float y = u[m] * w.g1[d] + w.c1[d];
        sY1[q * D + d] = y;
        put(q, d, y);
        if (res.strip) {
          res.strip[(size_t)q * SW + D + d] = y;
          res.strip[(size_t)q * SW + 2 * D + d] = u[m];
        }
      }
    }
    if (res.strip && lane == 0) res.strip[(size_t)q * SW + 4 * D] = rs;
  }
}

// The FFN output sZ's bias and dropout, the residual y1 and LayerNorm 2:
// the output to res.out (last layer) or over the input in sX.
__device__ __forceinline__ void wd_ln2(float* sX, const float* sY1,
                                       const float* sZ, const GtLayer& w,
                                       int D, const WdRows& rw,
                                       const GtDrop& dr, uint32_t kZ,
                                       const WdLayerRes& res) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5, SW = 4 * D + 2;
  for (int q = threadIdx.x >> 5; q < rw.QR; q += nw) {
    float u[WD_CPL];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      u[m] = d < D ? sY1[q * D + d] + gt_drop(dr, kZ, rw.qi(q) * D + d,
                                               sZ[q * D + d] + w.b2[d])
                   : 0.f;
    }
    const float rs = wd_ln(u, D, lane);
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float o = u[m] * w.g2[d] + w.c2[d];
        if (res.strip) res.strip[(size_t)q * SW + 3 * D + d] = u[m];
        if (rw.last) {
          if (res.out) res.out[(size_t)q * D + d] = o;
        } else {
          sX[q * D + d] = o;
        }
      }
    }
    if (res.strip && lane == 0) res.strip[(size_t)q * SW + 4 * D + 1] = rs;
  }
}

// One post-norm layer (timestep `layer`: its dropout streams) over the
// block's G neighborhoods, whose rows' input the caller has put in sX (the
// first [wd_pad(G*S), D] floats of smem).  In the last layer (`last`) only
// slot 0 of a neighborhood is a query row and its output goes to res.out;
// otherwise every row is a query row and its output replaces its input in
// sX.  Begins with a barrier.  Its products go through `gemm` (wd_gemm's
// contract).
template <class Gemm = WdCoreGemm>
__device__ __forceinline__ void wd_fwd_layer(float* smem, const GtLayer& w,
                                             const GtDrop& dr, int layer,
                                             bool last, const WdLayerRes& res,
                                             int N, int S, int D, int F,
                                             int G, float scale, int mmbf,
                                             const Gemm& gemm = Gemm()) {
  const int MP = wd_pad(G * S);
  const int D3 = 3 * D, LQ = wd_ldq(D);
  float* sX = smem;             // [MP, D] layer input (f32)
  float* sOp = sX + MP * D;     // [MP, D] product operand (rounded)
  float* sY1 = sOp + MP * D;    // [MP, D] y1 of the query rows
  float* sZ = sY1 + MP * D;     // [MP, D] LN1 input, then the FFN output
  float* sQKV = sZ + MP * D;    // [MP, LQ] q/k/v (rounded)
  float* sH = sQKV + MP * LQ;   // [MP, WD_FC] hidden chunk (rounded)

  const int tid = threadIdx.x;
  const WdRows rw(N, S, G, last);
  const int Rv = min(G, N - rw.n0) * S;  // the block's rows
  const int QR = rw.QR;
  const uint32_t kA = gt_stream_key(dr.seed, 4 * layer + 0);
  const uint32_t kO = gt_stream_key(dr.seed, 4 * layer + 1);
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  auto put = [&](int q, int d, float v) { sOp[q * D + d] = gt_rn(v, mmbf); };

  __syncthreads();  // sX holds the layer input
  for (int e = tid; e < Rv * D; e += blockDim.x) sOp[e] = gt_rn(sX[e], mmbf);
  __syncthreads();

  // ---- q, k, v of every row
  gemm(sOp, D, Rv, D, w.w_in, D3, 1, D3, mmbf, [&](int r, int c, float acc) {
    const float v = acc + w.b_in[c];
    if (res.qkv) res.qkv[(size_t)r * D3 + c] = v;
    sQKV[r * LQ + c] = gt_rn(v, mmbf);
  });
  __syncthreads();

  wd_attention(sQKV, LQ, D, rw, scale, dr, kA, mmbf, res, put);
  __syncthreads();

  // ---- attention output, its dropout and the residual
  gemm(sOp, D, QR, D, w.w_out, D, 1, D, mmbf, [&](int q, int c, float acc) {
    sZ[q * D + c] = sX[rw.qr(q) * D + c] +
                    gt_drop(dr, kO, rw.qi(q) * D + c, acc + w.b_out[c]);
  });
  __syncthreads();

  wd_ln1(sZ, sY1, w, D, rw, res, put);

  // ---- FFN, WD_FC hidden columns at a time; K5 and K8w store the hidden
  for (int f0 = 0; f0 < F; f0 += WD_FC) {
    const int nf = min(WD_FC, F - f0);
    __syncthreads();
    gemm(sOp, D, QR, D, w.w1 + f0, F, 1, nf, mmbf, [&](int q, int c, float acc) {
      const float hv = gt_drop(dr, kH, rw.qi(q) * (uint32_t)F + f0 + c,
                               fmaxf(acc + w.b1[f0 + c], 0.f));
      sH[q * WD_FC + c] = gt_rn(hv, mmbf);
      if (res.h) wd_store(res.h, (size_t)q * F + f0 + c, hv, res.h_bf16);
    });
    __syncthreads();
    gemm(sH, WD_FC, QR, nf, w.w2 + (size_t)f0 * D, D, 1, D, mmbf,
            [&](int q, int c, float acc) { sZ[q * D + c] += acc; });
  }
  __syncthreads();

  wd_ln2(sX, sY1, sZ, w, D, rw, dr, kZ, res);
}

// Loads the block's rows [Rv, D] of x (bf16 or f32) into sX as f32.
__device__ __forceinline__ void wd_load_rows(float* sX, const void* x,
                                             int x_bf16, size_t row0, int Rv,
                                             int D) {
  for (int e = threadIdx.x; e < Rv * D; e += blockDim.x)
    sX[e] = wd_ld(x, row0 * D + e, x_bf16);
}
