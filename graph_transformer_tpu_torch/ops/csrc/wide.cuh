// Device code of the wide-row encoder kernels: K5 (sampled forward that
// stores its residuals, FFN hidden included), K17 (the same on given rows,
// in their dtype), the wide K4 (eval forward) and
// K6 (per-layer backward from K5's residuals); K11/K12 (ffn.cu) share the
// warp helpers.  Rows hold up to 128 features.
//
// Layout: a block of 256 threads holds G whole neighborhoods (R = G*S <= 32
// rows) in shared memory.  Row-wise work (attention, LayerNorm, dropout) takes
// one warp per row, lane l holding columns l, l+32, l+64 and l+96, so the
// LayerNorm sums and the softmax over the S <= 32 keys are warp shuffles.
// The products take the rows' operands from shared memory and the weights
// from device memory (they are small and stay in L1/L2): a thread owns one
// output column and a tile of 8 rows, so a warp reads 32 neighbouring weights
// at once and one broadcast row value per step.  The weights are never staged
// whole: w_in and w_out are 4*D^2 values (256 KB in f32 at D=128), more than a
// block's shared memory.
#pragma once

#include "common.cuh"

#define WD_MAXD 128
#define WD_CPL 4      // columns per lane: WD_MAXD / 32
#define WD_FC 128     // FFN hidden columns per chunk
#define WD_RT 8       // rows per product register tile
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

// C[r][c] = sum_k A[r*lda + k] * W(k, c) with W(k, c) = w[k*wk + c*wc]
// (rounded to bf16 when bf) for rows r < M and columns c < Nc; calls
// epi(r, c, C[r][c]).  A lives in shared memory with wd_pad(M) rows.
template <class Epi>
__device__ __forceinline__ void wd_gemm(const float* A, int lda, int M, int K,
                                        const float* __restrict__ w, int wk,
                                        int wc, int Nc, int bf, Epi epi) {
  const int tiles = (M + WD_RT - 1) / WD_RT;
  for (int item = threadIdx.x; item < Nc * tiles; item += blockDim.x) {
    const int c = item % Nc;
    const int r0 = (item / Nc) * WD_RT;
    float acc[WD_RT];
#pragma unroll
    for (int i = 0; i < WD_RT; ++i) acc[i] = 0.f;
    const float* wp = w + (size_t)c * wc;
    const float* ap = A + (size_t)r0 * lda;
    for (int k = 0; k < K; ++k) {
      const float wv = gt_rn(__ldg(wp + (size_t)k * wk), bf);
#pragma unroll
      for (int i = 0; i < WD_RT; ++i) acc[i] = fmaf(ap[i * lda + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < WD_RT; ++i)
      if (r0 + i < M) epi(r0 + i, c, acc[i]);
  }
}

// wd_gemm as the product routine of wd_fwd_layer and wd_bwd_body (their
// default; the tensor-core routine is WdMmaGemm, wide_mma.cuh)
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

struct WdFwdIO {
  // K5, K13: sampled input
  const int* tag_rows;    // [N, table_w]
  const int* deg;         // [N]
  const int* self_tag;    // [N]
  const float* codebook;  // [C, D]
  const int* draws;       // [N, S-1] draws made outside, or null
  int* draws_out;         // [N, S-1] draws used, or null
  int table_w;
  // wide K4, K4t, K9: rows [N*S, D]
  const void* x_rows;
  int x_bf16;
  int t0;                 // timestep of layer 0 (its dropout streams)
  // outputs
  float* out;             // [N, D] slot-0 output of the last layer
  void* rows_out;         // [N*S, D] every row (x's dtype); all layers full
  void* xs;               // [T - xs_first, N*S, D] inputs of layers
  int xs_bf16;            // t >= xs_first (bf16 if xs_bf16, else f32), or null
  int xs_first;
  // K5's residuals; null for the other kernels
  float* qkv;                  // [T, N*S, 3D]
  float* attn_full;            // [T-1, N*S, S]
  float* attn_last;            // [N, S]
  float* strip_full;           // [T-1, N*S, 4D+2]
  float* strip_last;           // [N, 4D+2]
  void* h_full;                // [T-1, N*S, F] FFN hidden after dropout
  void* h_last;                // [N, F]
  int h_bf16;                  // the hidden in bf16 (K5), else f32
};

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

__host__ __device__ inline size_t wd_fwd_smem_bytes(int G, int S, int D) {
  const size_t MP = (size_t)wd_pad(G * S);
  return sizeof(float) * MP * (4 * (size_t)D + wd_ldq(D) + WD_FC) +
         sizeof(int) * MP;
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
  const int D3 = 3 * D, LQ = wd_ldq(D), SW = 4 * D + 2;
  float* sX = smem;             // [MP, D] layer input (f32)
  float* sOp = sX + MP * D;     // [MP, D] product operand (rounded)
  float* sY1 = sOp + MP * D;    // [MP, D] y1 of the query rows
  float* sZ = sY1 + MP * D;     // [MP, D] LN1 input, then the FFN output
  float* sQKV = sZ + MP * D;    // [MP, LQ] q/k/v (rounded)
  float* sH = sQKV + MP * LQ;   // [MP, WD_FC] hidden chunk (rounded)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n0 = blockIdx.x * G;   // the block's first neighborhood
  const int Gv = min(G, N - n0);   // its neighborhoods
  const int Rv = Gv * S;           // its rows
  const size_t row0 = (size_t)n0 * S;
  const uint32_t kA = gt_stream_key(dr.seed, 4 * layer + 0);
  const uint32_t kO = gt_stream_key(dr.seed, 4 * layer + 1);
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  // query rows: every row, or slot 0 of each neighborhood in the last
  // layer; query row q sits at block row qr(q) and has index qi(q) in the
  // layer's dropout and residual numbering
  const int QR = last ? Gv : Rv;
  auto qr = [&](int q) { return last ? q * S : q; };
  auto qi = [&](int q) {
    return last ? (uint32_t)(n0 + q) : (uint32_t)(row0 + q);
  };

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

  // ---- attention: a warp per query row, lane j = key slot j
  for (int q = warp; q < QR; q += nw) {
    const int r = qr(q);
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
      ad = gt_rn(gt_drop(dr, kA, qi(q) * S + lane, a), mmbf);
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
        sOp[q * D + d] = gt_rn(c, mmbf);
      }
    }
  }
  __syncthreads();

  // ---- attention output, its dropout and the residual
  gemm(sOp, D, QR, D, w.w_out, D, 1, D, mmbf, [&](int q, int c, float acc) {
    sZ[q * D + c] = sX[qr(q) * D + c] + gt_drop(dr, kO, qi(q) * D + c, acc + w.b_out[c]);
  });
  __syncthreads();

  // ---- LayerNorm 1
  for (int q = warp; q < QR; q += nw) {
    float u[WD_CPL];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      u[m] = d < D ? sZ[q * D + d] : 0.f;
      if (d < D) sZ[q * D + d] = 0.f;  // becomes the FFN accumulator
    }
    const float rs = wd_ln(u, D, lane);
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float y = u[m] * w.g1[d] + w.c1[d];
        sY1[q * D + d] = y;
        sOp[q * D + d] = gt_rn(y, mmbf);
        if (res.strip) {
          res.strip[(size_t)q * SW + D + d] = y;
          res.strip[(size_t)q * SW + 2 * D + d] = u[m];
        }
      }
    }
    if (res.strip && lane == 0) res.strip[(size_t)q * SW + 4 * D] = rs;
  }

  // ---- FFN, WD_FC hidden columns at a time; K5 and K8w store the hidden
  for (int f0 = 0; f0 < F; f0 += WD_FC) {
    const int nf = min(WD_FC, F - f0);
    __syncthreads();
    gemm(sOp, D, QR, D, w.w1 + f0, F, 1, nf, mmbf, [&](int q, int c, float acc) {
      const float hv = gt_drop(dr, kH, qi(q) * (uint32_t)F + f0 + c,
                               fmaxf(acc + w.b1[f0 + c], 0.f));
      sH[q * WD_FC + c] = gt_rn(hv, mmbf);
      if (res.h) wd_store(res.h, (size_t)q * F + f0 + c, hv, res.h_bf16);
    });
    __syncthreads();
    gemm(sH, WD_FC, QR, nf, w.w2 + (size_t)f0 * D, D, 1, D, mmbf,
            [&](int q, int c, float acc) { sZ[q * D + c] += acc; });
  }
  __syncthreads();

  // ---- FFN-output dropout, residual, LayerNorm 2
  for (int q = warp; q < QR; q += nw) {
    float u[WD_CPL];
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      u[m] = d < D ? sY1[q * D + d] + gt_drop(dr, kZ, qi(q) * D + d,
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
        if (last) {
          if (res.out) res.out[(size_t)q * D + d] = o;
        } else {
          sX[q * D + d] = o;
        }
      }
    }
    if (res.strip && lane == 0) res.strip[(size_t)q * SW + 4 * D + 1] = rs;
  }
}

// Loads the block's rows [Rv, D] of x (bf16 or f32) into sX as f32.
__device__ __forceinline__ void wd_load_rows(float* sX, const void* x,
                                             int x_bf16, size_t row0, int Rv,
                                             int D) {
  for (int e = threadIdx.x; e < Rv * D; e += blockDim.x)
    sX[e] = wd_ld(x, row0 * D + e, x_bf16);
}

__global__ void __launch_bounds__(WD_THREADS)
wd_encoder_fwd_kernel(WdFwdIO io, GtStack st, GtDrop dr, int N, int S, int D,
                      int F, int T, int G, float scale, int mmbf,
                      int sampled) {
  extern __shared__ float smem[];
  const int MP = wd_pad(G * S);
  const int D3 = 3 * D, SW = 4 * D + 2;
  float* sX = smem;  // [MP, D] layer input; wd_fwd_layer's layout follows
  int* sTag = (int*)(smem + MP * (4 * D + wd_ldq(D) + WD_FC));

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * G;   // the block's first neighborhood
  const int Gv = min(G, N - n0);   // its neighborhoods
  const int Rv = Gv * S;           // its rows
  const size_t row0 = (size_t)n0 * S;
  const size_t NS = (size_t)N * S;
  const size_t hsz = io.h_bf16 ? 2 : 4;  // bytes of a stored hidden value

  // ---- layer-0 input: sampled codebook rows (K5, K13) or given rows
  if (sampled) {
    for (int r = tid; r < Rv; r += blockDim.x) {
      const int g = r / S, i = r - g * S, n = n0 + g;
      int tag;
      if (i == 0) {
        tag = io.self_tag[n];
      } else {
        const uint32_t e = (uint32_t)n * (S - 1) + (i - 1);
        int di;
        if (io.draws) {
          di = io.draws[e];
        } else {
          const uint32_t key = gt_stream_key(dr.seed, GT_SAMPLER_STREAM);
          const float u = (float)(gt_bits(key, e) >> 8) * (1.0f / 16777216.0f);
          int dg = io.deg[n];
          dg = dg < 1 ? 1 : (dg > io.table_w ? io.table_w : dg);
          const float df = (float)dg;
          di = (int)fminf(floorf(__fmul_rn(u, df)), df - 1.0f);
        }
        if (io.draws_out) io.draws_out[e] = di;
        tag = io.tag_rows[(size_t)n * io.table_w + di];
      }
      sTag[r] = tag;
    }
    __syncthreads();
    for (int e = tid; e < Rv * D; e += blockDim.x) {
      const int r = e / D;
      sX[e] = gt_bfr(io.codebook[(size_t)sTag[r] * D + (e - r * D)]);
    }
  } else {
    wd_load_rows(sX, io.x_rows, io.x_bf16, row0, Rv, D);
  }

  for (int t = 0; t < T; ++t) {
    // with rows_out every layer is a full layer (K9)
    const bool last = (t == T - 1) && !io.rows_out;
    WdLayerRes res;
    res.h_bf16 = io.h_bf16;
    if (last) {
      res.attn = io.attn_last ? io.attn_last + (size_t)n0 * S : nullptr;
      res.strip = io.strip_last ? io.strip_last + (size_t)n0 * SW : nullptr;
      res.h = io.h_last ? (char*)io.h_last + (size_t)n0 * F * hsz : nullptr;
      res.out = io.out + (size_t)n0 * D;
    } else {
      res.attn = io.attn_full ? io.attn_full + ((size_t)t * NS + row0) * S
                              : nullptr;
      res.strip = io.strip_full ? io.strip_full + ((size_t)t * NS + row0) * SW
                                : nullptr;
      res.h = io.h_full
                  ? (char*)io.h_full + ((size_t)t * NS + row0) * F * hsz
                  : nullptr;
      res.out = nullptr;
    }
    res.qkv = io.qkv ? io.qkv + ((size_t)t * NS + row0) * D3 : nullptr;
    __syncthreads();  // sX holds the layer input
    if (io.xs && t >= io.xs_first) {
      const size_t base = ((size_t)(t - io.xs_first) * NS + row0) * D;
      for (int e = tid; e < Rv * D; e += blockDim.x)
        wd_store(io.xs, base + e, sX[e], io.xs_bf16);
    }
    wd_fwd_layer(smem, gt_layer_at(st, t, D, F), dr, io.t0 + t, last, res, N,
                 S, D, F, G, scale, mmbf);
  }
  if (io.rows_out) {
    __syncthreads();
    for (int e = tid; e < Rv * D; e += blockDim.x)
      wd_store(io.rows_out, row0 * D + e, sX[e], io.x_bf16);
  }
}

static inline cudaError_t wd_launch_fwd(const WdFwdIO& io, const GtStack& st,
                                        const GtDrop& dr, int N, int S, int D,
                                        int F, int T, int G, float scale,
                                        int mmbf, int sampled,
                                        cudaStream_t stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32 || T < 1)
    return cudaErrorInvalidValue;
  const size_t smem = wd_fwd_smem_bytes(G, S, D);
  cudaError_t e = cudaFuncSetAttribute(
      wd_encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + G - 1) / G;
  wd_encoder_fwd_kernel<<<blocks, WD_THREADS, smem, stream>>>(
      io, st, dr, N, S, D, F, T, G, scale, mmbf, sampled);
  return cudaGetLastError();
}
