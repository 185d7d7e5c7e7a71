// Block products of the wide row kernels on the tensor cores (mma.sync).
//
// WdMmaGemm computes what wd_gemm (wide.cuh) computes,
//   C[r][c] = sum_k A[r*lda + k] * W(k, c),  W(k, c) = w[k*wk + c*wc],
// for the block's rows r < M <= 32 and columns c < Nc, and hands each C[r][c]
// to the same epilogue callback.  The operands are the ones wd_gemm takes:
// A is already rounded by its caller, W is rounded to bf16 when bf, so in
// bf16 only the order of the sums changes.
//
// - bf16 (bf = 1): mma.sync m16n8k16, bf16 operands, f32 accumulation.
// - f32 (bf = 0): 3xTF32.  Each operand x is split into a TF32 high part
//   hi = tf32(x) and a TF32 remainder lo = tf32(x - hi), and the product
//   runs lo*hi + hi*lo + hi*hi through mma.sync m16n8k8 tf32 with f32
//   accumulation: ~22 of float32's 24 mantissa bits, where one TF32 pass
//   keeps 11 (~1e-3 relative), too few for the float32 checks.
//
// Layout: the block's rows are two m16 tiles; the output columns go in
// passes of WM_NB (16 n8 tiles), the 8 warps taking n tiles warp and
// warp + 8 of each pass for both m tiles.  The K dimension goes in tiles of
// WM_KC: the weight tile [WM_NB, WM_KC] is copied raw (f32) into shared
// memory by cp.async (16 bytes a copy where the weights' layout keeps them
// aligned), double-buffered, so the block reads each weight once from L2
// per pass instead of once per 8-row tile, while the A tile is
// converted into its operand form (bf16, or the TF32 hi and lo parts) once
// for all warps, aligned for ldmatrix whatever A's leading dimension.  Each
// warp converts its own weight fragments in registers.  (A ring of three
// weight tiles with one barrier a tile and the TF32 split of A in each warp
// measured slower on the H100.)  At <= 32 rows a block mma.sync is the
// instruction: wgmma takes 64-row tiles, and raising the row tile to 64 is
// later work.
#pragma once

#include "wide.cuh"

#define WM_NB 128   // output columns per pass
#define WM_KC 16    // K per staged tile
#define WM_LDW (WM_KC + 4)     // floats per staged weight column
#define WM_LDK (WM_NB + 8)     // floats per staged weight row (16-byte rows)
#define WM_LDT (WM_KC + 4)     // floats per row of a TF32 A tile
#define WM_LDB (WM_KC + 8)     // bf16 per row of a bf16 A tile
#define WM_WBUF (WM_NB * WM_LDW)       // floats of one weight tile
#define WM_ABUF (2 * 32 * WM_LDT)      // floats of one A tile (hi and lo)
// floats of the staging region: two weight tiles and two A tiles (30 KB)
#define WM_STAGE_FLOATS (2 * WM_WBUF + 2 * WM_ABUF)

__device__ __forceinline__ uint32_t wm_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !ok
__device__ __forceinline__ void wm_cp_async4(float* dst, const float* src,
                                             bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wm_smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned);
// zero-fills when !ok
__device__ __forceinline__ void wm_cp_async16(float* dst, const float* src,
                                              bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wm_smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void wm_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wm_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wm_ldmatrix_x4(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wm_smem_addr(p)));
}

// The product routine; `stage` is WM_STAGE_FLOATS floats of shared memory,
// 16-byte aligned, that nothing else uses.  Called by every thread of the
// block (WD_THREADS, 8 warps) with A ready; writes only `stage` before its
// epilogue calls, and every thread has passed its last barrier when the
// first epilogue call is made.
struct WdMmaGemm {
  float* stage;

  template <class Epi>
  __device__ __forceinline__ void operator()(const float* A, int lda, int M,
                                             int K,
                                             const float* __restrict__ w,
                                             int wk, int wc, int Nc, int bf,
                                             Epi epi) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int MT = M > 16 ? 2 : 1;  // m16 tiles
    const int nk = (K + WM_KC - 1) / WM_KC;
    float* sW = stage;                 // 2 x raw weight tile
    float* sA = stage + 2 * WM_WBUF;   // 2 x A tile
    // 16-byte copies where rows of 4 neighbouring weights stay aligned and
    // whole: along c into a [WM_KC][WM_LDK] tile when wc == 1, along k into
    // the [WM_NB][WM_LDW] tile when wk == 1; 4-byte copies otherwise
    const bool al16 = ((uintptr_t)w & 15) == 0;
    const bool v16c = wc == 1 && al16 && wk % 4 == 0 && Nc % 4 == 0;
    const bool v16k = wk == 1 && al16 && wc % 4 == 0 && K % 4 == 0;
    const int sk = v16c ? WM_LDK : 1;  // staged W(k, n) at k*sk + n*sn
    const int sn = v16c ? 1 : WM_LDW;
    // ldmatrix row of this lane: rows 0-15 of an m tile, column half l/16
    const int lrow = lane & 15, lhalf = lane >> 4;

    for (int nb0 = 0; nb0 < Nc; nb0 += WM_NB) {
      const int ntiles = (min(WM_NB, Nc - nb0) + 7) / 8;
      const int ncp = ntiles * 8;  // staged columns
      float acc[2][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.f;

      // copies K tile kt of the weights and converts that of A into buffer b
      auto load = [&](int kt, int b) {
        const int k0 = kt * WM_KC;
        float* dW = sW + b * WM_WBUF;
        if (v16c) {
          for (int e = tid; e < WM_KC * (WM_NB / 4); e += blockDim.x) {
            const int k = e / (WM_NB / 4), c = (e % (WM_NB / 4)) * 4;
            if (c >= ncp) continue;
            const bool ok = k0 + k < K && nb0 + c < Nc;
            wm_cp_async16(dW + k * WM_LDK + c,
                          ok ? w + (size_t)(k0 + k) * wk + (nb0 + c) : w, ok);
          }
        } else if (v16k) {
          for (int e = tid; e < ncp * (WM_KC / 4); e += blockDim.x) {
            const int c = e / (WM_KC / 4), k = (e % (WM_KC / 4)) * 4;
            const bool ok = k0 + k < K && nb0 + c < Nc;
            wm_cp_async16(dW + c * WM_LDW + k,
                          ok ? w + (k0 + k) + (size_t)(nb0 + c) * wc : w, ok);
          }
        } else if (wc == 1) {  // neighbouring columns neighbouring in memory
          for (int e = tid; e < WM_KC * ncp; e += blockDim.x) {
            const int k = e / ncp, c = e - k * ncp;
            const bool ok = k0 + k < K && nb0 + c < Nc;
            wm_cp_async4(dW + c * WM_LDW + k,
                         ok ? w + (size_t)(k0 + k) * wk + (nb0 + c) : w, ok);
          }
        } else {  // neighbouring k neighbouring in memory (wk == 1)
          for (int e = tid; e < ncp * WM_KC; e += blockDim.x) {
            const int c = e / WM_KC, k = e - c * WM_KC;
            const bool ok = k0 + k < K && nb0 + c < Nc;
            wm_cp_async4(
                dW + c * WM_LDW + k,
                ok ? w + (size_t)(k0 + k) * wk + (size_t)(nb0 + c) * wc : w,
                ok);
          }
        }
        wm_cp_commit();
        float* dA = sA + b * WM_ABUF;
        for (int e = tid; e < MT * 16 * WM_KC; e += blockDim.x) {
          const int r = e / WM_KC, k = e - r * WM_KC;
          const float v = (r < M && k0 + k < K) ? A[r * lda + k0 + k] : 0.f;
          if (bf) {
            ((__nv_bfloat16*)dA)[r * WM_LDB + k] = __float2bfloat16(v);
          } else {
            const uint32_t hi = wm_tf32(v);
            dA[r * WM_LDT + k] = __uint_as_float(hi);
            dA[32 * WM_LDT + r * WM_LDT + k] =
                __uint_as_float(wm_tf32(v - __uint_as_float(hi)));
          }
        }
      };

      load(0, 0);
      for (int kt = 0; kt < nk; ++kt) {
        const int b = kt & 1;
        if (kt + 1 < nk) {
          load(kt + 1, b ^ 1);
          wm_cp_wait<1>();
        } else {
          wm_cp_wait<0>();
        }
        __syncthreads();  // tile kt is in place for every warp
        const float* tW = sW + b * WM_WBUF;
        const float* tA = sA + b * WM_ABUF;
        if (bf) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT)
              wm_ldmatrix_x4(a[m], (const __nv_bfloat16*)tA +
                                       (m * 16 + lrow) * WM_LDB + lhalf * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int nt = warp + 8 * j;
            if (nt >= ntiles) continue;
            const float* wp = tW + (nt * 8 + g) * sn + 2 * tg * sk;
            const uint32_t b0 = gt_bf16x2(wp[0], wp[sk]);
            const uint32_t b1 = gt_bf16x2(wp[8 * sk], wp[9 * sk]);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (m < MT) wm_mma_bf16(acc[j][m], a[m], b0, b1);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < WM_KC; ks += 8) {
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (m < MT) {
                const float* p = tA + (m * 16 + lrow) * WM_LDT + ks + lhalf * 4;
                wm_ldmatrix_x4(ah[m], p);
                wm_ldmatrix_x4(al[m], p + 32 * WM_LDT);
              }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int nt = warp + 8 * j;
              if (nt >= ntiles) continue;
              const float* wp = tW + (nt * 8 + g) * sn + (ks + tg) * sk;
              const float w0 = wp[0], w1 = wp[4 * sk];
              const uint32_t h0 = wm_tf32(w0), h1 = wm_tf32(w1);
              const uint32_t l0 = wm_tf32(w0 - __uint_as_float(h0));
              const uint32_t l1 = wm_tf32(w1 - __uint_as_float(h1));
#pragma unroll
              for (int m = 0; m < 2; ++m)
                if (m < MT) {
                  wm_mma_tf32(acc[j][m], al[m], h0, h1);
                  wm_mma_tf32(acc[j][m], ah[m], l0, l1);
                  wm_mma_tf32(acc[j][m], ah[m], h0, h1);
                }
            }
          }
        }
        __syncthreads();  // every warp is done with buffer b
      }

      // epilogue: C fragment rows g and g + 8, columns 2tg and 2tg + 1
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + 8 * j;
        if (nt >= ntiles) continue;
        const int c = nb0 + nt * 8 + 2 * tg;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m >= MT) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m * 16 + g + (e >> 1) * 8, cc = c + (e & 1);
            if (r < M && cc < Nc) epi(r, cc, acc[j][m][e]);
          }
        }
      }
    }
  }
};

// ------------------------------------------------ split-K weight products
// Of K6, K8w/K8ws, K10w, K12 and K14w: out[m][n] = sum over rows of
// A[row][m] * B[row][n] (m < M1, n < N1), the rows cut into splits.  Each
// block takes one 64 x 64 output tile over one split's rows and writes its
// own partial tile; a second pass sums the partials in split order (no float
// atomics: runs repeat bit for bit).  The products run on the tensor cores:
// with bf16 operands (stored in bf16, or f32 rounded to bf16 unless `exact`)
// mma.sync m16n8k16, with exact f32 operands 3xTF32 m16n8k8, as WdMmaGemm.
// A block of 8 warps stages WG_BK rows of both operands in f32, each warp
// taking 16 x 32 of the tile from the staged rows, while the next rows are
// read into registers.  The products are bound by the operands' bytes and
// the loads' latency, not by the tensor cores, so what counts is loads in
// flight: at most 80 registers (3 blocks an SM) and splits of ~WG_SPLIT_ROWS
// rows.  (A 4-warp block prefetching 32 rows, 253 registers and 2 blocks an
// SM, ran K12's products 2.7x slower than the CUDA-core kernel; PERF.md,
// PR 8.)
#define WD_SPLIT_BLOCKS 264  // blocks of a split-K product: 2 per SM
#define WG_SPLIT_ROWS 160    // rows a split, where that gives more blocks
#define WG_TILE 64           // output tile edge
#define WG_BK 16             // rows a staged chunk
#define WG_PER (WG_BK * WG_TILE / 256)  // values a thread stages per operand

struct WdOperand {
  const void* p;
  int bf16;
  int ld;     // elements per row
  int off;    // first column
  int exact;  // f32 values as they are (float32 products)
};

__device__ __forceinline__ float wd_load(const WdOperand& o, int r, int c) {
  const size_t e = (size_t)r * o.ld + o.off + c;
  if (o.bf16) return __bfloat162float(((const __nv_bfloat16*)o.p)[e]);
  const float v = ((const float*)o.p)[e];
  return o.exact ? v : gt_bfr(v);
}

template <bool BF>
__global__ void __launch_bounds__(256, 3)
wd_wgrad_mma_kernel(WdOperand A, WdOperand B, int rows, int M1, int N1,
                    int rows_per_split, float* part) {
  // staged rows [WG_BK][LD]: fragment reads free of bank conflicts (rows 2t
  // apart for bf16, t apart for TF32)
  constexpr int LD = BF ? WG_TILE + 4 : WG_TILE + 8;
  __shared__ __align__(16) float sA[WG_BK * LD];
  __shared__ __align__(16) float sB[WG_BK * LD];
  const int tilesM = (M1 + WG_TILE - 1) / WG_TILE;
  const int m0 = (blockIdx.x % tilesM) * WG_TILE;
  const int n0 = (blockIdx.x / tilesM) * WG_TILE;
  const int rbeg = blockIdx.y * rows_per_split;
  const int rend = min(rows, rbeg + rows_per_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;  // the warp's part
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float ra[WG_PER], rb[WG_PER];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < WG_PER; ++i) {
      const int e = tid + 256 * i, k = e / WG_TILE, c = e % WG_TILE;
      const int r = r0 + k;
      ra[i] = (r < rend && m0 + c < M1) ? wd_load(A, r, m0 + c) : 0.f;
      rb[i] = (r < rend && n0 + c < N1) ? wd_load(B, r, n0 + c) : 0.f;
    }
  };
  if (rbeg < rend) fetch(rbeg);
  for (int r0 = rbeg; r0 < rend; r0 += WG_BK) {
#pragma unroll
    for (int i = 0; i < WG_PER; ++i) {
      const int e = tid + 256 * i, k = e / WG_TILE, c = e % WG_TILE;
      sA[k * LD + c] = ra[i];
      sB[k * LD + c] = rb[i];
    }
    __syncthreads();
    if (r0 + WG_BK < rend) fetch(r0 + WG_BK);
    if (BF) {
      // A(m, k) = sA[k][m], B(k, n) = sB[k][n]
      const float* pa = sA + 2 * tg * LD + wm + g;
      const uint32_t a[4] = {gt_bf16x2(pa[0], pa[LD]),
                             gt_bf16x2(pa[8], pa[LD + 8]),
                             gt_bf16x2(pa[8 * LD], pa[9 * LD]),
                             gt_bf16x2(pa[8 * LD + 8], pa[9 * LD + 8])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* pb = sB + 2 * tg * LD + wn + nt * 8 + g;
        wm_mma_bf16(acc[nt], a, gt_bf16x2(pb[0], pb[LD]),
                    gt_bf16x2(pb[8 * LD], pb[9 * LD]));
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < WG_BK; ks += 8) {
        const float* pa = sA + (ks + tg) * LD + wm + g;
        uint32_t ah[4], al[4];
        wm_split(pa[0], ah[0], al[0]);
        wm_split(pa[8], ah[1], al[1]);
        wm_split(pa[4 * LD], ah[2], al[2]);
        wm_split(pa[4 * LD + 8], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* pb = sB + (ks + tg) * LD + wn + nt * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          wm_split(pb[0], bh0, bl0);
          wm_split(pb[4 * LD], bh1, bl1);
          wm_mma_tf32(acc[nt], al, bh0, bh1);
          wm_mma_tf32(acc[nt], ah, bl0, bl1);
          wm_mma_tf32(acc[nt], ah, bh0, bh1);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * M1 * N1;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + (e >> 1) * 8;
      const int n = n0 + wn + nt * 8 + 2 * tg + (e & 1);
      if (m < M1 && n < N1) out[(size_t)m * N1 + n] = acc[nt][e];
    }
}

// splits of `rows`: ~WG_SPLIT_ROWS rows each, but enough for
// WD_SPLIT_BLOCKS blocks and no more than 4 * WD_SPLIT_BLOCKS (the partial
// tiles stay a few MB); at least 64 rows each
static inline int wd_splits(int rows, int M1, int N1) {
  const int tiles = ((M1 + WG_TILE - 1) / WG_TILE) *
                    ((N1 + WG_TILE - 1) / WG_TILE);
  int s = (rows + WG_SPLIT_ROWS - 1) / WG_SPLIT_ROWS;
  const int least = (WD_SPLIT_BLOCKS + tiles - 1) / tiles;
  const int cap = (4 * WD_SPLIT_BLOCKS + tiles - 1) / tiles;
  s = s < least ? least : (s > cap ? cap : s);
  const int most = (rows + 63) / 64;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// an operand whose values bf16 holds exactly
static inline bool wd_bf16_valued(const WdOperand& o) {
  return o.bf16 || !o.exact;
}

// out [M1, N1] = A^T B over `rows` rows; split: wd_splits(...) * M1 * N1
// floats of scratch.  bf16 products when both operands are bf16 values,
// else 3xTF32.
static cudaError_t wd_wgrad(WdOperand A, WdOperand B, int rows, int M1,
                            int N1, float* split, float* out,
                            cudaStream_t stream) {
  const int s = wd_splits(rows, M1, N1);
  const int per = (rows + s - 1) / s;
  const dim3 grid(((M1 + WG_TILE - 1) / WG_TILE) *
                      ((N1 + WG_TILE - 1) / WG_TILE),
                  s);
  if (wd_bf16_valued(A) && wd_bf16_valued(B))
    wd_wgrad_mma_kernel<true><<<grid, 256, 0, stream>>>(A, B, rows, M1, N1,
                                                         per, split);
  else
    wd_wgrad_mma_kernel<false><<<grid, 256, 0, stream>>>(A, B, rows, M1, N1,
                                                          per, split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gt_reduce_partials(split, s, M1 * N1, out, stream);
}
