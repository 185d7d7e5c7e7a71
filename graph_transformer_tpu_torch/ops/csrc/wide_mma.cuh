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
// later work.  The second half of this file is the split-K weight
// products' kernel (wd_products), with its own notes.
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
// Of K6, K8w/K8ws, K10w, K12 and K14w: out[m1][n1] = sum over rows of
// A[row][m1] * B[row][n1], several such products in one launch (a batch:
// the wide backward's four, K12's two).  Each product is oriented so that
// its wider operand `a` gives the output tile's 64 rows (M) and the other,
// `b`, up to 128 columns (N: D <= 128, the whole of it in one tile), and
// its rows are cut into splits.  A block takes one output tile over one
// split's rows and writes its own partial tile; a second launch sums every
// product's partials in split order and writes them in place (transposed
// where the orientation swapped the operands).  No float atomics: runs
// repeat bit for bit, and the splits depend on the shapes alone, so K14w
// repeats the K8w chain.
//
// Their bound is their operands' bytes (the hidden h and dhpre are
// [rows, F]).  A block stages a ring of WG_STAGES chunks of WG_BK rows of
// both operands, copied raw (bf16 or f32, as they are stored) into shared
// memory by cp.async (16, 8 or 4 bytes a copy, as the operand's alignment
// allows; element by element for bf16 rows of odd width), one barrier a
// chunk, while 8 warps run the chunk that has landed on the tensor cores:
// bf16 operands through ldmatrix.trans into mma.sync m16n8k16 (f32 values
// rounded to bf16 when they are not `exact`), exact f32 operands as 3xTF32
// m16n8k8 (WdMmaGemm's split).  Warp w takes the tile's rows 16 (w % 4) ..
// +16 and every other n8 column tile from w / 4.  Splits: at most
// WG_BLOCKS blocks a batch (one wave, 2 an SM), each over about as many
// rows, at least WG_MIN_ROWS.  Blocks an SM, not the ring's depth, set the
// speed on the H100: 3 stages run as fast as 4, one block an SM (6 stages,
// or 64-row chunks) up to 1.7x slower (scripts/torch_wgrad_variants.py).
#define WG_BM 64          // output tile rows (the `a` side)
#define WG_BN 128         // most output tile columns (the `b` side)
#define WG_BK 32          // rows of the sum a staged chunk
#define WG_STAGES 4       // chunks in the ring
#define WG_LDA (WG_BM + 8)   // elements a staged `a` row
#define WG_LDB (WG_BN + 8)   // elements a staged `b` row
#define WG_B_OFF (4 * WG_BK * WG_LDA)             // bytes: `b` in a stage
#define WG_STAGE_BYTES (WG_B_OFF + 4 * WG_BK * WG_LDB)
#define WG_SMEM_BYTES (WG_STAGES * WG_STAGE_BYTES)  // 104 KB
#define WG_BLOCKS 264     // blocks a batch aims at: 2 an SM
#define WG_MIN_ROWS 128   // fewest rows a split
#define WG_MAX 4          // products a batch

struct WdOperand {
  const void* p;
  int bf16;
  int ld;     // elements per row
  int off;    // first column
  int exact;  // f32 values as they are (float32 products)
};

// an operand as the product kernel reads it
struct WgSide {
  const char* p;  // first column of row 0
  int bf16, ld, exact;
  int vec;        // bytes a copy: 16, 8, 4, or 2 (element by element)
};

struct WgProduct {
  WgSide a, b;    // a [rows, M], b [rows, N]
  int rows, M, N, tilesM, tilesN, splits, per, trans;
  int blk0;       // the product's first block in the launch
  float* part;    // [splits, M, N] partial tiles
  float* out;     // [M, N], or [N, M] where trans
};

struct WgBatch {
  WgProduct p[WG_MAX];
  int n, blocks, outs;  // products, blocks, output values
};

// the small per-block partials of the wide backward (wd_bwd_body), summed
// in block order into their places in the flat gradient vector by the
// products' reduction launch (none where part is null)
// per-block partial sums of the wide backward's small gradients, in this
// order: [b_in 3D | b_out g1 c1 3D | b1 F | b2 g2 c2 3D]
__host__ __device__ inline int wd_small_width(int D, int F) {
  return 9 * D + F;
}

struct WgSmall {
  const float* part;
  int nblk, D, F;
  GtGradOff o;
  float* grads;
};

__device__ __forceinline__ void wm_ldmatrix_x4_trans(uint32_t (&r)[4],
                                                     const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wm_smem_addr(p)));
}

// asynchronous copy of `bytes` <= V bytes from src, zero-filling the rest
template <int V>
__device__ __forceinline__ void wg_cp_async(void* dst, const void* src,
                                            int bytes) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     wm_smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     wm_smem_addr(dst)),
                 "l"(src), "n"(V), "r"(bytes));
}

// One thread's share of the copies of an operand's staged tile: one
// vector of `vec` bytes (column c0 + cv*vec/es) of rows k0, k0 + step, ...
// of each chunk; set once a block, as the columns are the same in every
// chunk.  Columns past the operand's are zero-filled (bytes < vec).
struct WgCopy {
  const char* src;  // the vector's first byte in row 0
  size_t ldb;       // bytes a row
  int bytes, vec, k0, step, dst;  // dst: the vector's byte in a staged row
};

__device__ __forceinline__ WgCopy wg_copy_plan(const WgSide& o, int c0,
                                               int cols, int width) {
  const int es = o.bf16 ? 2 : 4;
  const int per_row = width * es / o.vec;  // <= 256
  const int cv = threadIdx.x % per_row, col = c0 + cv * (o.vec / es);
  WgCopy c;
  c.src = o.p + (size_t)col * es;
  c.ldb = (size_t)o.ld * es;
  c.bytes = col < cols ? min(o.vec, (cols - col) * es) : 0;
  c.vec = o.vec;
  c.step = blockDim.x / per_row;
  c.k0 = threadIdx.x / per_row;  // >= step: no share
  c.dst = cv * o.vec;
  return c;
}

// Copies rows r0 .. r0 + WG_BK of the thread's vector (zero from rend on)
// into a staged tile of `lds` bytes a row.
template <int V>
__device__ __forceinline__ void wg_copy_v(char* dst, const WgCopy& c,
                                          const char* base, int r0, int rend,
                                          int lds) {
  if (c.k0 >= c.step) return;
  for (int k = c.k0; k < WG_BK; k += c.step) {
    const int r = r0 + k;
    const int bytes = r < rend ? c.bytes : 0;
    const char* src = bytes ? c.src + (size_t)r * c.ldb : base;
    char* d = dst + k * lds + c.dst;
    if constexpr (V == 2)
      *(uint16_t*)d = bytes ? *(const uint16_t*)src : (uint16_t)0;
    else
      wg_cp_async<V>(d, src, bytes);
  }
}

__device__ __forceinline__ void wg_copy(char* dst, const WgCopy& c,
                                        const char* base, int r0, int rend,
                                        int lds) {
  switch (c.vec) {
    case 16: wg_copy_v<16>(dst, c, base, r0, rend, lds); break;
    case 8: wg_copy_v<8>(dst, c, base, r0, rend, lds); break;
    case 4: wg_copy_v<4>(dst, c, base, r0, rend, lds); break;
    default: wg_copy_v<2>(dst, c, base, r0, rend, lds);
  }
}

// staged value (k, c) of an operand as the 3xTF32 products take it
__device__ __forceinline__ float wg_val(const WgSide& o, const char* s, int k,
                                        int c, int ld) {
  const size_t e = (size_t)k * ld + c;
  if (o.bf16) return __bfloat162float(((const __nv_bfloat16*)s)[e]);
  const float v = ((const float*)s)[e];
  return o.exact ? v : gt_bfr(v);
}

// two staged f32 values (k, c), (k + 1, c) as one bf16 pair
__device__ __forceinline__ uint32_t wg_pair(const char* s, int k, int c,
                                            int ld) {
  const float* f = (const float*)s + (size_t)k * ld + c;
  return gt_bf16x2(f[0], f[ld]);
}

// BF: bf16 products (both operands hold bf16 values), else 3xTF32
template <bool BF>
__global__ void __launch_bounds__(256, 2) wd_wgrad_mma_kernel(WgBatch bt) {
  extern __shared__ __align__(16) char wg_smem[];
  WgProduct P = bt.p[0];
#pragma unroll
  for (int i = 1; i < WG_MAX; ++i)
    if (i < bt.n && (int)blockIdx.x >= bt.p[i].blk0) P = bt.p[i];
  const int local = blockIdx.x - P.blk0;
  const int tiles = P.tilesM * P.tilesN;
  const int split = local / tiles, t = local - split * tiles;
  const int m0 = (t % P.tilesM) * WG_BM, n0 = (t / P.tilesM) * WG_BN;
  const int rbeg = split * P.per, rend = min(P.rows, rbeg + P.per);
  const int nch = rend > rbeg ? (rend - rbeg + WG_BK - 1) / WG_BK : 0;
  const int ntn = (min(WG_BN, P.N - n0) + 7) / 8;  // n8 tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp & 3) * 16, h = warp >> 2;
  const bool live = m0 + wm < P.M;  // the warp's rows hold outputs
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const WgCopy ca = wg_copy_plan(P.a, m0, P.M, WG_BM);
  const WgCopy cb = wg_copy_plan(P.b, n0, P.N, ntn * 8);
  const int lda_b = WG_LDA * (P.a.bf16 ? 2 : 4);  // bytes a staged row
  const int ldb_b = WG_LDB * (P.b.bf16 ? 2 : 4);
  auto load = [&](int c) {
    char* sa = wg_smem + (c % WG_STAGES) * WG_STAGE_BYTES;
    const int r0 = rbeg + c * WG_BK;
    wg_copy(sa, ca, P.a.p, r0, rend, lda_b);
    wg_copy(sa + WG_B_OFF, cb, P.b.p, r0, rend, ldb_b);
  };
#pragma unroll
  for (int c = 0; c < WG_STAGES - 1; ++c) {
    if (c < nch) load(c);
    wm_cp_commit();
  }
  for (int c = 0; c < nch; ++c) {
    wm_cp_wait<WG_STAGES - 2>();
    __syncthreads();  // chunk c is in place; chunk c - 1's buffer is free
    if (c + WG_STAGES - 1 < nch) load(c + WG_STAGES - 1);
    wm_cp_commit();
    if (!live) continue;
    const char* sa = wg_smem + (c % WG_STAGES) * WG_STAGE_BYTES;
    const char* sb = sa + WG_B_OFF;
    if constexpr (BF) {
#pragma unroll
      for (int ks = 0; ks < WG_BK; ks += 16) {
        uint32_t a[4];
        if (P.a.bf16) {
          // matrices (k lo, m), (k lo, m + 8), (k hi, m), (k hi, m + 8)
          wm_ldmatrix_x4_trans(
              a, (const __nv_bfloat16*)sa +
                     (ks + (lane & 7) + ((lane >> 4) << 3)) * WG_LDA + wm +
                     (((lane >> 3) & 1) << 3));
        } else {
          const int k = ks + 2 * tg, m = wm + g;
          a[0] = wg_pair(sa, k, m, WG_LDA);
          a[1] = wg_pair(sa, k, m + 8, WG_LDA);
          a[2] = wg_pair(sa, k + 8, m, WG_LDA);
          a[3] = wg_pair(sa, k + 8, m + 8, WG_LDA);
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int t0 = 2 * j + h;  // n8 tile of slot j; t0 + 2 of j + 1
          if (t0 >= ntn) break;
          uint32_t b[4];
          if (P.b.bf16) {
            // matrices (k lo, t0), (k hi, t0), (k lo, t0 + 2), (k hi, t0 + 2)
            const int mi = lane >> 3;
            wm_ldmatrix_x4_trans(
                b, (const __nv_bfloat16*)sb +
                       (ks + (lane & 7) + ((mi & 1) << 3)) * WG_LDB +
                       (t0 + ((mi >> 1) << 1)) * 8);
          } else {
            const int k = ks + 2 * tg, n = t0 * 8 + g;
            b[0] = wg_pair(sb, k, n, WG_LDB);
            b[1] = wg_pair(sb, k + 8, n, WG_LDB);
            b[2] = wg_pair(sb, k, n + 16, WG_LDB);
            b[3] = wg_pair(sb, k + 8, n + 16, WG_LDB);
          }
          wm_mma_bf16(acc[j], a, b[0], b[1]);
          if (t0 + 2 < ntn) wm_mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < WG_BK; ks += 8) {
        const int k = ks + tg, m = wm + g;
        uint32_t ah[4], al[4];
        wm_split(wg_val(P.a, sa, k, m, WG_LDA), ah[0], al[0]);
        wm_split(wg_val(P.a, sa, k, m + 8, WG_LDA), ah[1], al[1]);
        wm_split(wg_val(P.a, sa, k + 4, m, WG_LDA), ah[2], al[2]);
        wm_split(wg_val(P.a, sa, k + 4, m + 8, WG_LDA), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int tn = 2 * j + h;
          if (tn >= ntn) break;
          uint32_t bh0, bl0, bh1, bl1;
          wm_split(wg_val(P.b, sb, k, tn * 8 + g, WG_LDB), bh0, bl0);
          wm_split(wg_val(P.b, sb, k + 4, tn * 8 + g, WG_LDB), bh1, bl1);
          wm_mma_tf32(acc[j], al, bh0, bh1);
          wm_mma_tf32(acc[j], ah, bl0, bl1);
          wm_mma_tf32(acc[j], ah, bh0, bh1);
        }
      }
    }
  }
  if (!live) return;
  float* out = P.part + (size_t)split * P.M * P.N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int tn = 2 * j + h;
    if (tn >= ntn) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + (e >> 1) * 8;
      const int n = n0 + tn * 8 + 2 * tg + (e & 1);
      if (m < P.M && n < P.N) out[(size_t)m * P.N + n] = acc[j][e];
    }
  }
}

// The second launch: each product's partial tiles summed in split order
// into its output, then the small partials (if any) in block order.
__global__ void wd_wgrad_reduce_kernel(WgBatch bt, WgSmall sm) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < WG_MAX; ++q) {
    if (q >= bt.n) break;
    const WgProduct& P = bt.p[q];
    const int MN = P.M * P.N;
    if (i < MN) {
      float s = 0.f;
      for (int k = 0; k < P.splits; ++k) s += P.part[(size_t)k * MN + i];
      const int m = i / P.N, n = i - m * P.N;
      P.out[P.trans ? (size_t)n * P.M + m : (size_t)i] = s;
      return;
    }
    i -= MN;
  }
  if (!sm.part) return;
  const int PS = wd_small_width(sm.D, sm.F);
  if (i >= PS) return;
  float s = 0.f;
  for (int b = 0; b < sm.nblk; ++b) s += sm.part[(size_t)b * PS + i];
  const int D = sm.D, F = sm.F;
  int off;
  if (i < 3 * D) off = sm.o.b_in + i;
  else if (i < 6 * D) off = sm.o.b_out + (i - 3 * D);
  else if (i < 6 * D + F) off = sm.o.b1 + (i - 6 * D);
  else off = sm.o.b2 + (i - 6 * D - F);
  sm.grads[off] = s;
}

// an operand whose values bf16 holds exactly
static inline bool wd_bf16_valued(const WdOperand& o) {
  return o.bf16 || !o.exact;
}

// one product of a batch: out [M1, N1] = A^T B over `rows` rows
struct WdProductSpec {
  WdOperand A, B;
  int rows, M1, N1;
  float* out;
};

static inline WgSide wg_side(const WdOperand& o) {
  const int es = o.bf16 ? 2 : 4;
  WgSide s{(const char*)o.p + (size_t)o.off * es, o.bf16, o.ld, o.exact, 2};
  for (int v = 16; v >= 4; v /= 2)
    if ((uintptr_t)s.p % v == 0 && ((size_t)o.ld * es) % v == 0) {
      s.vec = v;
      break;
    }
  return s;
}

// Orients the products, sets their splits and places their partial tiles
// in `split` (null: sizes only); returns the floats of scratch they need.
// The splits depend on the shapes alone.
static size_t wd_plan(const WdProductSpec* ps, int n, float* split,
                      WgBatch* bt) {
  // rows a block: the batch's tile-rows over WG_BLOCKS, so that products
  // over fewer rows (the slot-0 layer's) take fewer splits
  double work = 0.0;
  for (int q = 0; q < n; ++q) {
    const int M = ps[q].M1 >= ps[q].N1 ? ps[q].M1 : ps[q].N1;
    const int N = ps[q].M1 >= ps[q].N1 ? ps[q].N1 : ps[q].M1;
    work += (double)ps[q].rows * ((M + WG_BM - 1) / WG_BM) *
            ((N + WG_BN - 1) / WG_BN);
  }
  const double per_block = work / WG_BLOCKS;
  size_t floats = 0;
  bt->n = n;
  bt->blocks = bt->outs = 0;
  for (int q = 0; q < n; ++q) {
    const WdProductSpec& s = ps[q];
    WgProduct& P = bt->p[q];
    P.trans = s.M1 < s.N1;
    P.a = wg_side(P.trans ? s.B : s.A);
    P.b = wg_side(P.trans ? s.A : s.B);
    P.M = P.trans ? s.N1 : s.M1;
    P.N = P.trans ? s.M1 : s.N1;
    P.rows = s.rows;
    P.tilesM = (P.M + WG_BM - 1) / WG_BM;
    P.tilesN = (P.N + WG_BN - 1) / WG_BN;
    const int most = (s.rows + WG_MIN_ROWS - 1) / WG_MIN_ROWS;
    const int want = per_block > 0.0 ? (int)(s.rows / per_block) : 1;
    P.splits = want < most ? want : most;
    if (P.splits < 1) P.splits = 1;
    P.per = (s.rows + P.splits - 1) / P.splits;
    P.blk0 = bt->blocks;
    bt->blocks += P.splits * P.tilesM * P.tilesN;
    bt->outs += P.M * P.N;
    P.part = split ? split + floats : nullptr;
    P.out = s.out;
    floats += (size_t)P.splits * P.M * P.N;
  }
  return floats;
}

static inline size_t wd_products_split_floats(const WdProductSpec* ps,
                                              int n) {
  WgBatch bt;
  return wd_plan(ps, n, nullptr, &bt);
}

// The batch's products (bf16 products where every operand holds bf16
// values, else 3xTF32), then one reduction of their partials and of the
// small partials `sm` (sm.part null: none).  split: wd_products_split_floats
// floats of scratch.
static cudaError_t wd_products(const WdProductSpec* ps, int n, float* split,
                               const WgSmall& sm, cudaStream_t stream) {
  if (n < 1 || n > WG_MAX) return cudaErrorInvalidValue;
  WgBatch bt;
  wd_plan(ps, n, split, &bt);
  bool bf = true;
  for (int q = 0; q < n; ++q)
    bf = bf && wd_bf16_valued(ps[q].A) && wd_bf16_valued(ps[q].B);
  const void* k = bf ? (const void*)wd_wgrad_mma_kernel<true>
                     : (const void*)wd_wgrad_mma_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (bf)
    wd_wgrad_mma_kernel<true><<<bt.blocks, 256, WG_SMEM_BYTES, stream>>>(bt);
  else
    wd_wgrad_mma_kernel<false><<<bt.blocks, 256, WG_SMEM_BYTES, stream>>>(bt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int total =
      bt.outs + (sm.part ? wd_small_width(sm.D, sm.F) : 0);
  wd_wgrad_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(bt, sm);
  return cudaGetLastError();
}

// one product alone: out [M1, N1] = A^T B over `rows` rows
static cudaError_t wd_wgrad(WdOperand A, WdOperand B, int rows, int M1,
                            int N1, float* split, float* out,
                            cudaStream_t stream) {
  const WdProductSpec p{A, B, rows, M1, N1, out};
  return wd_products(&p, 1, split, WgSmall{}, stream);
}
