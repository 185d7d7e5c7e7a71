// The forward kernel of the wide K4 and K4tw (wide_fwd.cu), K9w
// (encoder_layer.cu), K5 and K17 past D=32 (stored_fwd.cu) and K13w
// (fused_sampled_fwd.cu), and its layer on the tensor cores for bf16 rows.
//
// One post-norm layer over a block of G whole neighborhoods (<= 32 rows),
// 8 warps; the row-wise steps (attention, LayerNorm, dropout) are
// wd_attention, wd_ln1 and wd_ln2 (wide.cuh): a warp per row, lane l
// holding columns l, l+32, l+64 and l+96.  With bf16 rows of 32 < D <= 80
// the four products (q/k/v, the output projection, both FFN products) run
// on mma.sync m16n8k16 (bf16 operands, f32 accumulation) in wt_fwd_layer:
//
// - Each product's A operand (the block's <= 32 rows x D) is written once,
//   by the step that makes it, into an operand plane in shared memory in
//   bf16, read by ldmatrix.
// - The weights go from L2 straight into the B fragments (4 rows of 8
//   neighbouring values a load, whole 32-byte sectors), with no block
//   barrier between K tiles: in the q/k/v and output projections a warp
//   owns n tiles of 8 columns, in the FFN a group of four warps owns a
//   128-column hidden chunk, so no weight is read twice by a block.
// - FFN: the group computes its chunk 32 hidden columns at a time.  Each
//   warp makes 8 of them, h = drop(relu(y1 W1 + b1)) in its accumulators,
//   with bias, relu, dropout, rounding (and K5's store of h) in registers,
//   into a hidden tile of the group; after a barrier of the group's 128
//   threads each warp adds h W2 for its quarter of the D output columns to
//   a partial it keeps in registers across the chunk.  Two groups run two
//   chunks at once; the partials are added to the FFN output in chunk
//   order.  (Warp pairs, each warp a [32, D/2] partial, needed 128
//   registers and spilled 2.5 KB a thread: K5 took 1.14 ms against the
//   CUDA cores' 1.09 on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md.)
//
// Float32 rows, bf16 rows past D = 80, and K5 up to D = 32 (the other
// kernels take K1's layer there) run wd_fwd_layer on the CUDA cores
// (wd_gemm: FMAs in K order, 4 x 4 register tiles).  Float32 products on
// the tensor cores missed the float32 checks, which hold the output within
// twice the plain float32 version's distance from float64: at K17's
// float32 rows (D=68, rate 0.5) 3xTF32 came out 3.8x and 6.8x, and
// scripts/torch_f32_sum_orders.py shows even correctly rounded products
// 3.4x there, where FMAs in K order, the plain version's own order, hold
// it; nor were they faster than the CUDA cores' tiles.  bf16 products at
// D=128 spread from the plain version by 1.1e-2 and 1.9e-2 relative L2 at
// the quickstart's batch, past check_bf16_spread's 1e-2 (PERF.md).  Up to
// D = 32 K5's q/k/v repeat K1's bit for bit (chip_smoke.check_stored_rows).
#pragma once

#include "wide_mma.cuh"

#define WT_GW 4       // warps of an FFN group, one hidden chunk a group
#define WT_GROUPS (WD_THREADS / 32 / WT_GW)
#define WT_SUB 32     // hidden columns a group makes per step

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

// K tiles of 16 over D
__host__ __device__ inline int wt_kt(int D) { return (D + 15) / 16; }

// bf16 per row of the operand plane: rows 16-byte aligned, ldmatrix free of
// bank conflicts
__host__ __device__ inline int wt_ldb(int D) { return 16 * wt_kt(D) + 8; }

// floats per row of a hidden tile: 8-byte fragment reads free of bank
// conflicts
#define WT_LDH 40

// The forward kernel's layer: wt_fwd_layer for bf16 rows of 32 < D <= 80
// (KT, the K tiles of 16 over D, is 4 or 5), else wd_fwd_layer on the CUDA
// cores (KT = 0)
__host__ __device__ inline int wt_layer_kt(int D, int bf) {
  return (!bf || D <= 32 || D > 80) ? 0 : (wt_kt(D) <= 4 ? 4 : 5);
}

// Shared memory, in floats, before the sampled tags.  wt_fwd_layer: sX,
// sY1, sZ [MP, D]; the operand plane [32, wt_ldb(D)] bf16; one region used
// first by q/k/v [MP, wd_ldq(D)], then by the groups' hidden tiles
// [WT_GROUPS, 2, 32, WT_LDH].  wd_fwd_layer (KT = 0): its layout.
__host__ __device__ inline size_t wt_tag_offset(int G, int S, int D,
                                                int KT) {
  const size_t MP = (size_t)wd_pad(G * S);
  if (KT == 0) return MP * (4 * (size_t)D + wd_ldq(D) + WD_FC);
  size_t U = MP * wd_ldq(D);
  const size_t ht = (size_t)WT_GROUPS * 2 * 32 * WT_LDH;
  if (ht > U) U = ht;
  return 3 * MP * D + 16 * (size_t)wt_ldb(D) + U;
}

__host__ __device__ inline size_t wt_fwd_smem_bytes(int G, int S, int D,
                                                    int bf) {
  return sizeof(float) * wt_tag_offset(G, S, D, wt_layer_kt(D, bf)) +
         sizeof(int) * (size_t)wd_pad(G * S);
}

// the larger of the two: what a caller choosing G for either dtype needs
__host__ __device__ inline size_t wt_fwd_smem_bytes_any(int G, int S, int D) {
  const size_t a = wt_fwd_smem_bytes(G, S, D, 0);
  const size_t b = wt_fwd_smem_bytes(G, S, D, 1);
  return a > b ? a : b;
}

// A fragment of m tile m at K offset k0 from the bf16 operand plane
__device__ __forceinline__ void wt_afrag(uint32_t (&a)[4], const float* sA,
                                         int LB, int m, int k0, int lane) {
  wm_ldmatrix_x4(a, (const __nv_bfloat16*)sA + (m * 16 + (lane & 15)) * LB +
                        k0 + (lane >> 4) * 8);
}

// C[r][c] = sum_{k < K} A[r][k] W(k, c), W(k, c) = bf16(w[k*ldw + c]), for
// rows r < M <= 32 and columns c < Nc; epi(r, c, C[r][c]).
// A is the operand plane (zero past K).  n tiles of 8 columns go to the
// warps in turn, each warp taking both m tiles of its n tile.
template <int KT, class Epi>
__device__ __forceinline__ void wt_gemm(const float* sA, int M, int K,
                                        const float* __restrict__ w, int ldw,
                                        int Nc, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int MT = M > 16 ? 2 : 1, ktv = wt_kt(K), LB = wt_ldb(K);
  const int ntiles = (Nc + 7) / 8;
  for (int nt = warp; nt < ntiles; nt += WD_THREADS / 32) {
    const int c = nt * 8 + g;
    const float* wc = w + (c < Nc ? c : 0);
    auto wv = [&](int k) {
      return (c < Nc && k < K) ? __ldg(wc + (size_t)k * ldw) : 0.f;
    };
    float acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < ktv) {
        const int k = kt * 16 + 2 * tg;
        const uint32_t b0 = gt_bf16x2(wv(k), wv(k + 1));
        const uint32_t b1 = gt_bf16x2(wv(k + 8), wv(k + 9));
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (m < MT) {
            uint32_t a[4];
            wt_afrag(a, sA, LB, m, kt * 16, lane);
            wm_mma_bf16(acc[m], a, b0, b1);
          }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
      if (m < MT)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m * 16 + g + (e >> 1) * 8;
          const int cc = nt * 8 + 2 * tg + (e & 1);
          if (r < M && cc < Nc) epi(r, cc, acc[m][e]);
        }
  }
}

// barrier of the 128 threads of FFN group p (named barrier 1 + p)
__device__ __forceinline__ void wt_group_sync(int p) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(p + 1), "n"(32 * WT_GW) : "memory");
}

// One post-norm layer with bf16 rows (timestep `layer`: its dropout
// streams) over the block's G neighborhoods, whose rows' input the caller
// has put in sX (the first [wd_pad(G*S), D] floats of smem); the operand
// plane is zero past column D (the kernel zeroes it once).  In the last layer (`last`) only
// slot 0 of a neighborhood is a query row and its output goes to res.out;
// otherwise every row is a query row and its output replaces its input in
// sX.  Begins with a barrier.  KT >= wt_kt(D).
template <int KT>
__device__ __forceinline__ void wt_fwd_layer(float* smem, const GtLayer& w,
                                             const GtDrop& dr, int layer,
                                             bool last, const WdLayerRes& res,
                                             int N, int S, int D, int F,
                                             int G, float scale) {
  const int MP = wd_pad(G * S);
  const int D3 = 3 * D, LQ = wd_ldq(D), LB = wt_ldb(D);
  float* sX = smem;             // [MP, D] layer input (f32)
  float* sY1 = sX + MP * D;     // [MP, D] y1 of the query rows
  float* sZ = sY1 + MP * D;     // [MP, D] LN1 input, then the FFN output
  float* sA = sZ + MP * D;      // operand plane [32, LB] bf16
  float* sQKV = sA + 16 * LB;   // [MP, LQ] q/k/v (rounded)
  float* sHt = sQKV;            // then [WT_GROUPS, 2, 32, WT_LDH] hidden tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const WdRows rw(N, S, G, last);
  const int Rv = min(G, N - rw.n0) * S;  // the block's rows
  const int QR = rw.QR;
  const uint32_t kA = gt_stream_key(dr.seed, 4 * layer + 0);
  const uint32_t kO = gt_stream_key(dr.seed, 4 * layer + 1);
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  // operand (r, k) of the next product, rounded to bf16
  auto put = [&](int r, int k, float v) {
    ((__nv_bfloat16*)sA)[r * LB + k] = __float2bfloat16(v);
  };

  __syncthreads();  // sX holds the layer input
  for (int e = tid; e < Rv * D; e += blockDim.x) {
    const int r = e / D;
    put(r, e - r * D, sX[e]);
  }
  __syncthreads();

  // ---- q, k, v of every row
  wt_gemm<KT>(sA, Rv, D, w.w_in, D3, D3, [&](int r, int c, float acc) {
    const float v = acc + w.b_in[c];
    if (res.qkv) res.qkv[(size_t)r * D3 + c] = v;
    sQKV[r * LQ + c] = gt_bfr(v);
  });
  __syncthreads();

  wd_attention(sQKV, LQ, D, rw, scale, dr, kA, 1, res, put);
  __syncthreads();

  // ---- attention output, its dropout and the residual
  wt_gemm<KT>(sA, QR, D, w.w_out, D, D, [&](int q, int c, float acc) {
    sZ[q * D + c] = sX[rw.qr(q) * D + c] +
                    gt_drop(dr, kO, rw.qi(q) * D + c, acc + w.b_out[c]);
  });
  __syncthreads();

  wd_ln1(sZ, sY1, w, D, rw, res, put);
  __syncthreads();

  // ---- FFN: group p takes hidden chunks p, p + WT_GROUPS, ...; warp wi of
  // the group makes hidden columns [8 wi, 8 wi + 8) of each step and owns
  // output n tiles [nt0, nt0 + ntn)
  {
    constexpr int KQ = (2 * KT + WT_GW - 1) / WT_GW;  // most n tiles a warp
    const int grp = warp / WT_GW, wi = warp % WT_GW;
    const int MT = QR > 16 ? 2 : 1, ktv = wt_kt(D);
    const int NT = (D + 7) / 8, NQ = (NT + WT_GW - 1) / WT_GW;
    const int nt0 = wi * NQ, ntn = max(0, min(NQ, NT - nt0));
    const int nch = (F + WD_FC - 1) / WD_FC;
    float* ht0 = sHt + grp * 2 * 32 * WT_LDH;
    for (int r0 = 0; r0 < nch; r0 += WT_GROUPS) {
      const int ch = r0 + grp;
      float acc[2][KQ][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < KQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      if (ch < nch) {
        const int f0 = ch * WD_FC, nf = min(WD_FC, F - f0);
        for (int s = 0; s * WT_SUB < nf; ++s) {
          float* ht = ht0 + (s & 1) * 32 * WT_LDH;
          const int fs = f0 + s * WT_SUB;
          const int col = 8 * wi + 2 * tg;  // this lane's first column
          // h for this warp's 8 columns: one n tile
          const int f = fs + 8 * wi + g;
          auto w1v = [&](int k) {
            return (f < F && k < D) ? __ldg(w.w1 + (size_t)k * F + f) : 0.f;
          };
          auto w2v = [&](int k, int j) {
            const int c = (nt0 + j) * 8 + g;
            return (j < ntn && c < D && fs + k < F)
                       ? __ldg(w.w2 + (size_t)(fs + k) * D + c)
                       : 0.f;
          };
          // the step's weights and biases, all requested before the first
          // is used: one L2 round trip a step, not one a product
          uint32_t bw1[KT][2], bw2[WT_SUB / 16][KQ][2];
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
            if (kt < ktv) {
              const int k = kt * 16 + 2 * tg;
              bw1[kt][0] = gt_bf16x2(w1v(k), w1v(k + 1));
              bw1[kt][1] = gt_bf16x2(w1v(k + 8), w1v(k + 9));
            }
#pragma unroll
          for (int s16 = 0; s16 < WT_SUB / 16; ++s16)
#pragma unroll
            for (int j = 0; j < KQ; ++j) {
              const int k = s16 * 16 + 2 * tg;
              bw2[s16][j][0] = gt_bf16x2(w2v(k, j), w2v(k + 1, j));
              bw2[s16][j][1] = gt_bf16x2(w2v(k + 8, j), w2v(k + 9, j));
            }
          float bias[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            bias[i] = fs + col + i < F ? w.b1[fs + col + i] : 0.f;
          float hacc[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[m][e] = 0.f;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            if (kt < ktv) {
#pragma unroll
              for (int m = 0; m < 2; ++m)
                if (m < MT) {
                  uint32_t a[4];
                  wt_afrag(a, sA, LB, m, kt * 16, lane);
                  wm_mma_bf16(hacc[m], a, bw1[kt][0], bw1[kt][1]);
                }
            }
          }
          // bias, relu, dropout (K5: store), rounding, into the tile
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int q = m * 16 + g + (e >> 1) * 8;
                const int fe = fs + col + (e & 1);
                float hv = 0.f;
                if (q < QR && fe < F) {
                  hv = gt_drop(dr, kH, rw.qi(q) * (uint32_t)F + fe,
                               fmaxf(hacc[m][e] + bias[e & 1], 0.f));
                  if (res.h)
                    wd_store(res.h, (size_t)q * F + fe, hv, res.h_bf16);
                  hv = gt_bfr(hv);
                }
                ht[q * WT_LDH + col + (e & 1)] = hv;
              }
          wt_group_sync(grp);  // the group's tile is whole
          // out[:, this warp's n tiles] += h W2[fs .. fs + 32, :]
#pragma unroll
          for (int kk = 0; kk < WT_SUB; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (m < MT) {
                const float* p = ht + (m * 16 + g) * WT_LDH + kk + 2 * tg;
                const float2 v0 = *(const float2*)p;
                const float2 v1 = *(const float2*)(p + 8 * WT_LDH);
                const float2 v2 = *(const float2*)(p + 8);
                const float2 v3 = *(const float2*)(p + 8 * WT_LDH + 8);
                a[m][0] = gt_bf16x2(v0.x, v0.y);
                a[m][1] = gt_bf16x2(v1.x, v1.y);
                a[m][2] = gt_bf16x2(v2.x, v2.y);
                a[m][3] = gt_bf16x2(v3.x, v3.y);
              }
#pragma unroll
            for (int j = 0; j < KQ; ++j)
              if (j < ntn)
#pragma unroll
                for (int m = 0; m < 2; ++m)
                  if (m < MT)
                    wm_mma_bf16(acc[m][j], a[m], bw2[kk / 16][j][0],
                                bw2[kk / 16][j][1]);
          }
        }
      }
      // the chunks' partials into the FFN output, in chunk order
      for (int p = 0; p < WT_GROUPS; ++p) {
        if (grp == p && ch < nch) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT)
#pragma unroll
              for (int j = 0; j < KQ; ++j)
                if (j < ntn)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int q = m * 16 + g + (e >> 1) * 8;
                    const int c = (nt0 + j) * 8 + 2 * tg + (e & 1);
                    if (q < QR && c < D) sZ[q * D + c] += acc[m][j][e];
                  }
        }
        __syncthreads();
      }
    }
  }

  wd_ln2(sX, sY1, sZ, w, D, rw, dr, kZ, res);
}

// T layers over the block's G neighborhoods: layer 0's input sampled from
// the codebook (K5, K13w) or loaded from rows (the others); per layer the
// saved input (K4tw, K5, K13w, K17), the residuals (K5, K17) and, with
// rows_out (K9w), every row of the last layer.  KT = wt_layer_kt(D, bf16
// rows): 0, wd_fwd_layer on the CUDA cores; else wt_fwd_layer<KT>.  Two
// blocks an SM.
template <int KT>
__global__ void __launch_bounds__(WD_THREADS, 2)
wd_encoder_fwd_kernel(WdFwdIO io, GtStack st, GtDrop dr, int N, int S, int D,
                      int F, int T, int G, float scale, int mmbf,
                      int sampled) {
  extern __shared__ float smem[];
  const int MP = wd_pad(G * S);
  const int D3 = 3 * D, SW = 4 * D + 2;
  float* sX = smem;  // [MP, D] layer input; the layer's layout follows
  float* sA = smem + 3 * MP * D;
  int* sTag = (int*)(smem + wt_tag_offset(G, S, D, KT));

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * G;   // the block's first neighborhood
  const int Gv = min(G, N - n0);   // its neighborhoods
  const int Rv = Gv * S;           // its rows
  const size_t row0 = (size_t)n0 * S;
  const size_t NS = (size_t)N * S;
  const size_t hsz = io.h_bf16 ? 2 : 4;  // bytes of a stored hidden value

  // wt_fwd_layer's operand plane: zero past column D from here on
  if (KT > 0)
    for (int e = tid; e < 16 * wt_ldb(D); e += blockDim.x)
      sA[e] = 0.f;

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
    if constexpr (KT == 0)
      wd_fwd_layer(smem, gt_layer_at(st, t, D, F), dr, io.t0 + t, last, res,
                   N, S, D, F, G, scale, mmbf);
    else
      wt_fwd_layer<KT>(smem, gt_layer_at(st, t, D, F), dr, io.t0 + t, last,
                       res, N, S, D, F, G, scale);
  }
  if (io.rows_out) {
    __syncthreads();
    for (int e = tid; e < Rv * D; e += blockDim.x)
      wd_store(io.rows_out, row0 * D + e, sX[e], io.x_bf16);
  }
}

template <int KT>
static cudaError_t wt_launch_fwd(const WdFwdIO& io, const GtStack& st,
                                 const GtDrop& dr, int N, int S, int D, int F,
                                 int T, int G, float scale, int mmbf,
                                 int sampled, cudaStream_t stream) {
  const size_t smem = wt_fwd_smem_bytes(G, S, D, mmbf);
  cudaError_t e = cudaFuncSetAttribute(
      wd_encoder_fwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + G - 1) / G;
  wd_encoder_fwd_kernel<KT><<<blocks, WD_THREADS, smem, stream>>>(
      io, st, dr, N, S, D, F, T, G, scale, mmbf, sampled);
  return cudaGetLastError();
}

// The kernel of the layer wt_layer_kt(D, mmbf) picks.
static inline cudaError_t wd_launch_fwd(const WdFwdIO& io, const GtStack& st,
                                        const GtDrop& dr, int N, int S, int D,
                                        int F, int T, int G, float scale,
                                        int mmbf, int sampled,
                                        cudaStream_t stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32 || T < 1)
    return cudaErrorInvalidValue;
  switch (wt_layer_kt(D, mmbf)) {
    case 4:
      return wt_launch_fwd<4>(io, st, dr, N, S, D, F, T, G, scale, mmbf,
                              sampled, stream);
    case 5:
      return wt_launch_fwd<5>(io, st, dr, N, S, D, F, T, G, scale, mmbf,
                              sampled, stream);
    default:
      return wt_launch_fwd<0>(io, st, dr, N, S, D, F, T, G, scale, mmbf,
                              sampled, stream);
  }
}
