// K18 — a tiled matrix product with fused epilogues, the products of the
// encoder layer past D = 128 (ops/rows_encoder.py).
//
// Stands in, past D = 128, for the products inside the TPU kernels
// graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (:266, call :429) and
// _bwd1_kernel (:316, call :361), ops/pallas_encoder.py:_fwd_kernel (:196,
// call :355) and _bwd_kernel (:214, call :386), ops/pallas_ffn.py:_fwd_kernel
// (:70, call :250) and _bwd_kernel (:97, call :274): the Q/K/V, output and
// FFN products of the forward, the row products of the backward (A Bᵀ) and
// the weight gradients (Aᵀ B over all rows).  The TPU kernels hold a whole
// layer in VMEM; at D = 1,433 a layer's rows do not fit a block's shared
// memory, so the layer runs as products (this kernel), the neighborhood
// attention (K19, rows_attention.cu) and the residual LayerNorm (K20,
// rows_ln.cu), with the intermediates in device memory.
//
// C[M, N] = op(A) op(B), A(m, k) = a[m*sam + k*sak], B(k, n) = b[k*sbk +
// n*sbn].  Float32 products (float32 operands) run on the CUDA cores
// (rg_f32_kernel: 128 x 128 tiles through a cp.async ring, 8 x 8 outputs a
// thread); bf16 products take float32 or bf16 operands, round them to bf16
// as they are staged and run mma.sync m16n8k16 with f32 sums
// (rg_bf16_kernel: 128 x 128 tiles, 32 of K a step, 8 warps of 64 x 32).  The epilogue, in the plain version's order: + bias[n], ReLU,
// dropout of the [M, N] output at (seed, stream), x (gate > 0) / gate_keep,
// + add (rows m % add_every == 0 read add row m / add_every).  The weight
// gradients split K (all rows) into a fixed number of chunks, each block
// writing its chunk's partial tile, then rg_reduce_kernel sums the chunks in
// chunk order: no float atomics, so runs repeat bit for bit.  rg_colsum
// gives the bias gradients (column sums of B) the same way.
//
// Bound on the H100: at Cora's width (14,080 rows, D = 1,433, F = 1,024) the
// products are operations-bound (the Q/K/V product: 1.73e11 FLOP on 323 MB,
// 2.59 ms at 67 TFLOP/s float32 against 0.10 ms of bytes).  This first
// design runs the CUDA cores' FMAs at about half that rate (PERF.md, PR 16:
// the register-staged tiles it replaced ran at a third); warp tiling,
// wgmma (bf16) and TMA are later work.
#include "common.cuh"

#define RG_BM 128
#define RG_BN 128
#define RG_THREADS 256
#define RG_BK32 16   // K a step, float32 kernel
#define RG_BK16 32   // K a step, bf16 kernel
#define RG_PADF 4    // float32 tile row padding (keeps float4 alignment)
#define RG_PADH 8    // bf16 tile row padding: conflict-free fragment loads
#define RG_MINB 2    // float32 kernel: blocks an SM (128 registers a thread)
#define RG_STAGES 2  // float32 kernel: tiles in its cp.async ring

struct RgArgs {
  const void* a;
  int a_bf;
  const void* b;
  int b_bf;
  float* c;
  int M, N, K;
  long long sam, sak, sbk, sbn;
  const float* bias;
  int relu;
  const float* gate;
  float gate_inv;
  const float* add;
  int add_every;
  GtDrop dr;
  uint32_t key;
  int kchunk;      // K a z-block takes
  float* partial;  // [chunks, M, N] when the product is split, else null
};

__device__ __forceinline__ float rg_ld(const void* p, int bf, size_t i) {
  if (bf)
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg((const unsigned short*)p + i)));
  return __ldg((const float*)p + i);
}

__device__ __forceinline__ float rg_a(const RgArgs& g, int m, int k, int k1) {
  return (m < g.M && k < k1)
             ? rg_ld(g.a, g.a_bf, (size_t)m * g.sam + (size_t)k * g.sak)
             : 0.f;
}

__device__ __forceinline__ float rg_b(const RgArgs& g, int k, int n, int k1) {
  return (n < g.N && k < k1)
             ? rg_ld(g.b, g.b_bf, (size_t)k * g.sbk + (size_t)n * g.sbn)
             : 0.f;
}

// v rounded to bf16, as its bits
__device__ __forceinline__ unsigned short rg_bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// one output: the partial of a split product, or the epilogue and C
__device__ __forceinline__ void rg_store(const RgArgs& g, int m, int n,
                                         float v) {
  if (m >= g.M || n >= g.N) return;
  const size_t e = (size_t)m * g.N + n;
  if (g.partial) {
    g.partial[(size_t)blockIdx.z * g.M * g.N + e] = v;
    return;
  }
  if (g.bias) v = v + g.bias[n];
  if (g.relu) v = v > 0.f ? v : 0.f;
  if (g.dr.on) v = gt_drop(g.dr, g.key, (uint32_t)e, v);
  if (g.gate) v = v * (g.gate[e] > 0.f ? g.gate_inv : 0.f);
  if (g.add && m % g.add_every == 0)
    v = g.add[(size_t)(m / g.add_every) * g.N + n] + v;
  g.c[e] = v;
}

// ----------------------------------------------------------- float32
// The float32 product: 128 x 128 tiles, 16 of K a step, 8 x 8 outputs a
// thread, the tiles staged by cp.async 4 bytes a copy (the operands' rows,
// of odd width at Cora's D = 1,433, are not 16-byte aligned) in a ring of
// RG_STAGES tiles, out-of-range elements zero-filled: no staging registers,
// so 128 registers a thread and two blocks an SM, and one barrier a step.
__device__ __forceinline__ void rg_cp4(float* dst, const float* src, bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void rg_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void rg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define RG_TILE_F ((RG_BK32) * ((RG_BM) + (RG_PADF)))  // floats a tile

__global__ void __launch_bounds__(RG_THREADS, RG_MINB)
    rg_f32_kernel(const RgArgs g) {
  extern __shared__ __align__(16) float rg_smem[];  // [STAGES][A tile, B tile]
  constexpr int PER = RG_BM * RG_BK32 / RG_THREADS;  // 8
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * RG_BM, n0 = blockIdx.x * RG_BN;
  const int k0 = blockIdx.z * g.kchunk;
  const int k1 = min(g.K, k0 + g.kchunk);
  const bool ak = g.sak == 1, bn = g.sbn == 1;
  const float* A = (const float*)g.a;
  const float* B = (const float*)g.b;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto issue = [&](int kb, int stage) {
    float* As = rg_smem + stage * 2 * RG_TILE_F;
    float* Bs = As + RG_TILE_F;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * RG_THREADS;
      const int am = ak ? e / RG_BK32 : e % RG_BM;
      const int akk = ak ? e % RG_BK32 : e / RG_BM;
      const int m = m0 + am, ka = kb + akk;
      const bool oka = m < g.M && ka < k1;
      rg_cp4(As + akk * (RG_BM + RG_PADF) + am,
             oka ? A + (size_t)m * g.sam + (size_t)ka * g.sak : A, oka);
      const int bnn = bn ? e % RG_BN : e / RG_BK32;
      const int bkk = bn ? e / RG_BN : e % RG_BK32;
      const int n = n0 + bnn, kbb = kb + bkk;
      const bool okb = n < g.N && kbb < k1;
      rg_cp4(Bs + bkk * (RG_BN + RG_PADF) + bnn,
             okb ? B + (size_t)kbb * g.sbk + (size_t)n * g.sbn : B, okb);
    }
  };

  const int steps = k1 > k0 ? (k1 - k0 + RG_BK32 - 1) / RG_BK32 : 0;
#pragma unroll
  for (int s = 0; s < RG_STAGES - 1; ++s) {
    if (s < steps) issue(k0 + s * RG_BK32, s);
    rg_commit();
  }
  for (int t = 0; t < steps; ++t) {
    rg_wait<RG_STAGES - 2>();
    __syncthreads();
    const int nxt = t + RG_STAGES - 1;
    if (nxt < steps) issue(k0 + nxt * RG_BK32, nxt % RG_STAGES);
    rg_commit();
    const float* As = rg_smem + (t % RG_STAGES) * 2 * RG_TILE_F;
    const float* Bs = As + RG_TILE_F;
#pragma unroll
    for (int kk = 0; kk < RG_BK32; ++kk) {
      float av[8], bv[8];
      const float* ar = As + kk * (RG_BM + RG_PADF);
      const float* br = Bs + kk * (RG_BN + RG_PADF);
      const float4 a0 = *(const float4*)(ar + ty * 4);
      const float4 a1 = *(const float4*)(ar + 64 + ty * 4);
      const float4 b0 = *(const float4*)(br + tx * 4);
      const float4 b1 = *(const float4*)(br + 64 + tx * 4);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  rg_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      rg_store(g, m, n, acc[i][j]);
    }
  }
}

// -------------------------------------------------------------- bf16
// Tiles in shared memory as bf16 with K contiguous: As[m][k], Bs[n][k], so
// that a fragment's two K-adjacent values are one 32-bit load.
__global__ void __launch_bounds__(RG_THREADS)
    rg_bf16_kernel(const RgArgs g) {
  __shared__ __align__(16) unsigned short As[RG_BM][RG_BK16 + RG_PADH];
  __shared__ __align__(16) unsigned short Bs[RG_BN][RG_BK16 + RG_PADH];
  constexpr int PER = RG_BM * RG_BK16 / RG_THREADS;  // 16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % 2, wn = warp / 2;  // 2 x 4 warps of 64 x 32
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * RG_BM, n0 = blockIdx.x * RG_BN;
  const int k0 = blockIdx.z * g.kchunk;
  const int k1 = min(g.K, k0 + g.kchunk);
  const bool ak = g.sak == 1, bk = g.sbk == 1;
  unsigned short ra[PER], rb[PER];
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto load = [&](int kb) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * RG_THREADS;
      const int am = ak ? e / RG_BK16 : e % RG_BM;
      const int akk = ak ? e % RG_BK16 : e / RG_BM;
      ra[i] = rg_bf(rg_a(g, m0 + am, kb + akk, k1));
      const int bnn = bk ? e / RG_BK16 : e % RG_BN;
      const int bkk = bk ? e % RG_BK16 : e / RG_BN;
      rb[i] = rg_bf(rg_b(g, kb + bkk, n0 + bnn, k1));
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * RG_THREADS;
      const int am = ak ? e / RG_BK16 : e % RG_BM;
      const int akk = ak ? e % RG_BK16 : e / RG_BM;
      As[am][akk] = ra[i];
      const int bnn = bk ? e / RG_BK16 : e % RG_BN;
      const int bkk = bk ? e % RG_BK16 : e / RG_BN;
      Bs[bnn][bkk] = rb[i];
    }
  };

  load(k0);
  stage();
  __syncthreads();
  for (int kb = k0; kb < k1; kb += RG_BK16) {
    const bool more = kb + RG_BK16 < k1;
    if (more) load(kb + RG_BK16);
#pragma unroll
    for (int ks = 0; ks < RG_BK16; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + gq;
        af[mt][0] = *(const uint32_t*)&As[r][ks + 2 * tq];
        af[mt][1] = *(const uint32_t*)&As[r + 8][ks + 2 * tq];
        af[mt][2] = *(const uint32_t*)&As[r][ks + 2 * tq + 8];
        af[mt][3] = *(const uint32_t*)&As[r + 8][ks + 2 * tq + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + gq;
        const uint32_t b0 = *(const uint32_t*)&Bs[c][ks + 2 * tq];
        const uint32_t b1 = *(const uint32_t*)&Bs[c][ks + 2 * tq + 8];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) wm_mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 64 + mt * 16 + gq + 8 * (q / 2);
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq + (q % 2);
        rg_store(g, m, n, acc[mt][nt][q]);
      }
}

// ----------------------------------------------------- the second passes
// c[e] = part[0][e] + part[1][e] + ... in chunk order
__global__ void rg_reduce_kernel(const float* __restrict__ part, int chunks,
                                 size_t len, float* __restrict__ c) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int z = 1; z < chunks; ++z) s += part[(size_t)z * len + e];
    c[e] = s;
  }
}

// part[z][n] = sum of b[r][n] over chunk z's rows, in row order
__global__ void rg_colsum_kernel(const void* b, int bf, int rows, int N,
                                 int rchunk, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rchunk, r1 = min(rows, r0 + rchunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += rg_ld(b, bf, (size_t)r * N + n);
  part[(size_t)blockIdx.y * N + n] = s;
}

static inline int rg_imin(int a, int b) { return a < b ? a : b; }
static inline int rg_imax(int a, int b) { return a > b ? a : b; }

static cudaError_t rg_reduce(const float* part, int chunks, size_t len,
                             float* c, cudaStream_t st) {
  const size_t want = (len + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  rg_reduce_kernel<<<blocks, 256, 0, st>>>(part, chunks, len, c);
  return cudaGetLastError();
}

// ------------------------------------------------------------- C interface
// Chunks of the weight products' rows: about four waves of blocks (two
// blocks on each of 132 SMs a wave; at Cora's dW_in, 408 tiles in one chunk
// left the second of two waves half empty), at least 512 rows a chunk.  A
// function of the shape alone, so the sums' order is fixed.
extern "C" int gt_k18_chunks(int M, int N, int K) {
  const int tiles = ((M + RG_BM - 1) / RG_BM) * ((N + RG_BN - 1) / RG_BN);
  const int want = (4 * 264 + tiles - 1) / tiles;
  return rg_imax(1, rg_imin(want, K / 512));
}

extern "C" int gt_k18_colsum_chunks(int rows) {
  return rg_imax(1, (rows + 127) / 128);
}

// C = op(A) op(B) with the epilogue; chunks > 1 (no epilogue) splits K and
// writes partial [chunks, M, N] first.
extern "C" int gt_k18_gemm(const void* a, int a_bf16, const void* b,
                           int b_bf16, float* c, int M, int N, int K, int sam,
                           int sak, int sbk, int sbn, int mma_bf16,
                           const float* bias, int relu, const float* gate,
                           const float* add, float gate_keep, int add_every,
                           unsigned int seed, unsigned int stream_id,
                           unsigned int keep24, float keep, int drop_on,
                           int chunks, float* partial, void* stream) {
  if (chunks < 1 || (chunks > 1 && (bias || relu || gate || add || drop_on ||
                                    !partial)) ||
      (!mma_bf16 && (a_bf16 || b_bf16)) ||
      add_every < 1 || (sak != 1 && sam != 1) || (sbk != 1 && sbn != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RgArgs g;
  g.a = a;
  g.a_bf = a_bf16;
  g.b = b;
  g.b_bf = b_bf16;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  g.sam = sam;
  g.sak = sak;
  g.sbk = sbk;
  g.sbn = sbn;
  g.bias = bias;
  g.relu = relu;
  g.gate = gate;
  g.gate_inv = 1.0f / gate_keep;
  g.add = add;
  g.add_every = add_every;
  g.dr = GtDrop{seed, keep24, keep, drop_on};
  g.key = gt_stream_key(seed, stream_id);
  const int step = mma_bf16 ? RG_BK16 : RG_BK32;
  g.kchunk = ((K + chunks - 1) / chunks + step - 1) / step * step;
  g.partial = chunks > 1 ? partial : nullptr;
  const dim3 grid((N + RG_BN - 1) / RG_BN, (M + RG_BM - 1) / RG_BM, chunks);
  if (mma_bf16) {
    rg_bf16_kernel<<<grid, RG_THREADS, 0, st>>>(g);
  } else {
    const size_t bytes = RG_STAGES * 2 * RG_TILE_F * sizeof(float);
    rg_f32_kernel<<<grid, RG_THREADS, bytes, st>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  return (int)rg_reduce(partial, chunks, (size_t)M * N, c, st);
}

// col[n] = sum over rows of b[r][n] (b [rows, N], f32 or bf16): per-chunk
// partials [chunks, N], then their sum in chunk order
extern "C" int gt_k18_colsum(const void* b, int b_bf16, float* col,
                             float* part, int rows, int N, int chunks,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rchunk = (rows + chunks - 1) / chunks;
  const dim3 grid((N + 255) / 256, chunks);
  rg_colsum_kernel<<<grid, 256, 0, st>>>(b, b_bf16, rows, N, rchunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rg_reduce(part, chunks, (size_t)N, col, st);
}
