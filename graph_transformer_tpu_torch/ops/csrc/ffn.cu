// K11 — out = LN(x + drop(drop(relu(x@W1+b1))@W2+b2)) over rows x [M, D],
// and K12 — its backward: dx, dW1, db1, dW2, db2, dgamma, dbeta.
//
// Replace graph_transformer_tpu/ops/pallas_ffn.py:_fwd_kernel and
// _bwd_kernel (entry ffn_residual_ln), which the JAX per-layer encoder runs
// after its attention for masked (node-axis) or multi-head layers
// (ops/attention.py:_encoder_layer).  Contract: x in bf16 or f32 (products
// take operands in that dtype and accumulate in f32, as the TPU kernel's
// `mm`), the six FFN/LayerNorm tensors in f32, seed and timestep `layer`
// (dropout streams 4*layer+2 on the hidden [M, F] and 4*layer+3 on the FFN
// output [M, D], row-major element indices, as the encoder layer's sites 2
// and 3).  K11 returns out in x's dtype; K12 takes dout (f32 of x's dtype,
// as the TPU kernel casts it) and returns dx in x's dtype and the gradients
// in f32.
//
// What the TPU kernel keeps out of device memory is the [M, F] hidden: a
// block here holds FF_ROWS rows in shared memory and walks the hidden FF_FC
// columns at a time, so the forward never writes it.  The TPU kernel
// accumulates dW1/dW2 across its sequential grid; blocks here run in any
// order, and per-block [D, F] partials would be 2*D*F*4 bytes a block
// (~100 MB at the quickstart's node axis), so K12 writes the products' row
// operands instead (the hidden h and its cotangent dh, rounded to the
// compute dtype, [M, F] each, and dy [M, D]) and computes dW1 = x^T dh and
// dW2 = h^T dy in the split-K products of K6 (wd_products, wide_mma.cuh:
// both in one launch), summing partials in block and split order (no float
// atomics: runs repeat bit for bit).  Row-wise work (LayerNorm, its
// backward) takes a warp per row, lanes over columns (D <= 128).
//
// Bound on the H100: at the quickstart's node axis (M = 5,760 rows, D = 68,
// F = 1,024, float32) K11 does 1.6 GFLOP of float32 products on 3 MB of rows,
// so the operations bound it (~0.024 ms at 67 TFLOP/s); K12's 4.8 GFLOP
// likewise.  Every product runs on the tensor cores: the row products
// (x W1 and h W2 forward, dy W2^T and dh W1^T backward) through WdMmaGemm
// (wide_mma.cuh: mma.sync, bf16 m16n8k16 for bf16 rows, 3xTF32 for float32
// ones, the weights read by cp.async, so nothing stages rounded copies of
// W1 and W2), the weight products through wd_products' tensor-core kernel.
// The hidden chunk is FF_FC = 128 columns, one pass of WdMmaGemm's output
// columns: its per-tile overhead (a barrier and the A tile's conversion per
// 16 of K), not its mma.sync, is what it costs (PERF.md), and the K = D
// products take as many tiles per chunk whatever the chunk, so a wider
// chunk only costs shared memory: 98 KB a block at D = 68, two blocks an SM.
#include "wide_mma.cuh"

#define FF_ROWS 32          // rows a block
#define FF_FC WM_NB         // hidden columns a chunk
#define FF_THREADS WD_THREADS  // WdMmaGemm's 8 warps

struct FfParams {
  const float *w1, *b1, *w2, *b2, *g, *beta;  // [D,F] [F] [F,D] [D] [D] [D]
};

// the tensor-core products' staging region first (16-byte aligned), then
// K11: x, xb, z (3 x [R, D]) and the hidden chunk h [R, FC]; K12 adds du
// [R, D] and the unrounded dh chunk [R, FC]
static inline size_t ff_smem_floats(int D, bool bwd) {
  const size_t R = FF_ROWS;
  return WM_STAGE_FLOATS + R * D * (bwd ? 4 : 3) +
         R * FF_FC * (bwd ? 2 : 1);
}

__device__ __forceinline__ float ff_ld(const void* p, int bf, size_t e) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[e])
            : ((const float*)p)[e];
}

__device__ __forceinline__ void ff_st(void* p, int bf, size_t e, float v) {
  if (bf)
    ((__nv_bfloat16*)p)[e] = __float2bfloat16(v);
  else
    ((float*)p)[e] = v;
}

// The block's rows into x (f32) and xb (rounded to the compute dtype), rows
// past R zeroed; z zeroed.
__device__ __forceinline__ void ff_load_rows(const void* x, int bf, size_t r0,
                                             int R, int D, float* sX,
                                             float* sXb, float* sZ) {
  for (int e = threadIdx.x; e < FF_ROWS * D; e += blockDim.x) {
    const float v = e < R * D ? ff_ld(x, bf, r0 * D + e) : 0.f;
    sX[e] = v;
    sXb[e] = gt_rn(v, bf);
    sZ[e] = 0.f;
  }
}

// Rows [R, nf] of sH (leading dimension FF_FC) to columns f0.. of the
// block's rows of t [M, F], a warp per row.
__device__ __forceinline__ void ff_store_chunk(void* t, int bf, size_t r0,
                                               int R, int F, int f0, int nf,
                                               const float* sH) {
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5)
    for (int c = threadIdx.x & 31; c < nf; c += 32)
      ff_st(t, bf, (r0 + r) * F + f0 + c, sH[r * FF_FC + c]);
}

// z += drop(relu(xb @ W1 + b1)) @ W2 over the block's R rows, the hidden
// chunk by chunk (rounded to the compute dtype in sH; also stored to h
// [M, F] when given).  Begins and ends with a barrier.
__device__ __forceinline__ void ff_hidden_pass(const FfParams& p,
                                               const GtDrop& dr, uint32_t kH,
                                               size_t r0, int R, int D, int F,
                                               int bf, const float* sXb,
                                               float* sZ, float* sH,
                                               const WdMmaGemm& mma, void* h) {
  __syncthreads();  // xb and z are in place
  for (int f0 = 0; f0 < F; f0 += FF_FC) {
    const int nf = min(FF_FC, F - f0);
    // every thread has passed the previous chunk's last barrier, so sH is
    // free; each (r, c) of sZ is summed by one thread, chunk after chunk
    mma(sXb, D, R, D, p.w1 + f0, F, 1, nf, bf, [&](int r, int c, float acc) {
      const size_t e = (r0 + r) * F + f0 + c;
      sH[r * FF_FC + c] = gt_rn(
          gt_drop(dr, kH, (uint32_t)e, fmaxf(acc + __ldg(p.b1 + f0 + c), 0.f)),
          bf);
    });
    __syncthreads();
    if (h) ff_store_chunk(h, bf, r0, R, F, f0, nf, sH);
    mma(sH, FF_FC, R, nf, p.w2 + (size_t)f0 * D, D, 1, D, bf,
        [&](int r, int c, float acc) { sZ[r * D + c] += acc; });
  }
  __syncthreads();
}

// Row q's LayerNorm input x + drop(z + b2) in u (the lane's columns, 0 past
// D), turned into uhat; returns rstd.
__device__ __forceinline__ float ff_ln_row(const FfParams& p, const GtDrop& dr,
                                           uint32_t kZ, size_t r0, int q,
                                           int D, const float* sX,
                                           const float* sZ, float* u,
                                           int lane) {
#pragma unroll
  for (int m = 0; m < WD_CPL; ++m) {
    const int d = lane + 32 * m;
    u[m] = d < D ? sX[q * D + d] + gt_drop(dr, kZ, (uint32_t)((r0 + q) * D + d),
                                           sZ[q * D + d] + p.b2[d])
                 : 0.f;
  }
  return wd_ln(u, D, lane);
}

__global__ void __launch_bounds__(FF_THREADS, 2)
ff_fwd_kernel(const void* x, int x_bf16, void* out, FfParams p, GtDrop dr,
              int layer, int M, int D, int F) {
  extern __shared__ float smem[];
  const WdMmaGemm mma{smem};          // [WM_STAGE_FLOATS] staging
  float* sX = smem + WM_STAGE_FLOATS; // [R, D] input rows
  float* sXb = sX + FF_ROWS * D;      // [R, D] rounded rows
  float* sZ = sXb + FF_ROWS * D;      // [R, D] FFN output
  float* sH = sZ + FF_ROWS * D;       // [R, FC] hidden chunk (rounded)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t r0 = (size_t)blockIdx.x * FF_ROWS;
  const int R = min(FF_ROWS, M - (int)r0);
  const int bf = x_bf16;
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  ff_load_rows(x, bf, r0, R, D, sX, sXb, sZ);
  ff_hidden_pass(p, dr, kH, r0, R, D, F, bf, sXb, sZ, sH, mma, nullptr);
  for (int q = warp; q < R; q += nw) {
    float u[WD_CPL];
    ff_ln_row(p, dr, kZ, r0, q, D, sX, sZ, u, lane);
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) ff_st(out, bf, (r0 + q) * D + d, u[m] * p.g[d] + p.beta[d]);
    }
  }
}

// scratch of K12: the row operands of the two weight products and the
// per-block partial sums of the small gradients [db1 F | db2 dgamma dbeta 3D]
struct FfWork {
  void *h, *dh, *dy;  // [M, F], [M, F], [M, D] in the compute dtype
  float *small, *split;
};

__host__ __device__ inline int ff_small_width(int D, int F) { return F + 3 * D; }

// dW1 = x^T dh and dW2 = h^T dy over the M rows, operands as the products
// take them (bf16, or f32 exact), into grads [D*F | F*D] (null: sizes only)
static void ff_specs(const void* x, int bf, const FfWork& w, float* grads,
                     int M, int D, int F, WdProductSpec (&ps)[2]) {
  const int ex = !bf;
  ps[0] = {{x, bf, D, 0, ex}, {w.dh, bf, F, 0, ex}, M, D, F, grads};
  ps[1] = {{w.h, bf, F, 0, ex}, {w.dy, bf, D, 0, ex}, M, F, D,
           grads ? grads + (size_t)D * F : nullptr};
}

static size_t ff_work(int M, int D, int F, int bf, char* base, FfWork* w) {
  const size_t es = bf ? 2 : 4;
  const size_t blocks = (size_t)(M + FF_ROWS - 1) / FF_ROWS;
  WdProductSpec ps[2];
  ff_specs(nullptr, bf, FfWork{}, nullptr, M, D, F, ps);
  const size_t split = wd_products_split_floats(ps, 2);
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* q = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return q;
  };
  w->h = take((size_t)M * F * es);
  w->dh = take((size_t)M * F * es);
  w->dy = take((size_t)M * D * es);
  w->small = (float*)take(blocks * ff_small_width(D, F) * 4);
  w->split = (float*)take(split * 4);
  return off;
}

__global__ void __launch_bounds__(FF_THREADS, 2)
ff_bwd_kernel(const void* x, int x_bf16, const float* dout, FfParams p,
              GtDrop dr, int layer, int M, int D, int F, void* dx, FfWork w) {
  extern __shared__ float smem[];
  const WdMmaGemm mma{smem};          // [WM_STAGE_FLOATS] staging
  float* sX = smem + WM_STAGE_FLOATS; // [R, D] input rows
  float* sXb = sX + FF_ROWS * D;      // [R, D] rounded rows
  float* sZ = sXb + FF_ROWS * D;      // [R, D] FFN output, then rounded dy
  float* sDU = sZ + FF_ROWS * D;      // [R, D] du, then dx
  float* sH = sDU + FF_ROWS * D;      // [R, FC] hidden chunk, then rounded dh
  float* sDHf = sH + FF_ROWS * FF_FC; // [R, FC] dh chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t r0 = (size_t)blockIdx.x * FF_ROWS;
  const int R = min(FF_ROWS, M - (int)r0);
  const int bf = x_bf16;
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);
  const float ikeep = dr.on ? 1.f / dr.keep : 1.f;
  float* part = w.small + (size_t)blockIdx.x * ff_small_width(D, F);

  // ---- 1. the forward again, storing the rounded hidden
  ff_load_rows(x, bf, r0, R, D, sX, sXb, sZ);
  ff_hidden_pass(p, dr, kH, r0, R, D, F, bf, sXb, sZ, sH, mma, w.h);

  // ---- 2. LayerNorm backward and the FFN-output dropout, a warp per row;
  // this warp's column sums of db2, dgamma, dbeta
  float cs[3][WD_CPL];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) cs[k][m] = 0.f;
  for (int q = warp; q < R; q += nw) {
    float u[WD_CPL], gv[WD_CPL];
    const float rs = ff_ln_row(p, dr, kZ, r0, q, D, sX, sZ, u, lane);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      gv[m] = 0.f;
      if (d < D) {
        gv[m] = dout[(r0 + q) * D + d];
        const float gg = gv[m] * p.g[d];
        m1 += gg;
        m2 += gg * u[m];
      }
    }
    m1 = wd_warp_sum(m1) / (float)D;
    m2 = wd_warp_sum(m2) / (float)D;
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const size_t e = (r0 + q) * D + d;
        const float du = (gv[m] * p.g[d] - m1 - u[m] * m2) * rs;
        const float dy = gt_drop(dr, kZ, (uint32_t)e, du);
        sDU[q * D + d] = du;
        sZ[q * D + d] = gt_rn(dy, bf);
        ff_st(w.dy, bf, e, dy);
        cs[0][m] += dy;
        cs[1][m] += gv[m] * u[m];
        cs[2][m] += gv[m];
      }
    }
  }

  // ---- 3. the hidden's cotangent dh = (dy @ W2^T) * relu' * dropout,
  // chunk by chunk from the stored hidden (relu' times the dropout factor is
  // (h > 0) / keep), and dx = du + dh @ W1^T
  __syncthreads();  // rounded dy and du are in place
  for (int f0 = 0; f0 < F; f0 += FF_FC) {
    const int nf = min(FF_FC, F - f0);
    // every thread has passed the previous chunk's last barrier, so sH and
    // sDHf are free; the hidden this block stored in step 1 is visible
    mma(sZ, D, R, D, p.w2 + (size_t)f0 * D, 1, D, nf, bf,
        [&](int r, int c, float acc) {
          const float hv = ff_ld(w.h, bf, (r0 + r) * F + f0 + c);
          const float dh = hv > 0.f ? acc * ikeep : 0.f;
          sDHf[r * FF_FC + c] = dh;
          sH[r * FF_FC + c] = gt_rn(dh, bf);
        });
    __syncthreads();
    ff_store_chunk(w.dh, bf, r0, R, F, f0, nf, sH);
    for (int c = threadIdx.x; c < nf; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += sDHf[r * FF_FC + c];
      part[f0 + c] = s;
    }
    mma(sH, FF_FC, R, nf, p.w1 + f0, 1, F, D, bf,
        [&](int r, int c, float acc) { sDU[r * D + c] += acc; });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x)
    ff_st(dx, bf, r0 * D + e, sDU[e]);

  // ---- 4. the warps' column sums, added in warp order
  float* sRed = sH;  // [nw, 3, D]
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int m = 0; m < WD_CPL; ++m) {
      const int d = lane + 32 * m;
      if (d < D) sRed[(warp * 3 + k) * D + d] = cs[k][m];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * D; e += blockDim.x) {
    float s = 0.f;
    for (int ww = 0; ww < nw; ++ww) s += sRed[ww * 3 * D + e];
    part[F + e] = s;
  }
}

static inline FfParams ff_params(const float* const* params) {
  return FfParams{params[0], params[1], params[2], params[3], params[4],
                  params[5]};
}

static cudaError_t ff_set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" size_t gt_k12_work_bytes(int M, int D, int F, int bf) {
  FfWork w;
  return ff_work(M, D, F, bf, nullptr, &w);
}

// K11.  x, out [M, D] (bf16 if x_bf16, else f32); params: w1 [D,F], b1 [F],
// w2 [F,D], b2 [D], gamma [D], beta [D] (f32)
extern "C" int gt_k11_ffn_fwd(const void* x, int x_bf16, void* out,
                              const float* const* params, int layer, int M,
                              int D, int F, unsigned int seed,
                              unsigned int keep24, float keep, int drop_on,
                              void* stream) {
  if (D < 1 || D > WD_MAXD || M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ff_smem_floats(D, false);
  cudaError_t e = ff_set_smem((const void*)ff_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const GtDrop dr{seed, keep24, keep, drop_on};
  ff_fwd_kernel<<<(M + FF_ROWS - 1) / FF_ROWS, FF_THREADS, smem,
                  (cudaStream_t)stream>>>(x, x_bf16, out, ff_params(params),
                                          dr, layer, M, D, F);
  return (int)cudaGetLastError();
}

// K12.  dout [M, D] f32; dx [M, D] in x's dtype; work: gt_k12_work_bytes
// bytes of scratch; grads [F + 3D + 2DF] f32: db1, db2, dgamma, dbeta, dW1
// [D, F], dW2 [F, D]
extern "C" int gt_k12_ffn_bwd(const void* x, int x_bf16, const float* dout,
                              const float* const* params, int layer, void* dx,
                              void* work, float* grads, int M, int D, int F,
                              unsigned int seed, unsigned int keep24,
                              float keep, int drop_on, void* stream) {
  if (D < 1 || D > WD_MAXD || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FfWork w;
  ff_work(M, D, F, x_bf16, (char*)work, &w);
  const size_t smem = sizeof(float) * ff_smem_floats(D, true);
  cudaError_t e = ff_set_smem((const void*)ff_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const GtDrop dr{seed, keep24, keep, drop_on};
  const int blocks = (M + FF_ROWS - 1) / FF_ROWS;
  ff_bwd_kernel<<<blocks, FF_THREADS, smem, s>>>(
      x, x_bf16, dout, ff_params(params), dr, layer, M, D, F, dx, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int PS = ff_small_width(D, F);
  if ((e = gt_reduce_partials(w.small, blocks, PS, grads, s)) != cudaSuccess)
    return (int)e;
  WdProductSpec ps[2];
  ff_specs(x, x_bf16, w, grads + PS, M, D, F, ps);
  return (int)wd_products(ps, 2, w.split, WgSmall{}, s);
}

// The split-K weight products alone (wd_products: K6, K8w, K10w, K12, K14w):
// out [M1, N1] = a^T b over `rows` rows of a [rows, M1] and b [rows, N1],
// both bf16 (bf16 products) or both f32 (3xTF32); split:
// gt_wgrad_split_floats floats of scratch.
extern "C" size_t gt_wgrad_split_floats(int rows, int M1, int N1) {
  const WdProductSpec p{{}, {}, rows, M1, N1, nullptr};
  return wd_products_split_floats(&p, 1);
}

extern "C" int gt_wgrad(const void* a, const void* b, int bf16, int rows,
                        int M1, int N1, float* split, float* out,
                        void* stream) {
  if (rows < 1 || M1 < 1 || N1 < 1) return (int)cudaErrorInvalidValue;
  return (int)wd_wgrad({a, bf16, M1, 0, !bf16}, {b, bf16, N1, 0, !bf16}, rows,
                       M1, N1, split, out, (cudaStream_t)stream);
}
