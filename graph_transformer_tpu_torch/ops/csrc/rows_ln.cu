// K20 — residual plus dropout plus LayerNorm over rows of any D, forward and
// backward, for the encoder layer past D = 128 (ops/rows_encoder.py).
//
// Stands in, past D = 128, for the LayerNorms inside the TPU kernels
// graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (:266, call :429) and
// _bwd1_kernel (:316, call :361), ops/pallas_encoder.py:_fwd_kernel (:196,
// call :355) and _bwd_kernel (:214, call :386), ops/pallas_ffn.py:_fwd_kernel
// (:70, call :250) and _bwd_kernel (:97, call :274): y = LN(res + drop(v)),
// eps 1e-5, with v dropped at (seed, stream) over the [R, D] element indices,
// and res row r the row r * res_every of res (the slot-0 last layer's
// residual is slot 0 of each neighborhood), f32 or bf16.
//
// Forward: a block a row, its 256 threads over D, the row kept in shared
// memory; the mean and the variance (of the centred row) are f32 block
// sums (warp shuffles, then the warps' sums in warp order).
//
// Backward (rl_bwd_kernel): a row to a block of 8 warps, its u = res +
// drop(v) and g in registers (E values a thread, its columns 256 apart),
// all of a row's loads issued together, predicated on the column, with no
// branch between them; the statistics and the two means of du = (g*gamma -
// mean(g*gamma) - uhat * mean(g*gamma*uhat)) * rstd by shuffles and one
// barrier each (three a row; the old kernel had 13); dv = drop(du)
// (gt_div_keep, no branch).  A block takes rows a grid apart and sums
// g*uhat and g into its columns in shared memory, a column a thread; at the
// end it writes one partial row, and rl_colsum_kernel sums the blocks'
// partials in a fixed order over 90 blocks of 32 warps at D = 1,433 (no
// float atomics: runs repeat bit for bit).  Rows up to 19,370 columns
// (gamma and the sums in 227 KB).  A warp or two a row hold too few rows in
// flight an SM (E = 48 or 24 values a thread of each of res, v and g);
// rows of v and g staged ahead in shared memory by cp.async, more blocks an
// SM and 128 threads a row were no faster (PERF.md).
//
// Bound on the H100: bytes.  At Cora's slot-0 rows (2,816 x 1,433 f32) the
// forward moves 48.4 MB (0.01446 ms at 3.35 TB/s), the backward 80.7 MB
// (0.02410 ms: g, res's rows, v, du and dv); over a full layer's 14,080 rows
// the backward moves 403.6 MB (0.12046 ms).  The old backward (a block a run
// of ~6 rows, the row in shared memory, five block sums a row, the partials
// summed on 12 SMs) took 0.0803 ms at slot 0.
#include "common.cuh"

#define RL_THREADS 256

__device__ __forceinline__ float rl_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum of v, the same on every thread (red: 33 floats)
__device__ __forceinline__ float rl_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = rl_warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nw ? red[lane] : 0.f;
    s = rl_warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float rl_ld(const void* p, int bf, size_t i) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[i])
            : ((const float*)p)[i];
}

// u = res + drop(v) of row r into su; returns (mean, rstd)
__device__ __forceinline__ float2 rl_row(const void* res, int res_bf,
                                         int res_every, const float* v, int r,
                                         int D, const GtDrop& dr, uint32_t key,
                                         float* su, float* red) {
  const size_t rr = (size_t)r * res_every * D, rv = (size_t)r * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float u = rl_ld(res, res_bf, rr + d) +
                    gt_drop(dr, key, (uint32_t)(rv + d), v[rv + d]);
    su[d] = u;
    s += u;
  }
  const float mu = rl_block_sum(s, red) / (float)D;
  float q = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float c = su[d] - mu;
    q += c * c;
  }
  const float var = rl_block_sum(q, red) / (float)D;
  return make_float2(mu, 1.0f / sqrtf(var + 1e-5f));
}

__global__ void __launch_bounds__(RL_THREADS)
    rl_fwd_kernel(const void* res, int res_bf, int res_every,
                  const float* __restrict__ v, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ y,
                  int D, GtDrop dr, uint32_t key) {
  extern __shared__ float su[];  // [D]
  __shared__ float red[33];
  const int r = blockIdx.x;
  const float2 st = rl_row(res, res_bf, res_every, v, r, D, dr, key, su, red);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float uh = (su[d] - st.x) * st.y;
    y[(size_t)r * D + d] = uh * gamma[d] + beta[d];
  }
}

// ---------------------------------------------------------------- backward
#define RL_BWD_THREADS 256  // a block: one row at a time
#define RL_RED_SLICES 32  // partial rows a column of the second pass sums apart

// (a, b) summed over the block's 8 warps, in warp order, on each thread;
// red: 16 floats of one of the row's three sums (a set is written again
// only after the next barrier, so one barrier a sum does)
__device__ __forceinline__ float2 rl_block_sum2(float a, float b,
                                                float* red) {
  a = rl_warp_sum(a);
  b = rl_warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = a;
    red[2 * (threadIdx.x >> 5) + 1] = b;
  }
  __syncthreads();
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int k = 0; k < RL_BWD_THREADS / 32; ++k) {
    x += red[2 * k];
    y += red[2 * k + 1];
  }
  return make_float2(x, y);
}

// drop(x) at element idx without a branch: x / keep (gt_div_keep, rk = 1 /
// keep) where the word keeps it, else 0; x at rate 0
__device__ __forceinline__ float rl_drop(const GtDrop& dr, uint32_t key,
                                         uint32_t idx, float x, float rk) {
  const float kept = dr.on ? gt_div_keep(x, dr.keep, rk) : x;
  return (dr.on == 0) | gt_keep(dr, key, idx) ? kept : 0.f;
}

// du = (g*gamma - mean(g*gamma) - uhat * mean(g*gamma*uhat)) * rstd and dv
// = drop(du), a row at a time: rows blockIdx.x, then a grid apart, E
// values a thread (its columns 256 apart).  A row's loads are predicated
// on the column alone, with no branch between them (a branch after a load,
// before the next, would make each wait for the last); the arithmetic
// masks the columns past D.  The block sums g*uhat and g over its rows into
// shared memory, a column a thread (no barrier), and writes them to
// part[block] at the end.
template <int E>
__global__ void __launch_bounds__(RL_BWD_THREADS, 1)
    rl_bwd_kernel(const float* __restrict__ g, const void* res, int res_bf,
                  int res_every, const float* __restrict__ v,
                  const float* __restrict__ gamma, float* __restrict__ du,
                  float* __restrict__ dv, float* __restrict__ part, int R,
                  int D, GtDrop dr, uint32_t key) {
  extern __shared__ float smem[];  // gamma [D], the column sums [2D]
  __shared__ float red[3][2 * RL_BWD_THREADS / 32];
  const int t = threadIdx.x;
  float* sg = smem;
  float* cs = smem + D;
  const float rk = gt_rcp_keep(dr.keep);
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t rr = (size_t)r * res_every * D + t, rv = (size_t)r * D;
    float u[E], x[E], y[E];
    if (res_bf) {
      const __nv_bfloat16* rb = (const __nv_bfloat16*)res + rr;
#pragma unroll
      for (int k = 0; k < E; ++k)
        u[k] = t + k * RL_BWD_THREADS < D
                   ? __bfloat162float(rb[k * RL_BWD_THREADS])
                   : 0.f;
    } else {
      const float* rf = (const float*)res + rr;
#pragma unroll
      for (int k = 0; k < E; ++k)
        u[k] = t + k * RL_BWD_THREADS < D ? rf[k * RL_BWD_THREADS] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const bool in = t + k * RL_BWD_THREADS < D;
      x[k] = in ? v[rv + t + k * RL_BWD_THREADS] : 0.f;
      y[k] = in ? g[rv + t + k * RL_BWD_THREADS] : 0.f;
    }
    if (r == (int)blockIdx.x) {  // with the first row's loads in flight
      for (int d = t; d < D; d += RL_BWD_THREADS) sg[d] = gamma[d];
      for (int d = t; d < 2 * D; d += RL_BWD_THREADS) cs[d] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int d = t + k * RL_BWD_THREADS;
      u[k] += rl_drop(dr, key, (uint32_t)(rv + d), x[k], rk);
      s += u[k];
    }
    const float mu = rl_block_sum2(s, 0.f, red[0]).x / (float)D;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float c = t + k * RL_BWD_THREADS < D ? u[k] - mu : 0.f;
      q += c * c;
    }
    const float rstd =
        1.0f / sqrtf(rl_block_sum2(q, 0.f, red[1]).x / (float)D + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int d = t + k * RL_BWD_THREADS;
      const bool in = d < D;
      const float uh = (u[k] - mu) * rstd, gg = y[k] * sg[in ? d : 0];
      s1 += gg;
      s2 += gg * uh;
      if (in) {
        cs[d] += y[k] * uh;
        cs[D + d] += y[k];
      }
      u[k] = uh;
      x[k] = gg;
    }
    const float2 m = rl_block_sum2(s1, s2, red[2]);
    const float m1 = m.x / (float)D, m2 = m.y / (float)D;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int d = t + k * RL_BWD_THREADS;
      const float o = (x[k] - m1 - u[k] * m2) * rstd;
      if (d < D) {
        du[rv + d] = o;
        dv[rv + d] = rl_drop(dr, key, (uint32_t)(rv + d), o, rk);
      }
    }
  }
  __syncthreads();
  float* p = part + (size_t)blockIdx.x * 2 * D;
  for (int d = t; d < 2 * D; d += RL_BWD_THREADS) p[d] = cs[d];
}

// out[e] = sum over blocks of part[b][e] in a fixed order: a block 32
// columns, its warps over the partial rows (warp w: rows w, w + 32, ...),
// then the warps' sums in warp order
__global__ void __launch_bounds__(32 * RL_RED_SLICES)
    rl_colsum_kernel(const float* __restrict__ part, int blocks, int len,
                     float* __restrict__ out) {
  __shared__ float sm[RL_RED_SLICES][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < len)
    for (int b = w; b < blocks; b += RL_RED_SLICES)
      s += part[(size_t)b * len + e];
  sm[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < len) {
    float t = 0.f;
    for (int k = 0; k < RL_RED_SLICES; ++k) t += sm[k][lane];
    out[e] = t;
  }
}

static cudaError_t rl_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// y [R, D] = LN(res + drop(v)) * gamma + beta
extern "C" int gt_k20_ln_fwd(const void* res, int res_bf16, int res_every,
                             const float* v, const float* gamma,
                             const float* beta, float* y, int R, int D,
                             unsigned int seed, unsigned int stream_id,
                             unsigned int keep24, float keep, int drop_on,
                             void* stream) {
  const size_t bytes = (size_t)D * sizeof(float);
  cudaError_t err = rl_smem((const void*)rl_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const GtDrop dr{seed, keep24, keep, drop_on};
  rl_fwd_kernel<<<R, RL_THREADS, bytes, (cudaStream_t)stream>>>(
      res, res_bf16, res_every, v, gamma, beta, y, D, dr,
      gt_stream_key(seed, stream_id));
  return (int)cudaGetLastError();
}

// The backward's kernel for rows of D (none past 80 values a thread, or
// past 19,370 columns: gamma and the column sums in 227 KB)
static const void* rl_bwd_kernel_for(int D) {
  const int need = (D + RL_BWD_THREADS - 1) / RL_BWD_THREADS;
  if (3 * (size_t)D * sizeof(float) > 232448) return nullptr;
  return need <= 8    ? (const void*)rl_bwd_kernel<8>
         : need <= 16 ? (const void*)rl_bwd_kernel<16>
         : need <= 24 ? (const void*)rl_bwd_kernel<24>
         : need <= 48 ? (const void*)rl_bwd_kernel<48>
         : need <= 80 ? (const void*)rl_bwd_kernel<80>
                      : nullptr;
}

// the backward's blocks for R rows of D: what fills the card at its
// occupancy, at most one a group of rows (0: D too wide)
extern "C" int gt_k20_bwd_blocks(int R, int D) {
  const void* kernel = rl_bwd_kernel_for(D);
  const size_t bytes = 3 * (size_t)D * sizeof(float);
  if (!kernel || rl_smem(kernel, bytes) != cudaSuccess) return 0;
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                    RL_BWD_THREADS, bytes) !=
      cudaSuccess)
    return 0;
  return max(1, min(R, sms * max(per, 1)));
}

// du, dv [R, D]; dgb [2, D] = (sum g*uhat, sum g); part: [blocks, 2, D]
extern "C" int gt_k20_ln_bwd(const float* g, const void* res, int res_bf16,
                             int res_every, const float* v, const float* gamma,
                             const float* beta, float* du, float* dv,
                             float* part, float* dgb, int R, int D, int blocks,
                             unsigned int seed, unsigned int stream_id,
                             unsigned int keep24, float keep, int drop_on,
                             void* stream) {
  (void)beta;
  const cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = rl_bwd_kernel_for(D);
  const size_t bytes = 3 * (size_t)D * sizeof(float);
  if (!kernel || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = rl_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const GtDrop dr{seed, keep24, keep, drop_on};
  const uint32_t key = gt_stream_key(seed, stream_id);
  void* args[] = {(void*)&g,  (void*)&res, (void*)&res_bf16,
                  (void*)&res_every, (void*)&v, (void*)&gamma,
                  (void*)&du, (void*)&dv,  (void*)&part,
                  (void*)&R,  (void*)&D,   (void*)&dr,
                  (void*)&key};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(RL_BWD_THREADS), args,
                         bytes, st);
  if (err != cudaSuccess) return (int)err;
  rl_colsum_kernel<<<(2 * D + 31) / 32, 32 * RL_RED_SLICES, 0, st>>>(
      part, blocks, 2 * D, dgb);
  return (int)cudaGetLastError();
}
