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
// sums (warp shuffles, then the warps' sums in warp order).  Backward: a
// block takes a run of rows, recomputes each row's statistics with the
// forward's code, writes du = (g*gamma - mean(g*gamma) - uhat *
// mean(g*gamma*uhat)) * rstd and dv = drop(du), and sums g*uhat and g into
// its columns' partials in shared memory; a second kernel sums the blocks'
// partials in block order into dgamma, dbeta (no float atomics: runs repeat
// bit for bit).
//
// Bound on the H100: bytes; at Cora's slot-0 rows (2,816 x 1,433 f32) the
// forward moves 48 MB (0.014 ms at 3.35 TB/s), the backward 81 MB.
#include "common.cuh"

#define RL_THREADS 256
#define RL_BWD_BLOCKS 528  // backward blocks at most: two waves of 264

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

__global__ void __launch_bounds__(RL_THREADS)
    rl_bwd_kernel(const float* __restrict__ g, const void* res, int res_bf,
                  int res_every, const float* __restrict__ v,
                  const float* __restrict__ gamma, float* __restrict__ du,
                  float* __restrict__ dv, float* __restrict__ part, int R,
                  int D, int rows_per_block, GtDrop dr, uint32_t key) {
  extern __shared__ float smem[];  // su [D], column sums of g*uhat, g [2D]
  __shared__ float red[33];
  float* su = smem;
  float* cg = smem + D;
  float* cb = smem + 2 * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) cg[d] = cb[d] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const float2 st =
        rl_row(res, res_bf, res_every, v, r, D, dr, key, su, red);
    const float* gr = g + (size_t)r * D;
    float s1 = 0.f, s2 = 0.f;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float uh = (su[d] - st.x) * st.y;
      const float gv = gr[d];
      const float gg = gv * gamma[d];
      s1 += gg;
      s2 += gg * uh;
      cg[d] += gv * uh;
      cb[d] += gv;
    }
    const float m1 = rl_block_sum(s1, red) / (float)D;
    const float m2 = rl_block_sum(s2, red) / (float)D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float uh = (su[d] - st.x) * st.y;
      const float x = (gr[d] * gamma[d] - m1 - uh * m2) * st.y;
      const size_t e = (size_t)r * D + d;
      du[e] = x;
      dv[e] = gt_drop(dr, key, (uint32_t)e, x);
    }
    __syncthreads();  // su is the next row's
  }
  float* p = part + (size_t)blockIdx.x * 2 * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    p[d] = cg[d];
    p[D + d] = cb[d];
  }
}

// out[e] = sum over blocks of part[b][e], in block order
__global__ void rl_reduce_kernel(const float* __restrict__ part, int blocks,
                                 int len, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * len + e];
  out[e] = s;
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

extern "C" int gt_k20_bwd_blocks(int R) {
  int rpb = (R + RL_BWD_BLOCKS - 1) / RL_BWD_BLOCKS;
  rpb = rpb > 1 ? rpb : 1;
  const int blocks = (R + rpb - 1) / rpb;
  return blocks > 1 ? blocks : 1;
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
  const size_t bytes = 3 * (size_t)D * sizeof(float);
  cudaError_t err = rl_smem((const void*)rl_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const GtDrop dr{seed, keep24, keep, drop_on};
  const int rpb = (R + blocks - 1) / blocks;
  rl_bwd_kernel<<<blocks, RL_THREADS, bytes, st>>>(
      g, res, res_bf16, res_every, v, gamma, du, dv, part, R, D, rpb, dr,
      gt_stream_key(seed, stream_id));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rl_reduce_kernel<<<(2 * D + 255) / 256, 256, 0, st>>>(part, blocks, 2 * D,
                                                         dgb);
  return (int)cudaGetLastError();
}
