// K19 — single-head attention over each neighborhood's S <= 32 slots at any
// D, forward and backward, for the encoder layer past D = 128
// (ops/rows_encoder.py).
//
// Stands in, past D = 128, for the attention inside the TPU kernels
// graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (:266, call :429) and
// _bwd1_kernel (:316, call :361), ops/pallas_encoder.py:_fwd_kernel (:196,
// call :355) and _bwd_kernel (:214, call :386).  Those hold a neighborhood's
// q/k/v rows in VMEM with the rest of the layer; here the Q/K/V product is
// K18's, and this kernel reads its [N*S, 3D] float32 output.
//
// One block a neighborhood, 8 warps.  Scores s_ij = q_i . k_j / sqrt(D) take
// a warp each, lanes over D (rounded to bf16 first when the layer's products
// are bf16), reduced by shuffles; the softmax of a row takes a warp, lanes
// over the S <= 32 keys; the probabilities are dropped at site 0 (element
// (n*Sq + i)*S + j of the [N, Sq, S] probabilities, Sq = S or 1 for the
// slot-0 last layer), rounded, and the context ctx_i = sum_j p_ij v_j takes
// the block's threads over (i, d).  The backward recomputes the
// probabilities with the same code, then dattn, ds = p (dattn - sum dattn p)
// / sqrt(D), and dq, dk, dv row by row, writing dqkv [N*S, 3D] (dq is 0 off
// slot 0 in the slot-0 layer).
//
// Bound on the H100: reading q/k/v (and dctx) once, at Cora's rows (2,816
// neighborhoods x S = 5, D = 1,433) 242 MB, 0.072 ms at 3.35 TB/s; the
// operations are 2 S^2 D a neighborhood, far below that.  q and k rows are
// read once a pair through L1; a block's loads are the cost.
#include "common.cuh"

#define RA_THREADS 256
#define RA_MAX_S 32

__device__ __forceinline__ float ra_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float ra_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sp[i*S + j] = softmax_j(q_i . k_j * scale), the undropped probabilities of
// the neighborhood whose rows start at base (row stride ld)
__device__ void ra_probs(const float* __restrict__ base, size_t ld, int S,
                         int Sq, int D, int bf, float scale, float* sp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int p = warp; p < Sq * S; p += nw) {
    const int i = p / S, j = p - i * S;
    const float* q = base + (size_t)i * ld;
    const float* k = base + (size_t)j * ld + D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(gt_rn(__ldg(q + d), bf), gt_rn(__ldg(k + d), bf), acc);
    acc = ra_sum(acc);
    if (lane == 0) sp[p] = acc * scale;
  }
  __syncthreads();
  for (int i = warp; i < Sq; i += nw) {
    const float v = lane < S ? sp[i * S + lane] : -INFINITY;
    const float mx = ra_max(v);
    const float e = lane < S ? expf(v - mx) : 0.f;
    const float s = ra_sum(e);
    if (lane < S) sp[i * S + lane] = e / s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RA_THREADS)
    ra_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ ctx,
                  int S, int D, int slot0, int bf, float scale, GtDrop dr,
                  uint32_t key) {
  __shared__ float sp[RA_MAX_S * RA_MAX_S];
  const int n = blockIdx.x, Sq = slot0 ? 1 : S;
  const size_t ld = 3 * (size_t)D;
  const float* base = qkv + (size_t)n * S * ld;
  ra_probs(base, ld, S, Sq, D, bf, scale, sp);
  const uint32_t e0 = (uint32_t)((size_t)n * Sq * S);
  for (int e = threadIdx.x; e < Sq * S; e += blockDim.x)
    sp[e] = gt_rn(gt_drop(dr, key, e0 + e, sp[e]), bf);
  __syncthreads();
  const float* v = base + 2 * D;
  for (int e = threadIdx.x; e < Sq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    float acc = 0.f;
    for (int j = 0; j < S; ++j)
      acc = fmaf(sp[i * S + j], gt_rn(__ldg(v + (size_t)j * ld + d), bf), acc);
    ctx[((size_t)n * Sq + i) * D + d] = acc;
  }
}

__global__ void __launch_bounds__(RA_THREADS)
    ra_bwd_kernel(const float* __restrict__ qkv,
                  const float* __restrict__ dctx, float* __restrict__ dqkv,
                  int S, int D, int slot0, int bf, float scale, GtDrop dr,
                  uint32_t key) {
  __shared__ float sa[RA_MAX_S * RA_MAX_S];   // probabilities
  __shared__ float sd[RA_MAX_S * RA_MAX_S];   // dattn, then rounded ds
  __shared__ float sad[RA_MAX_S * RA_MAX_S];  // rounded dropped probabilities
  const int n = blockIdx.x, Sq = slot0 ? 1 : S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t ld = 3 * (size_t)D;
  const float* base = qkv + (size_t)n * S * ld;
  const float* dc = dctx + (size_t)n * Sq * D;
  const uint32_t e0 = (uint32_t)((size_t)n * Sq * S);
  ra_probs(base, ld, S, Sq, D, bf, scale, sa);
  for (int p = warp; p < Sq * S; p += nw) {
    const int i = p / S, j = p - i * S;
    const float* v = base + (size_t)j * ld + 2 * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(gt_rn(__ldg(dc + (size_t)i * D + d), bf),
                 gt_rn(__ldg(v + d), bf), acc);
    acc = ra_sum(acc);
    if (lane == 0) sd[p] = gt_drop(dr, key, e0 + p, acc);
  }
  for (int e = threadIdx.x; e < Sq * S; e += blockDim.x)
    sad[e] = gt_rn(gt_drop(dr, key, e0 + e, sa[e]), bf);
  __syncthreads();
  for (int i = warp; i < Sq; i += nw) {
    const float a = lane < S ? sa[i * S + lane] : 0.f;
    const float dt = lane < S ? sd[i * S + lane] : 0.f;
    const float rs = ra_sum(dt * a);
    if (lane < S) sd[i * S + lane] = gt_rn(a * (dt - rs) * scale, bf);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < S * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    if (j < Sq)
      for (int jj = 0; jj < S; ++jj)
        dq = fmaf(sd[j * S + jj],
                  gt_rn(__ldg(base + (size_t)jj * ld + D + d), bf), dq);
    for (int i = 0; i < Sq; ++i) {
      dk = fmaf(sd[i * S + j], gt_rn(__ldg(base + (size_t)i * ld + d), bf),
                dk);
      dv = fmaf(sad[i * S + j], gt_rn(__ldg(dc + (size_t)i * D + d), bf), dv);
    }
    float* out = dqkv + ((size_t)n * S + j) * ld;
    out[d] = dq;
    out[D + d] = dk;
    out[2 * D + d] = dv;
  }
}

// ctx [N*Sq, D] from qkv [N*S, 3D] (f32); dropout of site 0 (stream_id =
// 4*layer)
extern "C" int gt_k19_attn_fwd(const float* qkv, float* ctx, int N, int S,
                               int D, int slot0, int bf, float scale,
                               unsigned int seed, unsigned int stream_id,
                               unsigned int keep24, float keep, int drop_on,
                               void* stream) {
  if (S < 1 || S > RA_MAX_S) return (int)cudaErrorInvalidValue;
  const GtDrop dr{seed, keep24, keep, drop_on};
  ra_fwd_kernel<<<N, RA_THREADS, 0, (cudaStream_t)stream>>>(
      qkv, ctx, S, D, slot0, bf, scale, dr, gt_stream_key(seed, stream_id));
  return (int)cudaGetLastError();
}

// dqkv [N*S, 3D] from qkv and dctx [N*Sq, D] (f32)
extern "C" int gt_k19_attn_bwd(const float* qkv, const float* dctx,
                               float* dqkv, int N, int S, int D, int slot0,
                               int bf, float scale, unsigned int seed,
                               unsigned int stream_id, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  if (S < 1 || S > RA_MAX_S) return (int)cudaErrorInvalidValue;
  const GtDrop dr{seed, keep24, keep, drop_on};
  ra_bwd_kernel<<<N, RA_THREADS, 0, (cudaStream_t)stream>>>(
      qkv, dctx, dqkv, S, D, slot0, bf, scale, dr,
      gt_stream_key(seed, stream_id));
  return (int)cudaGetLastError();
}
