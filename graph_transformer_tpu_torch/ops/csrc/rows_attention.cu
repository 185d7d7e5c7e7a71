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
// Forward: one block a neighborhood, 8 warps.  Scores s_ij = q_i . k_j /
// sqrt(D) take a warp each, lanes over D (rounded to bf16 first when the
// layer's products are bf16), reduced by shuffles; the softmax of a row
// takes a warp, lanes over the S <= 32 keys; the probabilities are dropped
// at site 0 (element (n*Sq + i)*S + j of the [N, Sq, S] probabilities, Sq =
// S or 1 for the slot-0 last layer), rounded, and the context ctx_i =
// sum_j p_ij v_j takes the block's threads over (i, d).
//
// Backward (ra_bwd_kernel): a neighborhood's q (Sq rows), k, v and dctx rows
// are copied into shared memory once by cp.async (16-byte copies of each
// row's body at the offset within 16 bytes that it has in device memory,
// 4-byte copies of its ragged ends: rows of 3D floats start at any word).
// All 8 warps then sum the Sq*S scores and dattn dot products over their
// columns, RA_JT keys at a time, the warps' sums added in warp order; a warp
// a query row recomputes the probabilities and forms ds = p (dattn - sum
// dattn p) / sqrt(D); dq, dk and dv are summed from the staged rows, a warp a
// run of 256 columns of one output row, and stored once, coalesced (dq is 0
// off slot 0 in the slot-0 layer).  Rows that do not fit RA_BWD_BUDGET are
// staged in column chunks: the dot products summed chunk by chunk, then q, k
// and dctx staged again a chunk for the gradients (from L2).
//
// Bound on the H100: bytes.  At Cora's slot-0 rows (2,816 neighborhoods x S
// = 5, D = 1,433) the forward reads q of slot 0 and k, v and writes ctx,
// 193.7 MB (0.05782 ms at 3.35 TB/s); the backward also reads dctx and
// writes dqkv, 435.8 MB (0.13009 ms); over a full layer (Sq = S) it moves
// 565.1 MB (0.1686 ms).  The operations are 2 S^2 D a neighborhood, far
// below that.
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

// ---------------------------------------------------------------- backward
// Keys (and gradient terms) a pass, and output columns a lane (32 apart)
#define RA_JT 8
#define RA_EPL 8
#define RA_WARPS (RA_THREADS / 32)
// shared memory a block aims at: rows are staged in column chunks past it
#define RA_BWD_BUDGET (232448 / 3)

struct RaBwd {
  const float* qkv;
  const float* dctx;
  float* dqkv;
  int S, Sq, D;
  int dc, nch, pitch;  // chunk columns, chunks, segment pitch
  float scale;
  GtDrop dr;
  uint32_t key;
  int bf;
};

__device__ __forceinline__ void ra_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void ra_cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void ra_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// also a compiler barrier: the reads of the staged rows stay after it
template <int N>
__device__ __forceinline__ void ra_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Staged segment s of neighborhood n from column c0: s < Sq the query rows,
// then S key rows, S value rows, and Sq rows of dctx
__device__ __forceinline__ const float* ra_seg(const RaBwd& a, int n, int s,
                                               int c0) {
  const size_t ld = 3 * (size_t)a.D;
  const float* row = a.qkv + (size_t)n * a.S * ld + c0;
  if (s < a.Sq) return row + (size_t)s * ld;
  s -= a.Sq;
  if (s < a.S) return row + (size_t)s * ld + a.D;
  s -= a.S;
  if (s < a.S) return row + (size_t)s * ld + 2 * a.D;
  return a.dctx + ((size_t)n * a.Sq + s - a.S) * a.D + c0;
}

// Copies the L columns from c0 of neighborhood n's segments into buf, a
// warp a segment: segment s's column d lands at buf[sb[s] + d], at the
// same offset within 16 bytes as in device memory, so that its body moves
// in 16-byte cp.async copies and only its ragged ends in 4-byte ones.
// Without with_v the value rows are left out.
__device__ void ra_stage(const RaBwd& a, float* buf, int* sb, int n, int c0,
                         int L, bool with_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nseg = 2 * (a.Sq + a.S);
  for (int s = warp; s < nseg; s += RA_WARPS) {
    if (!with_v && s >= a.Sq + a.S && s < a.Sq + 2 * a.S) continue;
    const float* src = ra_seg(a, n, s, c0);
    const int off = (int)(((uintptr_t)src >> 2) & 3);
    float* dst = buf + (size_t)s * a.pitch + off;
    if (lane == 0) sb[s] = s * a.pitch + off;
    const int h = min((4 - off) & 3, L);
    const int nb = (L - h) >> 2, e = h + 4 * nb;
    if (lane < h) ra_cp4(dst + lane, src + lane);
    for (int c = lane; c < nb; c += 32)
      ra_cp16(dst + h + 4 * c, src + h + 4 * c);
    if (lane < L - e) ra_cp4(dst + e + lane, src + e + lane);
  }
}

// One halving step of ra_sum16: a lane keeps H of its 2H values, the half
// its lane bit 2H picks, and adds the other lane's copy of that half
template <int H>
__device__ __forceinline__ void ra_halve(float (&v)[16], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// The sums over a warp's 32 lanes of a[0..7] and b[0..7] by halving (16
// shuffles, not 80).  Lane l ends with the sum of value (l >> 1) & 7 of a
// (l < 16) or of b; lanes l and l ^ 1 hold the same.
__device__ __forceinline__ float ra_sum16(const float (&a)[RA_JT],
                                          const float (&b)[RA_JT]) {
  const int lane = threadIdx.x & 31;
  float v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = a[k];
    v[8 + k] = b[k];
  }
  ra_halve<8>(v, lane);
  ra_halve<4>(v, lane);
  ra_halve<2>(v, lane);
  ra_halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Each warp's sums over its columns of the chunk of the scores q_i . k_j
// and of dattn dc_i . v_j into red[warp][2 (i S + j) + {0, 1}] (set by the
// first chunk, added to by the others): every warp takes the block's
// columns d = threadIdx.x + 256 m, RA_JT keys at a time (past S, the last
// key's row again: the inner loop has no branch, so its loads issue
// together)
template <bool BF>
__device__ void ra_dots(const RaBwd& a, const float* buf, const int* sb,
                        int L, float* red, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S;
  float* r = red + warp * 2 * a.Sq * S;
  for (int i = 0; i < a.Sq; ++i) {
    const float* q = buf + sb[i];
    const float* dc = buf + sb[a.Sq + 2 * S + i];
    for (int j0 = 0; j0 < S; j0 += RA_JT) {
      const int nj = min(RA_JT, S - j0);
      int ko[RA_JT], vo[RA_JT];
#pragma unroll
      for (int jj = 0; jj < RA_JT; ++jj) {
        const int j = j0 + min(jj, nj - 1);
        ko[jj] = sb[a.Sq + j];
        vo[jj] = sb[a.Sq + S + j];
      }
      float sc[RA_JT], da[RA_JT];
#pragma unroll
      for (int jj = 0; jj < RA_JT; ++jj) sc[jj] = da[jj] = 0.f;
      for (int d = threadIdx.x; d < L; d += RA_THREADS) {
        const float qd = gt_rn(q[d], BF), cd = gt_rn(dc[d], BF);
#pragma unroll
        for (int jj = 0; jj < RA_JT; ++jj) {
          sc[jj] = fmaf(qd, gt_rn(buf[ko[jj] + d], BF), sc[jj]);
          da[jj] = fmaf(cd, gt_rn(buf[vo[jj] + d], BF), da[jj]);
        }
      }
      // the 16 sums over the warp's lanes in 16 shuffles: even lane 2 jj
      // ends with key jj's score sum, lane 16 + 2 jj with its dattn sum
      const float t = ra_sum16(sc, da);
      const int jj = (lane >> 1) & 7;
      if (!(lane & 1) && jj < nj) {
        float* o = r + 2 * (i * S + j0 + jj) + (lane >> 4);
        *o = first ? t : *o + t;
      }
    }
  }
}

// The warps' sums in warp order, then the softmax and its backward, a
// query row a warp, lanes over the keys: sds = rounded ds = p (dattn -
// sum dattn p) / sqrt(D), sad = the rounded dropped probabilities
__device__ void ra_softmax_bwd(const RaBwd& a, int n, const float* red,
                               float* sds, float* sad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, SS = a.Sq * S;
  const uint32_t e0 = (uint32_t)((size_t)n * SS);
  for (int i = warp; i < a.Sq; i += RA_WARPS) {
    const int p = i * S + lane;
    float v = -INFINITY, dt = 0.f;
    if (lane < S) {
      float s = 0.f, t = 0.f;
      for (int w = 0; w < RA_WARPS; ++w) {
        s += red[w * 2 * SS + 2 * p];
        t += red[w * 2 * SS + 2 * p + 1];
      }
      v = s * a.scale;
      dt = gt_drop(a.dr, a.key, e0 + p, t);
    }
    const float mx = ra_max(v);
    const float e = lane < S ? expf(v - mx) : 0.f;
    const float pr = e / ra_sum(e);
    const float rs = ra_sum(dt * pr);
    if (lane < S) {
      sds[p] = gt_rn(pr * (dt - rs) * a.scale, a.bf);
      sad[p] = gt_rn(gt_drop(a.dr, a.key, e0 + p, pr), a.bf);
    }
  }
}

// dq_j (j < Sq, else 0), dk_j and dv_j over the chunk's L columns from c0,
// stored to dqkv: a warp a run of 32 RA_EPL columns of one output row part,
// each a sum of terms coefficient x staged row (dq_j = sum_jj ds_j,jj k_jj,
// dk_j = sum_i ds_i,j q_i, dv_j = sum_i sad_i,j dctx_i) in order, RA_JT
// terms' coefficients and rows read first; columns past L read column L - 1,
// so that a term's RA_EPL loads issue together
template <bool BF>
__device__ void ra_grads(const RaBwd& a, int n, const float* buf,
                         const int* sb, const float* sds, const float* sad,
                         int c0, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, Sq = a.Sq;
  const size_t ld = 3 * (size_t)a.D;
  const int nrun = (L + 32 * RA_EPL - 1) / (32 * RA_EPL);
  for (int it = warp; it < 3 * S * nrun; it += RA_WARPS) {
    const int so = it / nrun, run = it - so * nrun;
    const int j = so / 3, part = so - 3 * j;
    const int d0 = run * 32 * RA_EPL + lane;
    const int terms = part == 0 ? (j < Sq ? S : 0) : Sq;
    // term t: coefficient cf[t * cs], staged row sb[rb + t]
    const float* cf = part == 0 ? sds + j * S : (part == 1 ? sds : sad) + j;
    const int cs = part == 0 ? 1 : S;
    const int rb = part == 0 ? Sq : (part == 1 ? 0 : Sq + 2 * S);
    int dd[RA_EPL];
    float acc[RA_EPL];
#pragma unroll
    for (int e = 0; e < RA_EPL; ++e) {
      dd[e] = min(d0 + 32 * e, L - 1);
      acc[e] = 0.f;
    }
    if (terms == 1) {
      const float c = cf[0];
      const float* row = buf + sb[rb];
#pragma unroll
      for (int e = 0; e < RA_EPL; ++e)
        acc[e] = fmaf(c, gt_rn(row[dd[e]], BF), 0.f);
    } else {
      for (int t0 = 0; t0 < terms; t0 += RA_JT) {
        const int nt = min(RA_JT, terms - t0);
        float c[RA_JT];
        int ro[RA_JT];
#pragma unroll
        for (int tt = 0; tt < RA_JT; ++tt) {
          const int t = t0 + min(tt, nt - 1);
          c[tt] = cf[t * cs];
          ro[tt] = sb[rb + t];
        }
#pragma unroll
        for (int tt = 0; tt < RA_JT; ++tt)
          if (tt < nt)
#pragma unroll
            for (int e = 0; e < RA_EPL; ++e)
              acc[e] = fmaf(c[tt], gt_rn(buf[ro[tt] + dd[e]], BF), acc[e]);
      }
    }
    float* out = a.dqkv + ((size_t)n * S + j) * ld + (size_t)part * a.D + c0;
#pragma unroll
    for (int e = 0; e < RA_EPL; ++e)
      if (d0 + 32 * e < L) out[d0 + 32 * e] = acc[e];
  }
}

// A block a neighborhood, its rows staged in shared memory once a chunk:
// the score and dattn sums over all warps, the softmax backward, then dqkv
// from the staged rows (past one chunk, from the last chunk back, the q, k
// and dctx rows of the others staged again).  A few blocks share an SM, so
// one's copies overlap another's arithmetic.
template <bool BF>
__global__ void __launch_bounds__(RA_THREADS) ra_bwd_kernel(RaBwd a) {
  extern __shared__ __align__(16) float buf[];
  const int nseg = 2 * (a.Sq + a.S), SS = a.Sq * a.S;
  float* red = buf + (size_t)nseg * a.pitch;  // [RA_WARPS][2 SS]
  float* sds = red + RA_WARPS * 2 * SS;
  float* sad = sds + SS;
  int* sb = (int*)(sad + SS);  // [nseg]
  const int n = blockIdx.x;
  for (int c = 0; c < a.nch; ++c) {
    const int c0 = c * a.dc, L = min(a.dc, a.D - c0);
    ra_stage(a, buf, sb, n, c0, L, true);
    ra_commit();
    ra_wait<0>();
    __syncthreads();
    ra_dots<BF>(a, buf, sb, L, red, c == 0);
    __syncthreads();
  }
  ra_softmax_bwd(a, n, red, sds, sad);
  __syncthreads();
  for (int c = a.nch - 1; c >= 0; --c) {  // the last chunk is still staged
    const int c0 = c * a.dc, L = min(a.dc, a.D - c0);
    if (c < a.nch - 1) {
      ra_stage(a, buf, sb, n, c0, L, false);
      ra_commit();
      ra_wait<0>();
      __syncthreads();
    }
    ra_grads<BF>(a, n, buf, sb, sds, sad, c0, L);
    __syncthreads();
  }
}

// the backward's shared memory at pitch floats a segment
static size_t ra_bwd_smem(int S, int Sq, int pitch) {
  const size_t nseg = 2 * (size_t)(S + Sq), SS = (size_t)S * Sq;
  return nseg * (4 * (size_t)pitch + 4) + 4 * (RA_WARPS * 2 + 2) * SS;
}

// a segment's pitch: L columns at any offset within 16 bytes
static int ra_pitch(int L) { return (L + 3 + 3) & ~3; }

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
  RaBwd a{qkv, dctx, dqkv, S, slot0 ? 1 : S, D, D, 1, ra_pitch(D),
          scale, GtDrop{seed, keep24, keep, drop_on},
          gt_stream_key(seed, stream_id), bf};
  // the fewest column chunks that fit the budget (past any budget, chunks
  // of 4 columns: S = 32 at 227 KB)
  for (int k = 2; ra_bwd_smem(S, a.Sq, a.pitch) > RA_BWD_BUDGET && a.dc > 4;
       ++k) {
    a.dc = ((D + k - 1) / k + 3) & ~3;
    a.nch = (D + a.dc - 1) / a.dc;
    a.pitch = ra_pitch(a.dc);
  }
  const size_t bytes = ra_bwd_smem(S, a.Sq, a.pitch);
  const void* kernel = bf ? (const void*)ra_bwd_kernel<true>
                          : (const void*)ra_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchKernel(kernel, dim3(N), dim3(RA_THREADS), args,
                               bytes, (cudaStream_t)stream);
}
