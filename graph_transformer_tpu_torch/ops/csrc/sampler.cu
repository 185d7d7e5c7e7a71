// K7 — the two-pass training path's sampling stage in one launch.
//
// Replaces graph_transformer_tpu/sampling/pallas_sampler.py:_sample_kernel
// (entry sample_neighbor_table, through resample_batch_neighbors_fast) and
// the feature gather and the global re-gather scratch the JAX trainer and
// model build around it (graph_transformer_tpu/train/sup_trainer.py:164-167,
// graph_transformer_tpu/ops/sparse.py:110-148).  For each slot k of batch
// row n (K+1 slots, the node itself in slot 0) it draws a neighbor id v and
// writes
//   - ids   [N, K+1] int32, v (only when asked),
//   - slots [N, K+1] int64, v's batch row: n + v - node_gidx[n] for a real
//     row (node_mask > 0; graphs are disjoint and a graph's nodes sit in
//     the batch in global order, data/batching.py), n for a padding row,
//   - feat  [N, K+1, D], x_global's row v, in x_global's dtype.
// A draw is K1's (common.cuh): stream GT_SAMPLER_STREAM, element n*K + k-1,
// entry min(floor(u*d), d-1) of the node's table row, d = clamp(deg, 1, 128);
// a hub's row holds a subsample of its list.  The TPU kernel draws all 128
// columns and its caller keeps K, and the JAX trainer then gathers the
// features by global id and re-gathers each deeper layer's through a
// dataset-sized scratch, because batch-local ids cost narrow gathers on the
// TPU.  Here the slots come with the draws, so the model re-gathers by
// out[slots] on the batch.
//
// Bound on the H100: bytes.  The feature rows written dominate (at DD's
// counts 41,472 slots x 356 bytes); the reads are one 32-byte sector a draw
// in the table, the drawn rows of x_global, and a few bytes a row.  A block
// takes `per` consecutive slots: its first `per` threads hash one slot each
// (a warp's ids and slots land in consecutive words) and put v in shared
// memory; then all 256 threads copy the block's rows in units of 16, 8, 4 or
// 2 bytes (the largest that divides the row and both pointers), consecutive
// threads on consecutive output bytes.  Every read goes through the
// read-only path; the table rows are read by node_gidx, so the batch needs
// no gathered copy of them.  At a training batch the launch and the chain of
// dependent reads (node id, degree, table entry, feature row) set the time.
#include "common.cuh"

#define GT_K7_THREADS 256
// copy units a block takes at most (so a wide row gets fewer slots a block)
#define GT_K7_UNITS 2048

template <typename U>
__global__ void __launch_bounds__(GT_K7_THREADS)
gt_sample_kernel(const int* __restrict__ table, int table_w,
                 const int* __restrict__ deg, int by_gidx,
                 const int* __restrict__ node_gidx,
                 const float* __restrict__ node_mask,
                 const U* __restrict__ x, int units, U* __restrict__ feat,
                 long long* __restrict__ slots, int* __restrict__ ids, int N,
                 int K, int per, const long long* seed) {
  const uint32_t key = gt_stream_key(gt_seed_at(seed), GT_SAMPLER_STREAM);
  __shared__ int s_id[GT_K7_THREADS];
  const int K1 = K + 1;
  const long long s0 = (long long)blockIdx.x * per;
  const long long left = (long long)N * K1 - s0;
  const int here = left < per ? (int)left : per;
  const int t = threadIdx.x;
  if (t < here) {
    const long long e = s0 + t;
    const int n = (int)(e / K1);
    const int k = (int)(e - (long long)n * K1);
    const int g = __ldg(node_gidx + n);
    int v = g;
    if (k > 0) {
      const int row = by_gidx ? g : n;
      const uint32_t idx = (uint32_t)n * K + (k - 1);
      const float u = (float)(gt_bits(key, idx) >> 8) * (1.0f / 16777216.0f);
      int dg = __ldg(deg + row);
      dg = dg < 1 ? 1 : (dg > table_w ? table_w : dg);
      const float df = (float)dg;
      const int di = (int)fminf(floorf(__fmul_rn(u, df)), df - 1.0f);
      v = __ldg(table + (size_t)row * table_w + di);
    }
    s_id[t] = v;
    if (ids) ids[e] = v;
    if (slots)
      slots[e] = __ldg(node_mask + n) > 0.0f ? (long long)n + v - g
                                             : (long long)n;
  }
  if (!x) return;
  __syncthreads();
  U* out = feat + s0 * units;
  for (int c = t; c < here * units; c += GT_K7_THREADS) {
    const int s = c / units;
    out[c] = __ldg(x + (size_t)s_id[s] * units + (c - s * units));
  }
}

template <typename U>
static void launch_k7(const int* table, int table_w, const int* deg,
                      int by_gidx, const int* node_gidx,
                      const float* node_mask, const void* x, int row_bytes,
                      void* feat, long long* slots, int* ids, int N, int K,
                      const long long* seed, cudaStream_t stream) {
  const int units = x ? row_bytes / (int)sizeof(U) : 0;
  int per = units ? GT_K7_UNITS / units : GT_K7_THREADS;
  per = per < 1 ? 1 : (per > GT_K7_THREADS ? GT_K7_THREADS : per);
  const long long total = (long long)N * (K + 1);
  const unsigned int blocks = (unsigned int)((total + per - 1) / per);
  gt_sample_kernel<U><<<blocks, GT_K7_THREADS, 0, stream>>>(
      table, table_w, deg, by_gidx, node_gidx, node_mask, (const U*)x, units,
      (U*)feat, slots, ids, N, K, per, seed);
}

// table [*, table_w] int32 and deg [*] int32, read at row node_gidx[n]
// (by_gidx) or at row n; node_gidx [N] int32; node_mask [N] float32 (with
// slots); x [*, row_bytes] (or null: no features) and feat [N, K+1,
// row_bytes]; slots [N, K+1] int64 and ids [N, K+1] int32, each or null.
extern "C" int gt_k7_sample(const int* table, int table_w, const int* deg,
                            int by_gidx, const int* node_gidx,
                            const float* node_mask, const void* x,
                            int row_bytes, void* feat, long long* slots,
                            int* ids, int N, int K, const long long* seed,
                            void* stream) {
  if ((long long)N * (K + 1) == 0) return 0;
  if (!seed) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the widest unit that divides the row and both pointers
  const uintptr_t a = (uintptr_t)row_bytes | (uintptr_t)x | (uintptr_t)feat
                      | 16u;
  switch (x ? (int)(a & (~a + 1)) : 16) {
    case 16:
      launch_k7<uint4>(table, table_w, deg, by_gidx, node_gidx, node_mask, x,
                       row_bytes, feat, slots, ids, N, K, seed, st);
      break;
    case 8:
      launch_k7<uint2>(table, table_w, deg, by_gidx, node_gidx, node_mask, x,
                       row_bytes, feat, slots, ids, N, K, seed, st);
      break;
    case 4:
      launch_k7<unsigned int>(table, table_w, deg, by_gidx, node_gidx,
                              node_mask, x, row_bytes, feat, slots, ids, N, K,
                              seed, st);
      break;
    default:
      launch_k7<unsigned short>(table, table_w, deg, by_gidx, node_gidx,
                                node_mask, x, row_bytes, feat, slots, ids, N,
                                K, seed, st);
  }
  return (int)cudaGetLastError();
}
