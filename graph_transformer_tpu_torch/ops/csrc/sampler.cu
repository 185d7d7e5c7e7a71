// K7 — the neighbor sampler of the two-pass training path.
//
// Replaces graph_transformer_tpu/sampling/pallas_sampler.py:_sample_kernel
// (entry sample_neighbor_table, through resample_batch_neighbors_fast).  Per
// node n: K uniform draws from the first min(deg, 128) entries of its row of
// global neighbor ids (degree clamped to [1, 128]: a hub's row holds a
// subsample of its list), output [N, K+1] int32 global ids with the node
// itself in slot 0.  The bits are K1's (common.cuh): stream
// GT_SAMPLER_STREAM, element index n*K + k, so that a codebook dataset gets,
// for one seed, exactly the neighborhoods K1 draws.  The TPU kernel draws all
// 128 columns and its caller keeps K; this one draws only the K it keeps.
//
// Bound on the H100: bytes.  A node costs 8 bytes of degree and id, K
// scattered 4-byte reads in its 512-byte table row and (K+1)*4 bytes of
// output; the hash is ~12 integer operations a draw.  One thread per output
// element, so a warp's writes are consecutive; the reads of a row fall in
// the same few sectors.  At a training batch (a few thousand nodes) the
// launch itself dominates.
#include "common.cuh"

__global__ void __launch_bounds__(256)
gt_sample_kernel(const int* table_rows, int table_w, const int* deg,
                 const int* node_gidx, int* out, int N, int K, uint32_t key) {
  const int K1 = K + 1;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)N * K1) return;
  const int n = (int)(e / K1);
  const int k = (int)(e - (size_t)n * K1);
  if (k == 0) {
    out[e] = node_gidx[n];
    return;
  }
  const uint32_t idx = (uint32_t)n * K + (k - 1);
  const float u = (float)(gt_bits(key, idx) >> 8) * (1.0f / 16777216.0f);
  int dg = deg[n];
  dg = dg < 1 ? 1 : (dg > table_w ? table_w : dg);
  const float df = (float)dg;
  const int di = (int)fminf(floorf(__fmul_rn(u, df)), df - 1.0f);
  out[e] = table_rows[(size_t)n * table_w + di];
}

// table_rows [N, table_w], deg [N], node_gidx [N] int32; out [N, K+1] int32
extern "C" int gt_k7_sample(const int* table_rows, int table_w, const int* deg,
                            const int* node_gidx, int* out, int N, int K,
                            unsigned int seed, void* stream) {
  const size_t total = (size_t)N * (K + 1);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  gt_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table_rows, table_w, deg, node_gidx, out, N, K,
      gt_stream_key(seed, GT_SAMPLER_STREAM));
  return (int)cudaGetLastError();
}
