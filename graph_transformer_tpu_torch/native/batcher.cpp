// Native padded-batch assembler: the port's own copy of
// graph_transformer_tpu/native/batcher.cpp, the same C ABI and the same
// std::mt19937_64 draws, so that the two packages' default batches are equal.
//
// The host-side hot path of training: select graphs, gather features,
// sample fixed-fanout neighborhoods with replacement (self at slot 0,
// isolated nodes self-filled — semantics of the reference's per-batch
// Python loop, U2GNN_pytorch/train_pytorch_U2GNN_Sup.py:91-119), expand the
// CSR edge list, and pad everything to static shapes.  One pass, no Python
// object churn; feeds the device input pipeline (with the thread prefetcher
// in train/prefetch.py).
//
// C ABI consumed via ctypes (native/batcher.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

// Returns 0 on success, -1 if nodes exceed n_pad, -2 if edges exceed e_pad.
int batch_assemble(
    // dataset arrays (global ids)
    const int64_t* nbr_offsets,   // [N_total + 1]
    const int32_t* nbr_ids,       // [2E]
    const float* node_feat,       // [N_total, D] row-major
    int64_t feat_dim,
    const int64_t* graph_offsets, // [G + 1]
    // batch selection
    const int64_t* graph_ids, int64_t batch_size,
    int64_t num_neighbors,        // K
    int64_t n_pad, int64_t e_pad,
    uint64_t seed,
    // outputs (caller-allocated)
    float* x,                     // [n_pad, D]
    int32_t* neigh,               // [n_pad, K+1]
    int32_t* graph_id,            // [n_pad]
    int32_t* node_gidx,           // [n_pad]
    float* node_mask,             // [n_pad]
    int32_t* edge_src,            // [e_pad]
    int32_t* edge_dst,            // [e_pad]
    float* edge_mask,             // [e_pad]
    int64_t* out_counts           // [2]: n_real, e_real
) {
  const int64_t k1 = num_neighbors + 1;
  std::mt19937_64 rng(seed);

  // ---- sizes first (overflow check before touching outputs)
  int64_t n_real = 0, e_real = 0;
  for (int64_t b = 0; b < batch_size; ++b) {
    const int64_t g = graph_ids[b];
    const int64_t lo = graph_offsets[g], hi = graph_offsets[g + 1];
    n_real += hi - lo;
    e_real += nbr_offsets[hi] - nbr_offsets[lo];
  }
  out_counts[0] = n_real;
  out_counts[1] = e_real;
  if (n_real > n_pad) return -1;
  if (e_real > e_pad) return -2;

  int64_t vpos = 0, epos = 0;
  for (int64_t b = 0; b < batch_size; ++b) {
    const int64_t g = graph_ids[b];
    const int64_t lo = graph_offsets[g], hi = graph_offsets[g + 1];
    const int64_t shift = vpos - lo;  // global -> batch-local
    for (int64_t v = lo; v < hi; ++v, ++vpos) {
      // features
      std::memcpy(x + vpos * feat_dim, node_feat + v * feat_dim,
                  sizeof(float) * static_cast<size_t>(feat_dim));
      graph_id[vpos] = static_cast<int32_t>(b);
      node_gidx[vpos] = static_cast<int32_t>(v);
      node_mask[vpos] = 1.0f;
      // neighborhood: self + K sampled with replacement
      const int64_t s = nbr_offsets[v], e = nbr_offsets[v + 1];
      const int64_t deg = e - s;
      int32_t* row = neigh + vpos * k1;
      row[0] = static_cast<int32_t>(vpos);
      if (deg > 0) {
        for (int64_t j = 1; j < k1; ++j) {
          const int64_t pick = s + static_cast<int64_t>(rng() % static_cast<uint64_t>(deg));
          row[j] = static_cast<int32_t>(nbr_ids[pick] + shift);
        }
        // edges (CSR expansion, batch-local)
        for (int64_t p = s; p < e; ++p, ++epos) {
          edge_src[epos] = static_cast<int32_t>(v + shift);
          edge_dst[epos] = static_cast<int32_t>(nbr_ids[p] + shift);
          edge_mask[epos] = 1.0f;
        }
      } else {
        for (int64_t j = 1; j < k1; ++j) row[j] = static_cast<int32_t>(vpos);
      }
    }
  }

  // ---- padding
  for (int64_t v = vpos; v < n_pad; ++v) {
    std::memset(x + v * feat_dim, 0, sizeof(float) * static_cast<size_t>(feat_dim));
    graph_id[v] = static_cast<int32_t>(batch_size);
    node_gidx[v] = 0;
    node_mask[v] = 0.0f;
    int32_t* row = neigh + v * k1;
    for (int64_t j = 0; j < k1; ++j) row[j] = static_cast<int32_t>(v);
  }
  for (int64_t p = epos; p < e_pad; ++p) {
    edge_src[p] = 0;
    edge_dst[p] = 0;
    edge_mask[p] = 0.0f;
  }
  return 0;
}

}  // extern "C"
