// Native log-uniform (Zipfian) candidate sampler, the host-side twin of
// graph_transformer_tpu_torch/sampling/log_uniform.py.
//
// The same math as the reference's C++ extension
// (U2GNN_pytorch/log_uniform/Log_Uniform_Sampler.cpp):
//
//   P(k)       = (log(k+2) - log(k+1)) / log(N+1)
//   draw       = floor(exp(u * log(N+1))) - 1,  u ~ U(0,1)
//   E[count]   = -expm1(num_tries * log1p(-P(k)))
//   unique     = rejection until `size` distinct ids, counting tries
//
// mt19937_64 seeded with the caller's seed (1111 by default, as the
// reference): the same seed gives the same draws as any other build of this
// file.  Exposed through a minimal C ABI consumed via ctypes
// (native/log_uniform_native.py).  Single-threaded by design: candidate
// sampling for training runs on the device; this exists for tests.

#include <cmath>
#include <cstdint>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

struct Sampler {
  int64_t vocab;
  double log_vocab_p1;  // log(N + 1)
  std::mt19937_64 rng;
  std::uniform_real_distribution<double> unif{0.0, 1.0};

  explicit Sampler(int64_t n, uint64_t seed)
      : vocab(n), log_vocab_p1(std::log(static_cast<double>(n) + 1.0)),
        rng(seed) {}

  double probability(int64_t k) const {
    return (std::log(static_cast<double>(k) + 2.0) -
            std::log(static_cast<double>(k) + 1.0)) /
           log_vocab_p1;
  }

  int64_t draw() {
    double u = unif(rng);
    auto v = static_cast<int64_t>(std::floor(std::exp(u * log_vocab_p1))) - 1;
    if (v < 0) v = 0;
    if (v >= vocab) v = vocab - 1;
    return v;
  }

  // Rejection-to-unique; returns the number of tries consumed.
  int64_t sample_unique(int64_t size, int64_t* out) {
    std::unordered_set<int64_t> seen;
    seen.reserve(static_cast<size_t>(size) * 2);
    int64_t tries = 0;
    while (static_cast<int64_t>(seen.size()) < size) {
      ++tries;
      int64_t v = draw();
      if (seen.insert(v).second) {
        out[seen.size() - 1] = v;
      }
    }
    return tries;
  }
};

}  // namespace

extern "C" {

void* lus_create(int64_t vocab, uint64_t seed) {
  return new Sampler(vocab, seed);
}

void lus_destroy(void* h) { delete static_cast<Sampler*>(h); }

double lus_probability(void* h, int64_t k) {
  return static_cast<Sampler*>(h)->probability(k);
}

// Fills out[size]; returns num_tries.
int64_t lus_sample_unique(void* h, int64_t size, int64_t* out) {
  return static_cast<Sampler*>(h)->sample_unique(size, out);
}

// I.i.d. draws (with replacement) into out[size].
void lus_sample(void* h, int64_t size, int64_t* out) {
  auto* s = static_cast<Sampler*>(h);
  for (int64_t i = 0; i < size; ++i) out[i] = s->draw();
}

// out[i] = -expm1(num_tries * log1p(-P(ids[i]))) — expected candidate counts.
void lus_expected_count(void* h, double num_tries, const int64_t* ids,
                        int64_t n, double* out) {
  auto* s = static_cast<Sampler*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = -std::expm1(num_tries * std::log1p(-s->probability(ids[i])));
  }
}

// Accidental hits: pairs (row, col) where samples[col] == labels[row].
// Returns the number of hits written (capped at max_out).
int64_t lus_accidental_matches(const int64_t* labels, int64_t n_labels,
                               const int64_t* samples, int64_t n_samples,
                               int64_t* out_rows, int64_t* out_cols,
                               int64_t max_out) {
  int64_t n = 0;
  for (int64_t i = 0; i < n_labels; ++i) {
    for (int64_t j = 0; j < n_samples; ++j) {
      if (labels[i] == samples[j]) {
        if (n < max_out) {
          out_rows[n] = i;
          out_cols[n] = j;
        }
        ++n;
      }
    }
  }
  return n < max_out ? n : max_out;
}

}  // extern "C"
