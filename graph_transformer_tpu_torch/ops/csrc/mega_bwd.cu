// K14 — the whole-stack recompute backward in one row launch (D <= 32), and
// K14w — the same for rows of 32 < D <= 128, a warp per row.
//
// Replaces graph_transformer_tpu/ops/pallas_u2gnn.py:_bwd_kernel (entry
// _bwd_rule_mega, fused_u2gnn_encoder(..., mega_bwd=True)).  Contract: the
// encoder input rows x [N*S, D] and the saved inputs of layers 1..T-1
// (xs [T-1, N*S, D]), both in bf16 or f32 (x_bf16), the slot-0 cotangent
// dout [N, D] f32, the 12 stacked parameters (timestep t reads slice
// t % stored), seed and rate -> dx [N*S, D] f32 and the 12 stacked weight
// gradients [stored, P] f32.  Products take operands in the rows' dtype.
//
// Each block walks t = T-1..0 over its own neighborhoods: it recomputes
// layer t's forward from the layer's saved input (the slot-0 layer for
// t = T-1) with the forward's layer code, then runs the layer's backward
// body, which K8 (K8w) runs for one layer: recompute.cuh and layer_bwd.cuh
// (wide_recompute.cuh).  The dropout masks replay sites 4t..4t+3 of the
// seed, as K4t/K4tw draw them.  The cotangent carried between layers stays
// with the block: it lives in dx, updated in place, each row read (as the
// layer's dout) and written (as its dx) only by its own block, the read
// ahead of the write across a block barrier.  The recomputed residuals go
// to scratch that only the block touches; the slot-0 layer's probabilities
// and strip (indexed by neighborhood) have their own, so that no block
// overwrites what another block's slot-0 layer still reads.
//
// Weight gradients, with no float atomics (runs repeat bit for bit):
//   K14: each block writes one row of partial gradients per layer; a second
//        kernel sums, for each stored slice, each of its layers' partials
//        in block order and the layers from the last to the first — the
//        order of the per-layer chain (K8s, then K8, summed by the host in
//        that order).  Where its blocks hold as many neighborhoods as K8's
//        and K8s's (shared memory sets each kernel's), it gives the chain's
//        gradients bit for bit.
//   K14w: the row launch writes each layer's four per-row product factors,
//        bias partials and recomputed residuals (strip, FFN hidden) to that
//        layer's own scratch; then, for each layer, K8w's split-K weight
//        products and partial sums run over them (a split-K launch per
//        layer: the four products of a layer read that layer's [rows, F]
//        hidden and its cotangent, which one launch over the stacked
//        hidden would read all the same, and the per-layer products are
//        K8w's own, tested code); then the slices sum their layers as
//        above.
//
// Bound on the H100: operations.  At the A/B workload (79,488 rows, S=9,
// D=4, F=1024, T=4, bf16) the T recomputed forwards and backwards are
// ~12 GFLOP of bf16 products (~13 us at 989 TFLOP/s) against ~4 MB of
// rows, saved inputs, cotangents and gradients.  K14 runs K8's forward
// layer (its FFN on the tensor cores, as every forward layer's) and K8's
// body, whose FFN runs on the tensor cores (layer_bwd.cuh), in one launch
// at the body's shared memory; the recomputed residuals round-trip device
// memory (mostly L2).  K14w's row products run on the tensor cores through
// K8w's routine (WdMmaGemm, wide_mma.cuh), so that it repeats the K8w
// chain bit for bit, and so do its split-K products (wd_products).
#include "recompute.cuh"
#include "wide_recompute.cuh"

static inline size_t gt_mega_smem_bytes(int G, int S, int D) {
  const size_t a = gt_recompute_smem_bytes(G, S, D, false);
  const size_t b = gt_recompute_smem_bytes(G, S, D, true);
  return a > b ? a : b;
}

extern "C" size_t gt_k14_smem_bytes(int G, int S, int D) {
  return gt_mega_smem_bytes(G, S, D);
}

// the layer t input: x for t = 0, else slice t-1 of xs
__host__ __device__ inline const void* gt_layer_input(const void* x,
                                                      const void* xs,
                                                      int x_bf16, int t,
                                                      size_t NS, int D) {
  if (t == 0) return x;
  return (const char*)xs + (size_t)(t - 1) * NS * D * (x_bf16 ? 2 : 4);
}

// Scratch of K14: q/k/v [N*S, 3D] of every layer; probabilities and strip
// of the full layers [N*S, S], [N*S, 4D+2] and of the slot-0 layer [N, S],
// [N, 4D+2]
struct GtMegaScratch {
  float *qkv, *attn_full, *strip_full, *attn_last, *strip_last;
};

template <int DM>
__global__ void __launch_bounds__(GT_BWD_THREADS)
gt_mega_bwd_kernel(const void* x, const void* xs, int x_bf16,
                   const float* dout, GtStack st, GtDrop dr, float* dx,
                   GtMegaScratch sc, float* partial, int N, int S, int D,
                   int F, int T, int G, float scale) {
  extern __shared__ float smem[];
  const int r = threadIdx.x;
  const int g = r / S;
  const int i = r - g * S;
  const int n = blockIdx.x * G + g;
  const bool valid = (r < G * S) && (n < N);
  const size_t NS = (size_t)N * S;
  const int P = gt_grad_offsets(D, F).P;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    const void* xt = gt_layer_input(x, xs, x_bf16, t, NS, D);
    const GtLayer w = gt_layer_at(st, t, D, F);
    float xr[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) xr[d] = 0.f;
    if (valid) gt_load_row<DM>(xt, x_bf16, (size_t)n * S + i, D, xr);
    GtLayerOut lo = {};
    lo.qkv = sc.qkv;
    lo.attn = last ? sc.attn_last : sc.attn_full;
    lo.strip = last ? sc.strip_last : sc.strip_full;
    lo.out = nullptr;
    // begins with a barrier: the previous layer's body is done with shared
    // memory
    gt_fwd_layer<DM>(smem, w, dr, t, last, lo, xr, N, S, D, F, G, scale,
                     x_bf16);
    // the residuals are the block's own rows; the body begins with a
    // barrier, after which every thread of the block sees them
    __threadfence_block();
    float* part = partial + ((size_t)blockIdx.x * T + t) * P;
    if (last)
      gt_layer_bwd_body<DM, true>(smem, xt, x_bf16, sc.qkv, sc.attn_last,
                                  sc.strip_last, dout, w, dr, t, dx, part, N,
                                  S, D, F, G, scale, x_bf16);
    else
      gt_layer_bwd_body<DM, false>(smem, xt, x_bf16, sc.qkv, sc.attn_full,
                                   sc.strip_full, dx, w, dr, t, dx, part, N,
                                   S, D, F, G, scale, x_bf16);
  }
}

// grads [stored, P]: slice s sums its layers t (t % stored == s) from the
// last to the first, each layer's nblk partial rows (part [nblk, T, P]) in
// block order
__global__ void gt_mega_reduce_kernel(const float* part, int nblk, int T,
                                      int stored, int P, float* grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (p >= P) return;
  float acc = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    if (t % stored != s) continue;
    float l = 0.f;
    for (int b = 0; b < nblk; ++b) l += part[((size_t)b * T + t) * P + p];
    acc += l;
  }
  grads[(size_t)s * P + p] = acc;
}

static cudaError_t gt_mega_reduce(const float* part, int nblk, int T,
                                  int stored, int P, float* grads,
                                  cudaStream_t stream) {
  const dim3 grid((P + 255) / 256, stored);
  gt_mega_reduce_kernel<<<grid, 256, 0, stream>>>(part, nblk, T, stored, P,
                                                  grads);
  return cudaGetLastError();
}

// the recompute's forward layer is K8's chain's, so that K14 repeats the
// chain bit for bit
template <int DM>
static cudaError_t gt_launch_mega(const void* x, const void* xs, int x_bf16,
                                  const float* dout, const GtStack& st,
                                  const GtDrop& dr, float* dx,
                                  const GtMegaScratch& sc, float* partial,
                                  float* grads, int N, int S, int D, int F,
                                  int T, int G, float scale,
                                  cudaStream_t stream) {
  if (G < 1 || G * S > GT_BWD_THREADS) return cudaErrorInvalidValue;
  const size_t smem = gt_mega_smem_bytes(G, S, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gt_mega_bwd_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + G - 1) / G;
  gt_mega_bwd_kernel<DM><<<blocks, GT_BWD_THREADS, smem, stream>>>(
      x, xs, x_bf16, dout, st, dr, dx, sc, partial, N, S, D, F, T, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gt_mega_reduce(partial, blocks, T, st.stored,
                        gt_grad_offsets(D, F).P, grads, stream);
}

// K14.  x [N*S, D], xs [T-1, N*S, D] (null when T == 1), both bf16 if
// x_bf16 else f32; dout [N, D] f32; scratch: qkv [N*S, 3D], attn_full
// [N*S, S], strip_full [N*S, 4D+2], attn_last [N, S], strip_last
// [N, 4D+2], partial [ceil(N/G), T, P]; out: dx [N*S, D] f32, grads
// [stored, P] (KERNEL_ORDER, flattened per slice)
extern "C" int gt_k14_mega_bwd(const void* x, const void* xs, int x_bf16,
                               const float* dout, const float* const* params,
                               int stored, float* dx, float* qkv,
                               float* attn_full, float* strip_full,
                               float* attn_last, float* strip_last,
                               float* partial, float* grads, int N, int S,
                               int D, int F, int T, int G, float scale,
                               unsigned int seed, unsigned int keep24,
                               float keep, int drop_on, void* stream) {
  const GtStack st = gt_make_stack(params, stored);
  const GtDrop dr{seed, keep24, keep, drop_on};
  const GtMegaScratch sc{qkv, attn_full, strip_full, attn_last, strip_last};
  cudaStream_t s = (cudaStream_t)stream;
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (D <= 4) return (int)gt_launch_mega<4>(x, xs, x_bf16, dout, st, dr, dx, sc, partial, grads, N, S, D, F, T, G, scale, s);
  if (D <= 8) return (int)gt_launch_mega<8>(x, xs, x_bf16, dout, st, dr, dx, sc, partial, grads, N, S, D, F, T, G, scale, s);
  if (D <= 16) return (int)gt_launch_mega<16>(x, xs, x_bf16, dout, st, dr, dx, sc, partial, grads, N, S, D, F, T, G, scale, s);
  if (D <= 32) return (int)gt_launch_mega<32>(x, xs, x_bf16, dout, st, dr, dx, sc, partial, grads, N, S, D, F, T, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ K14w
// floats before the tensor-core products' staging region: the row bodies'
// shared memory for either kind of layer, to a 16-byte boundary
__host__ __device__ inline size_t wd_mega_stage_offset(int G, int S, int D) {
  const size_t a = wd_mma_stage_offset(G, S, D, false);
  const size_t b = wd_mma_stage_offset(G, S, D, true);
  return a > b ? a : b;
}

extern "C" size_t gt_k14w_smem_bytes(int G, int S, int D) {
  return sizeof(float) * (wd_mega_stage_offset(G, S, D) + WM_STAGE_FLOATS);
}

// The device memory of K14w: T per-layer regions, each laid out by
// wd_bwd_work (recompute) — the full layers 0..T-2 at multiples of a full
// layer's size, the slot-0 layer after them — then the per-layer
// gradients [T, P] f32.
struct WdMegaLayout {
  size_t full, last, grads_off, total;
};

static WdMegaLayout wd_mega_layout(int N, int S, int D, int F, int G, int T,
                                   int bf) {
  WdBwdWork w;
  WdMegaLayout l;
  l.full = wd_bwd_work(N, S, D, F, G, false, bf, true, nullptr, &w);
  l.last = wd_bwd_work(N, S, D, F, G, true, bf, true, nullptr, &w);
  l.grads_off = (size_t)(T - 1) * l.full + l.last;
  l.total = l.grads_off +
            ((size_t)T * gt_grad_offsets(D, F).P * 4 + 255) / 256 * 256;
  return l;
}

extern "C" size_t gt_k14w_work_bytes(int N, int S, int D, int F, int G,
                                     int T, int x_bf16) {
  return wd_mega_layout(N, S, D, F, G, T, x_bf16).total;
}

// w with every pointer moved on by `bytes`: the layout of a region that
// begins `bytes` later
__host__ __device__ inline WdBwdWork wd_shift(WdBwdWork w, size_t bytes) {
  w.dqkv = (char*)w.dqkv + bytes;
  w.da = (char*)w.da + bytes;
  w.dh = (char*)w.dh + bytes;
  w.dz = (char*)w.dz + bytes;
  w.small = (float*)((char*)w.small + bytes);
  w.split = (float*)((char*)w.split + bytes);
  w.qkv = (float*)((char*)w.qkv + bytes);
  w.attn = (float*)((char*)w.attn + bytes);
  w.strip = (float*)((char*)w.strip + bytes);
  w.h = (char*)w.h + bytes;
  return w;
}

// The row launch: per layer, last first, K8w's recompute and row body
// into the layer's region (wfull shifted by t * stride for a full layer,
// wlast for the slot-0 layer), with K8w's tensor-core products, so that it
// repeats the K8w chain bit for bit.
__global__ void __launch_bounds__(WD_THREADS, 2)
wd_mega_bwd_kernel(const void* x, const void* xs, int x_bf16,
                   const float* dout, GtStack st, GtDrop dr, float* dx,
                   WdBwdWork wfull, size_t stride, WdBwdWork wlast, int N,
                   int S, int D, int F, int T, int G, float scale) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * G;
  const int Gv = min(G, N - n0);
  const size_t row0 = (size_t)n0 * S;
  const size_t NS = (size_t)N * S;
  const size_t es = x_bf16 ? 2 : 4;
  const WdMmaGemm mma{smem + wd_mega_stage_offset(G, S, D)};
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    const WdBwdWork wk = last ? wlast : wd_shift(wfull, (size_t)t * stride);
    const size_t q0 = last ? (size_t)n0 : row0;
    const void* xt = gt_layer_input(x, xs, x_bf16, t, NS, D);
    const GtLayer w = gt_layer_at(st, t, D, F);
    __syncthreads();  // the previous layer's body is done with shared memory
    wd_load_rows(smem, xt, x_bf16, row0, Gv * S, D);
    WdLayerRes res;
    res.qkv = wk.qkv + row0 * 3 * D;
    res.attn = wk.attn + q0 * S;
    res.strip = wk.strip + q0 * (4 * D + 2);
    res.h = (char*)wk.h + q0 * F * es;
    res.h_bf16 = x_bf16;
    res.out = nullptr;
    wd_fwd_layer(smem, w, dr, t, last, res, N, S, D, F, G, scale, x_bf16,
                 mma);
    // the residuals are the block's own rows; the body begins with a
    // barrier, after which every thread of the block sees them
    __threadfence_block();
    if (last)
      wd_bwd_body<true>(smem, wk.qkv, wk.attn, wk.strip, wk.h, dout, w, dr,
                        t, dx, wk, N, S, D, F, G, scale, x_bf16, mma);
    else
      wd_bwd_body<false>(smem, wk.qkv, wk.attn, wk.strip, wk.h, dx, w, dr, t,
                         dx, wk, N, S, D, F, G, scale, x_bf16, mma);
  }
}

// K14w.  x, xs, dout, dx and grads as K14; work: gt_k14w_work_bytes(...)
// bytes
extern "C" int gt_k14w_mega_bwd(const void* x, const void* xs, int x_bf16,
                                const float* dout,
                                const float* const* params, int stored,
                                float* dx, void* work, float* grads, int N,
                                int S, int D, int F, int T, int G,
                                float scale, unsigned int seed,
                                unsigned int keep24, float keep, int drop_on,
                                void* stream) {
  if (D > WD_MAXD || S > 32 || G < 1 || G * S > 32 || T < 1)
    return (int)cudaErrorInvalidValue;
  const GtStack st = gt_make_stack(params, stored);
  const GtDrop dr{seed, keep24, keep, drop_on};
  cudaStream_t s = (cudaStream_t)stream;
  const WdMegaLayout l = wd_mega_layout(N, S, D, F, G, T, x_bf16);
  char* base = (char*)work;
  WdBwdWork wfull, wlast;
  wd_bwd_work(N, S, D, F, G, false, x_bf16, true, base, &wfull);
  wd_bwd_work(N, S, D, F, G, true, x_bf16, true,
              base + (size_t)(T - 1) * l.full, &wlast);
  float* lgrads = (float*)(base + l.grads_off);
  const size_t smem = gt_k14w_smem_bytes(G, S, D);
  cudaError_t e = cudaFuncSetAttribute(
      wd_mega_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + G - 1) / G;
  wd_mega_bwd_kernel<<<blocks, WD_THREADS, smem, s>>>(
      x, xs, x_bf16, dout, st, dr, dx, wfull, l.full, wlast, N, S, D, F, T, G,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t NS = (size_t)N * S;
  const int P = gt_grad_offsets(D, F).P;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    const WdBwdWork wk = last ? wlast : wd_shift(wfull, (size_t)t * l.full);
    const void* xt = gt_layer_input(x, xs, x_bf16, t, NS, D);
    e = wd_bwd_products(xt, wk.strip, wk.h, wk, lgrads + (size_t)t * P, N, S,
                        D, F, G, last, x_bf16, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)gt_mega_reduce(lgrads, 1, T, stored, P, grads, s);
}
