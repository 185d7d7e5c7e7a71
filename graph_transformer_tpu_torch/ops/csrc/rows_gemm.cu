// K18 — a tiled matrix product with fused epilogues, the products of the
// encoder layer past D = 128 (ops/rows_encoder.py).
//
// Stands in, past D = 128, for the products inside the TPU kernels
// graph_transformer_tpu/ops/pallas_u2gnn.py:_fwd_kernel (:266, call :429) and
// _bwd1_kernel (:316, call :361), ops/pallas_encoder.py:_fwd_kernel (:196,
// call :355) and _bwd_kernel (:214, call :386), ops/pallas_ffn.py:_fwd_kernel
// (:70, call :250) and _bwd_kernel (:97, call :274): the Q/K/V, output and
// FFN products of the forward, the row products of the backward (A Bᵀ) and
// the weight gradients (Aᵀ B over all rows).  The TPU kernels hold a whole
// layer in VMEM; at D = 1,433 a layer's rows do not fit a block's shared
// memory, so the layer runs as products (this kernel), the neighborhood
// attention (K19, rows_attention.cu) and the residual LayerNorm (K20,
// rows_ln.cu), with the intermediates in device memory.
//
// C[M, N] = op(A) op(B), A(m, k) = a[m*sam + k*sak], B(k, n) = b[k*sbk +
// n*sbn], output row m at c + m*ldc: the operands and the output may be
// views with a row stride (the slot-0 layer forms q from slot 0's rows,
// every S-th row of x, and writes q and k, v into the columns of one
// [N*S, 3D] buffer).  The epilogue, in the plain version's order: + bias[n],
// ReLU, dropout of the [M, N] output at (seed, stream), x (gate > 0) /
// gate_keep, + add (rows m % add_every == 0 read add row m / add_every);
// dropout, gate and add index the logical [M, N] output.  The weight
// gradients split K (all rows) into a fixed number of chunks, each block
// writing its chunk's partial tile, then rg_reduce_kernel sums the chunks in
// chunk order: no float atomics, so runs repeat bit for bit.  rg_colsum
// gives the bias gradients (column sums of B) the same way.
//
// Float32 products (float32 operands) run on the tensor cores as 3xTF32
// (rg_tf32_kernel): each operand element x is split once into hi = tf32(x)
// and lo = tf32(x - hi) (cvt.rna's rounding), and wgmma m64n128k8 sums
// lo*hi + hi*lo + hi*hi in float32, ~22 of float32's 24 mantissa bits a
// product (one TF32 pass keeps 11, and would change the function).  Each
// step of 32 of K sums from zero, and the step's sums are then added to the
// output's float32 sums on the CUDA cores: the tensor cores do not round
// their additions to nearest, and one accumulator chained over K = 1,433
// measured 30x the per-step sums' distance from float64 on the H100,
// missing the float32 rule (PERF.md, PR 17; tests/test_torch_rows_gemm.py
// emulates both).  Tiles of 128 x 128 a block, two warpgroups of 64 x 128,
// 32 of K a step, through a ring of RG_RING staged tiles: each operand's
// lines (rows or columns along k, or k along them, as the operand lies in
// device memory) are copied as the 16-byte chunks that cover them, by
// cp.async (rows of D = 1,433 words start at any word: a line's first
// element lies rg_off words into its first chunk; 4-byte copies measured
// slower, and rows padded to a multiple of 4 words no faster).  B is split
// once into TF32 high parts and remainders, K-major 8 x 4 core matrices
// (the transpose of an operand contiguous along n happens there), read by
// wgmma through shared-memory descriptors; A's fragments are split in the
// registers of their one warpgroup.  While a step's products run, the next
// tile's B is split and a later tile's copies are issued; each thread's
// copy sources and shared-memory offsets are computed once a block.
//
// bf16 products take float32 or bf16 operands in device memory, in any mix
// and layout, in two passes.  rg_pack_kernel rounds each operand once a
// launch to bf16 (to nearest even, as the plain version's
// .to(torch.bfloat16)) into packed tiles: 256 rows of A or 128 columns of B
// by 32 of K a tile, 64 bytes a row in the layout wgmma reads (K-major,
// 64-byte swizzle), zeros past the matrix, tiles in order (a tile a
// thread block, read along the operand's contiguous dimension, written as
// 16-byte chunks).  rg_wgmma_bf16_kernel then runs
// 256 x 128 output tiles, two warpgroups of 128 x 128 (two m64n128k16
// products each a 16 of K), both operands read from shared memory through
// descriptors; one thread keeps RB_STAGES steps' tiles in flight, a step's
// A and B tile as two bulk copies of the copy engine counted on the
// stage's mbarrier; a stage is refilled once both warpgroups' products of
// it are done; the output goes through shared memory so that the epilogue
// reads and writes whole rows.  Staging float32 rows that start at any
// word (rows of 1,433 words; no tensor map) and rounding them inside the
// product kernel instead moved each element through shared memory four
// times and held k, v above 1 ms, slower than torch's product (PERF.md);
// packed, the product kernel copies whole tiles and rounds nothing.
// Sum order: one float32 accumulator chained over the block's K (16 of K
// an instruction, in K order); the weight products split K into chunks
// (rg_bf16_chunks) summed in chunk order by rg_reduce_kernel.  The float32
// rule does not bind bf16 products (their rules are check_bf16_spread and
// cosine > 0.999 on the leaves); tests/test_torch_rows_gemm.py emulates
// this order against float64 on bf16-rounded operands at K = 1,433 and
// 14,080.
//
// Bound on the H100: at Cora's width (14,080 rows, D = 1,433, F = 1,024)
// the products are operations-bound.  The node step's largest, k and v over
// every row ([14,080 x 1,433] . [1,433 x 2,866], 1.16e11 FLOP on 242 MB as
// float32), takes 0.70 ms as 3xTF32 at 495 TFLOP/s, 1.73 ms at the CUDA
// cores' 67, against 0.07 ms of bytes; in bf16 0.117 ms at 989 TFLOP/s,
// against 0.065 ms of bytes (x as bf16, the weight and the output as
// float32: 218 MB).  The float32 design reads 3.6 GB of tiles from L2 for
// that product, and its loads alone take 2.8 ms there (PERF.md, PR 17; a
// bulk copy a line, the copy engine without a tensor map, which rows of
// 1,433 words cannot have, was twice as slow): larger tiles, which the two
// sets of sums leave no registers for, or tiles shared across a cluster
// are the later step.  The bf16 product kernel reads 1.37 GB of packed
// tiles from L2 at k, v, which bounds it there (PERF.md).
#include "common.cuh"

#define RG_BM 128
#define RG_BN 128
#define RG_BK 32       // K a step
#define RG_THREADS 256
#define RG_RING 3      // float32 kernel: staged tiles in flight
#define RG_TILE 4608   // float32 kernel: words of a staged operand tile (128
                       // lines of 36, 32 of 132) or of its TF32 parts
// the float32 kernel's shared memory: RG_RING staged tiles of A and of B,
// and two of B's TF32 high parts and remainders (184,320 bytes at a ring
// of 3: one block an SM)
#define RG_SMEM_F32 ((RG_RING + 2) * 2 * RG_TILE * (int)sizeof(float))

struct RgArgs {
  const void* a;
  const void* b;
  float* c;
  int M, N, K;
  long long sam, sak, sbk, sbn, ldc;
  const float* bias;
  int relu;
  const float* gate;
  float gate_inv;
  const float* add;
  int add_every;
  GtDrop dr;
  uint32_t key;
  int kchunk;      // K a z-block takes
  float* partial;  // [chunks, M, N] when the product is split, else null
};

__device__ __forceinline__ float rg_ld(const void* p, int bf, size_t i) {
  if (bf)
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg((const unsigned short*)p + i)));
  return __ldg((const float*)p + i);
}

// one output: the partial of a split product, or the epilogue and C
__device__ __forceinline__ void rg_store(const RgArgs& g, int m, int n,
                                         float v) {
  if (m >= g.M || n >= g.N) return;
  const size_t e = (size_t)m * g.N + n;
  if (g.partial) {
    g.partial[(size_t)blockIdx.z * g.M * g.N + e] = v;
    return;
  }
  if (g.bias) v = v + g.bias[n];
  if (g.relu) v = v > 0.f ? v : 0.f;
  if (g.dr.on) v = gt_drop(g.dr, g.key, (uint32_t)e, v);
  if (g.gate) v = v * (g.gate[e] > 0.f ? g.gate_inv : 0.f);
  if (g.add && m % g.add_every == 0)
    v = g.add[(size_t)(m / g.add_every) * g.N + n] + v;
  g.c[(size_t)m * g.ldc + n] = v;
}

// ----------------------------------------------------------- float32
// 16-byte asynchronous copy global -> shared of src's first `bytes` bytes,
// the rest zero-filled
__device__ __forceinline__ void rg_cp16(float* dst, const float* src,
                                        int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void rg_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// also a compiler barrier: the shared-memory reads of the copied tiles stay
// after it
template <int N>
__device__ __forceinline__ void rg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero, on the 13 low mantissa bits), in two integer operations
__device__ __forceinline__ uint32_t rg_rna(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// x's TF32 high part and the TF32 remainder
__device__ __forceinline__ void rg_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rg_rna(__float_as_uint(x));
  lo = rg_rna(__float_as_uint(x - __uint_as_float(hi)));
}

// An operand's tile is staged as lines of words contiguous in device
// memory, RG_LW(KC) words apart: KC (contiguous along k) 128 lines, its
// rows or columns r, of 32 k each; otherwise 32 lines, k, of 128 r each.
// A line is copied as the 16-byte aligned chunks that cover it, so its
// first element lies rg_off(its address) words into the staged line; the
// chunks' words past the line's range are zero-filled.
#define RG_CH(KC) ((KC) ? 9 : 33)  // chunks a staged line
#define RG_LW(KC) (4 * RG_CH(KC))  // words a staged line
#define RG_NL(KC) ((KC) ? 128 : 32)

struct RgOp {
  const float* p;  // element (r = 0, k = 0) of the block's tile
  long long ls;    // words from a line to the next
  int rows;        // r < rows lie in the matrix
};

// the first element of line `line` at K offset kb
template <bool KC>
__device__ __forceinline__ const float* rg_line(const RgOp& op, int line,
                                               int kb) {
  return KC ? op.p + line * op.ls + kb : op.p + (kb + line) * op.ls;
}

__device__ __forceinline__ int rg_off(const float* p) {
  return (int)((uintptr_t)p >> 2) & 3;
}

// this thread's copies of an operand's tile at K offset kb (k < k1)
template <bool KC>
__device__ __forceinline__ void rg_issue(float* dst, const RgOp& op, int kb,
                                         int k1) {
  constexpr int C = RG_CH(KC), T = RG_NL(KC) * C;
  const int count = KC ? min(32, k1 - kb) : min(128, op.rows);
  const float* safe = (const float*)((uintptr_t)op.p & ~(uintptr_t)15);
#pragma unroll
  for (int i = 0; i < (T + RG_THREADS - 1) / RG_THREADS; ++i) {
    const int idx = threadIdx.x + i * RG_THREADS;
    if (idx < T) {
      const int line = idx / C, c = idx - line * C;
      const bool ok = KC ? line < op.rows : kb + line < k1;
      const float* fp = rg_line<KC>(op, ok ? line : 0, kb);
      const int w = ok ? min(4, max(0, count + rg_off(fp) - 4 * c)) : 0;
      const float* src =
          (const float*)((uintptr_t)fp & ~(uintptr_t)15) + 4 * c;
      rg_cp16(dst + 4 * idx, w ? src : safe, 4 * w);
    }
  }
}

// A full step's copies change only by a shift along k, which keeps each
// line's word offset: this thread's chunks are planned once a block (their
// sources at k0 as word offsets from op.p, their bytes), and a step adds
// the shift; rg_issue serves the last, partial step.
#define RG_NI 5  // chunks a thread an operand: ceil(128 * 9 / 256)
struct RgPlan {
  int off[RG_NI];  // word offset of the chunk's source at k0, from op.p
  int bytes[RG_NI];
};

template <bool KC>
__device__ __forceinline__ RgPlan rg_plan(const RgOp& op, int k0) {
  constexpr int C = RG_CH(KC), T = RG_NL(KC) * C;
  const int count = KC ? 32 : min(128, op.rows);
  RgPlan pl;
#pragma unroll
  for (int i = 0; i < RG_NI; ++i) {
    const int idx = threadIdx.x + i * RG_THREADS;
    const int line = idx / C, c = idx - line * C;
    const bool ok = idx < T && (!KC || line < op.rows);
    const float* fp = rg_line<KC>(op, ok ? line : 0, k0);
    const float* src =
        (const float*)((uintptr_t)fp & ~(uintptr_t)15) + 4 * c;
    pl.off[i] = (int)(src - op.p);
    pl.bytes[i] = ok ? 4 * min(4, max(0, count + rg_off(fp) - 4 * c)) : 0;
  }
  return pl;
}

// a full step's copies, shifted `shift` words from k0's
template <bool KC>
__device__ __forceinline__ void rg_issue_full(float* dst, const RgOp& op,
                                              const RgPlan& pl,
                                              long long shift) {
  constexpr int T = RG_NL(KC) * RG_CH(KC);
  const float* safe = (const float*)((uintptr_t)op.p & ~(uintptr_t)15);
#pragma unroll
  for (int i = 0; i < RG_NI; ++i) {
    const int idx = threadIdx.x + i * RG_THREADS;
    if (idx < T)
      rg_cp16(dst + 4 * idx, pl.bytes[i] ? op.p + pl.off[i] + shift : safe,
              pl.bytes[i]);
  }
}

// B's TF32 parts for the tensor cores: K-major 8 x 4 core matrices,
// element (n, k) at word (n / 8) * RG_SBO + (k / 4) * RG_LBO + (n % 8) * 4 +
// k % 4 (a warp's 32 stores of one core matrix land on 32 banks)
#define RG_LBO 36   // words between core matrices along k (128 B + 16)
#define RG_SBO 288  // words between core matrices along n
__device__ __forceinline__ int rg_boff(int n, int k) {
  return (n >> 3) * RG_SBO + (k >> 2) * RG_LBO + (n & 7) * 4 + (k & 3);
}

// shared-memory matrix descriptor of a K-major B slice of 8 of K (no
// swizzle): start address, leading (k) and stride (n) byte offsets
__device__ __forceinline__ uint64_t rg_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(RG_LBO * 4 >> 4) << 16) |
         ((uint64_t)(RG_SBO * 4 >> 4) << 32);
}

__device__ __forceinline__ void rg_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void rg_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void rg_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving the accumulators' reads and writes across
// the asynchronous products
__device__ __forceinline__ void rg_fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b over 64 x 128 x 8: a the warpgroup's TF32 A fragment in
// registers (warp w rows 16 w .. +15, as mma.sync m16n8k8's), b a K-major
// shared-memory slice; scale_d 0 ignores d
__device__ __forceinline__ void rg_wgmma(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

template <bool AK, bool BK>
__global__ void __launch_bounds__(RG_THREADS, 1)
    rg_tf32_kernel(RgArgs g) {
  gt_read_seed(g.dr, g.key);
  // [RG_RING][A, B] staged tiles, then [2][B high, B remainder]
  extern __shared__ __align__(128) float rg_smem[];
  float* bparts = rg_smem + RG_RING * 2 * RG_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * RG_BM, n0 = blockIdx.x * RG_BN;
  const int k0 = blockIdx.z * g.kchunk;
  const int k1 = min(g.K, k0 + g.kchunk);
  // A's lines: rows m (AK) or k; B's: columns n (BK) or k
  const RgOp opa{(const float*)g.a + m0 * (AK ? g.sam : 1LL),
                 AK ? g.sam : g.sak, g.M - m0};
  const RgOp opb{(const float*)g.b + n0 * (BK ? g.sbn : 1LL),
                 BK ? g.sbn : g.sbk, g.N - n0};

  const RgPlan pla = rg_plan<AK>(opa, k0), plb = rg_plan<BK>(opb, k0);
  auto issue = [&](int kb, int slot) {
    float* As = rg_smem + slot * 2 * RG_TILE;
    if (kb + RG_BK <= k1) {
      const long long d = kb - k0;
      rg_issue_full<AK>(As, opa, pla, AK ? d : d * opa.ls);
      rg_issue_full<BK>(As + RG_TILE, opb, plb, BK ? d : d * opb.ls);
    } else {
      rg_issue<AK>(As, opa, kb, k1);
      rg_issue<BK>(As + RG_TILE, opb, kb, k1);
    }
  };
  // Where this thread reads and writes, the same every step (a step's shift
  // along k keeps each line's word offset).  B's split: element i of 16 is
  // (n, k) = (8 warp + lane / 4 + 64 (i % 2), 4 (i / 2) + lane % 4), read
  // at braw + 4 (i / 2) (KC) or + 528 (i / 2) (a line of 132 words) + 64
  // (i % 2) from its staged line, written at bpart + 2304 (i % 2) + 36 (i /
  // 2) as a core-matrix element.  A warp writes one core matrix a store.
  const int bn = 8 * warp + (lane >> 2);
  int braw[2];
  if (BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      braw[h] = (bn + 64 * h) * RG_LW(true) +
                rg_off(rg_line<true>(opb, bn + 64 * h, k0)) + tq;
  } else {
    braw[0] = tq * RG_LW(false) + rg_off(rg_line<false>(opb, tq, k0)) + bn;
    braw[1] = braw[0] + 64;
  }
  const int bpart = rg_boff(bn, tq);
  // B of the tile in slot, landed: its TF32 high parts and remainders into
  // bparts[pb], then visible to the tensor cores
  auto split_b = [&](int slot, int pb) {
    const float* Bs = rg_smem + slot * 2 * RG_TILE + RG_TILE;
    float* Bh = bparts + pb * 2 * RG_TILE;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float x =
          Bs[braw[i & 1] + (BK ? 4 : 4 * RG_LW(false)) * (i >> 1)];
      uint32_t hi, lo;
      rg_split(x, hi, lo);
      const int o = bpart + 8 * RG_SBO * (i & 1) + RG_LBO * (i >> 1);
      Bh[o] = __uint_as_float(hi);
      Bh[RG_TILE + o] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // warpgroup wg: rows 64 wg .. +63; its warp q: rows 16 q .. +15 of them;
  // this thread's fragment rows ra and ra + 8, read at araw (+ 8 kk + 4 h
  // along k) from their staged lines (AK), or at araw + (8 kk + 4 h) * 132
  // (+ 8 for row ra + 8) from the k lines
  const int wg = warp >> 2, q = warp & 3;
  const int ra = wg * 64 + q * 16 + gq;
  int araw[2];
  if (AK) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      araw[h] = (ra + 8 * h) * RG_LW(true) +
                rg_off(rg_line<true>(opa, ra + 8 * h, k0)) + tq;
  } else {
    araw[0] = tq * RG_LW(false) + rg_off(rg_line<false>(opa, tq, k0)) + ra;
    araw[1] = araw[0] + 8;
  }
  float acc[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;
  const int steps = k1 > k0 ? (k1 - k0 + RG_BK - 1) / RG_BK : 0;
#pragma unroll
  for (int st = 0; st < RG_RING - 1; ++st) {
    if (st < steps) issue(k0 + st * RG_BK, st);
    rg_commit();
  }
  if (steps > 0) {
    rg_wait<RG_RING - 2>();
    __syncthreads();
    split_b(0, 0);
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const float* As = rg_smem + (t % RG_RING) * 2 * RG_TILE;
    const float* Bh = bparts + (t & 1) * 2 * RG_TILE;
    // A's fragments of the step, split: a0 (ra, k), a1 (ra + 8, k), a2
    // (ra, k + 4), a3 (ra + 8, k + 4), k = 8 kk + tq
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int dk = (8 * kk + 4 * h) * (AK ? 1 : RG_LW(false));
        rg_split(As[araw[0] + dk], ah[kk][2 * h], al[kk][2 * h]);
        rg_split(As[araw[1] + dk], ah[kk][2 * h + 1], al[kk][2 * h + 1]);
      }
    // lo*hi, hi*lo, hi*hi over each 8 of K, from zero: the step's sums
    rg_fence_regs(s);
    rg_wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = rg_desc(Bh + 2 * kk * RG_LBO);
      const uint64_t bl = rg_desc(Bh + RG_TILE + 2 * kk * RG_LBO);
      rg_wgmma(s, al[kk], bh, kk > 0);
      rg_wgmma(s, ah[kk], bl, 1);
      rg_wgmma(s, ah[kk], bh, 1);
    }
    rg_wg_commit();
    // while they run: B's split of tile t + 1, then the copies of tile t +
    // RG_RING - 1 (after the split's proxy fence, which waits for this
    // thread's copies in flight)
    if (t + 1 < steps) {
      rg_wait<RG_RING - 3>();
      __syncthreads();
      split_b((t + 1) % RG_RING, (t + 1) & 1);
    }
    const int nxt = t + RG_RING - 1;
    if (nxt < steps) issue(k0 + nxt * RG_BK, nxt % RG_RING);
    rg_commit();
    rg_wg_wait();
    rg_fence_regs(s);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += s[i];
    __syncthreads();
  }
  rg_wait<0>();
  // acc[4 j + e]: row ra + 8 (e / 2), column 8 j + 2 t + e % 2
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rg_store(g, m0 + ra + 8 * (e >> 1), n0 + 8 * j + 2 * tq + (e & 1),
               acc[4 * j + e]);
}

// -------------------------------------------------------------- bf16
// The operands' bf16 tiles, rounded once by rg_pack_kernel: for an operand
// of R rows or columns r and K of k, tile rt of TR rows (RB_BM for A, RB_BN
// for B) and step s (32 of K) is one block of TR x 64 bytes, row rr at byte
// 64 rr holding k = 32 s .. 32 s + 31 as four 16-byte chunks, chunk c at
// position c ^ ((rr / 2) % 4) (the 64-byte swizzle wgmma reads: the 8 rows
// of an atom land on 32 banks); blocks in order (rt, s), zeros past R and
// K.
#define RB_BM 256
#define RB_BN 128
#define RB_THREADS 256             // two warpgroups of 128 rows
#define RB_STAGES 6                // tiles in flight a block
#define RB_TILE_A (RB_BM * 64)     // bytes of a packed A tile: 16,384
#define RB_TILE_B (RB_BN * 64)     // 8,192
#define RB_CT (RB_BN + 4)  // floats a row of the output tile in the epilogue
static_assert(RB_BM * RB_CT * 4 <= RB_STAGES * (RB_TILE_A + RB_TILE_B),
              "the epilogue's tile fits the stages' room");
// the stages, their barriers, and room to align them to 1,024 bytes (the
// swizzle's pattern follows address bits): 148,528 bytes, one block an SM
#define RG_SMEM_BF16 \
  (RB_STAGES * (RB_TILE_A + RB_TILE_B) + 8 * RB_STAGES + 1024)

// 16-byte chunks of an operand's packed tiles
static inline long long rb_chunks(int R, int K, int tr) {
  return (long long)((R + tr - 1) / tr) * ((K + 31) / 32) * tr * 4;
}

// the aligned 32-bit word at base + b, with only its bytes in [o, end) (the
// rest zero; a half word where the range starts or ends inside it)
__device__ __forceinline__ uint32_t rb_word(const char* base, int b, int o,
                                            int end) {
  if (b >= end || b + 4 <= o) return 0u;
  if (b >= o && b + 4 <= end) return __ldg((const uint32_t*)(base + b));
  if (b < o)
    return (uint32_t)__ldg((const unsigned short*)(base + b + 2)) << 16;
  return __ldg((const unsigned short*)(base + b));
}

// half index of element (rr, kk) in a packed tile
__device__ __forceinline__ int rb_half(int rr, int kk) {
  return 32 * rr + 8 * ((kk >> 3) ^ ((rr >> 1) & 3)) + (kk & 7);
}

// The packed tile (rt, s) = blockIdx.x of the operand X(r, k) = x[r sr +
// k sk] (KC: contiguous along k, sk = 1; else sr = 1), TR rows, into shared
// memory at its packed place, then written as 16-byte chunks.  Its elements
// are read by consecutive lanes along the operand's contiguous dimension (a
// row's 32 k, or a k line's rows), every load first.  float32 (BF false):
// an element a lane, rounded to bf16 (to nearest even).  bf16: a pair a
// lane, as the aligned 32-bit word holding its first byte and the next
// lane's word shifted (rows start at any 2-byte boundary); no rounding.
template <bool KC, int TR, bool BF>
__global__ void __launch_bounds__(256)
    rg_pack_kernel(const void* __restrict__ x, int R, int K, long long sr,
                   long long sk, uint4* __restrict__ out) {
  __shared__ __align__(16) unsigned short tile[TR * 32];
  const int steps = (K + 31) / 32;
  const long long rt = blockIdx.x / steps;
  const int k0 = (int)(blockIdx.x - rt * steps) * 32;
  const long long r0 = rt * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (!BF) {
    constexpr int NE = TR * 32 / 256;  // elements a thread
    float v[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int i = threadIdx.x + 256 * j;
      const int rr = KC ? i >> 5 : i % TR, kk = KC ? i & 31 : i / TR;
      const long long r = r0 + rr;
      const int k = k0 + kk;
      v[j] = r < R && k < K
                 ? __ldg((const float*)x + (r * sr + (long long)k * sk))
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int i = threadIdx.x + 256 * j;
      tile[KC ? rb_half(i >> 5, i & 31) : rb_half(i % TR, i / TR)] =
          __bfloat16_as_ushort(__float2bfloat16(v[j]));
    }
  } else if constexpr (KC) {
    // 16 lanes a row (lane h: k = 2 h, 2 h + 1), 16 rows a pass
    constexpr int NP = TR / 16;
    const int h = lane & 15, cnt = min(32, K - k0);
    uint32_t w[NP], ex[NP];
    int o[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const long long r = r0 + 16 * p + 2 * warp + (lane >> 4);
      w[p] = ex[p] = 0u;
      o[p] = 0;
      if (r < R) {
        const char* e0 = (const char*)x + (r * sr + k0) * 2;
        o[p] = (int)((uintptr_t)e0 & 3);
        w[p] = rb_word(e0 - o[p], 4 * h, o[p], o[p] + 2 * cnt);
        if (h == 15) ex[p] = rb_word(e0 - o[p], 64, o[p], o[p] + 2 * cnt);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint32_t nx = __shfl_down_sync(0xffffffffu, w[p], 1);
      const uint32_t pr =
          o[p] ? __funnelshift_r(w[p], h == 15 ? ex[p] : nx, 16) : w[p];
      const int rr = 16 * p + 2 * warp + (lane >> 4);
      *(uint32_t*)&tile[rb_half(rr, 2 * h)] = pr;
    }
  } else {
    // a k line a warp at a time (warp w: lines w + 8 q), lane l the rows
    // 2 l, 2 l + 1 of each 64
    constexpr int NQ = 4, NC = TR / 64;
    uint32_t w[NQ][NC], ex[NQ][NC];
    int o[NQ][NC];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int k = k0 + warp + 8 * q;
        const int cnt = (int)min(64LL, R - (r0 + 64 * c));
        w[q][c] = ex[q][c] = 0u;
        o[q][c] = 0;
        if (k < K && cnt > 0) {
          const char* e0 = (const char*)x + ((long long)k * sk + r0 + 64 * c) * 2;
          o[q][c] = (int)((uintptr_t)e0 & 3);
          w[q][c] = rb_word(e0 - o[q][c], 4 * lane, o[q][c], o[q][c] + 2 * cnt);
          if (lane == 31)
            ex[q][c] = rb_word(e0 - o[q][c], 128, o[q][c], o[q][c] + 2 * cnt);
        }
      }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t nx = __shfl_down_sync(0xffffffffu, w[q][c], 1);
        const uint32_t pr =
            o[q][c] ? __funnelshift_r(w[q][c], lane == 31 ? ex[q][c] : nx, 16)
                    : w[q][c];
        const int kk = warp + 8 * q, rr = 64 * c + 2 * lane;
        tile[rb_half(rr, kk)] = (unsigned short)pr;
        tile[rb_half(rr + 1, kk)] = (unsigned short)(pr >> 16);
      }
  }
  __syncthreads();
  uint4* dst = out + (long long)blockIdx.x * TR * 4;
#pragma unroll
  for (int c = threadIdx.x; c < TR * 4; c += 256)
    dst[c] = ((const uint4*)tile)[c];
}

// X's packed tiles of TR rows (X(r, k) = x[r sr + k sk], float32 or bf16)
template <int TR>
static void rg_pack(const void* x, int bf, int R, int K, long long sr,
                    long long sk, void* out, cudaStream_t st) {
  const int blocks = ((R + TR - 1) / TR) * ((K + 31) / 32);
  uint4* o = (uint4*)out;
  if (sk == 1) {
    if (bf)
      rg_pack_kernel<true, TR, true><<<blocks, 256, 0, st>>>(x, R, K, sr, sk,
                                                              o);
    else
      rg_pack_kernel<true, TR, false><<<blocks, 256, 0, st>>>(x, R, K, sr,
                                                               sk, o);
  } else {
    if (bf)
      rg_pack_kernel<false, TR, true><<<blocks, 256, 0, st>>>(x, R, K, sr,
                                                               sk, o);
    else
      rg_pack_kernel<false, TR, false><<<blocks, 256, 0, st>>>(x, R, K, sr,
                                                                sk, o);
  }
}

// shared-memory matrix descriptor of a K-major slice of 16 of K (32 bytes
// into the rows at p) in the packed layout: 64-byte swizzle, atoms of 8
// rows 512 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t rb_desc(const char* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void rb_wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// stage s's copies: A's and B's packed tiles of step t by the copy engine,
// counted on the stage's barrier (one thread)
__device__ __forceinline__ void rb_load(char* stage, uint64_t* bar,
                                        const char* a, const char* b) {
  const unsigned sb = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(sb), "n"(RB_TILE_A + RB_TILE_B)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(stage)),
      "l"(a), "n"(RB_TILE_A), "r"(sb)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(stage + RB_TILE_A)),
      "l"(b), "n"(RB_TILE_B), "r"(sb)
      : "memory");
}

// until the barrier's phase of this parity has completed; a wait of more
// than about 2^32 cycles traps (a fault of the pipeline's bookkeeping
// becomes a launch error, not a hang)
__device__ __forceinline__ void rb_wait(uint64_t* bar, uint32_t parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// d += a b over 64 x 128 x 16, bf16 operands from shared memory (both
// K-major), float32 sums
__device__ __forceinline__ void rb_wgmma(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// rg_store's epilogue over the output tile ct (rows RB_CT floats apart) at
// (m0, n0), a thread a column (n = tid % RB_BN, every RP-th row), 16 rows
// at a time: each operation's loads for the 16 issued together, the
// operations in rg_store's order
__device__ __forceinline__ void rb_epilogue(const RgArgs& g,
                                            const float* ct, int m0,
                                            int n0) {
  constexpr int RP = RB_THREADS / RB_BN;  // rows a pass
  const int n = n0 + threadIdx.x % RB_BN, r0 = threadIdx.x / RB_BN;
  if (n >= g.N) return;
  if (g.partial) {
    float* part = g.partial + (size_t)blockIdx.z * g.M * g.N + n;
#pragma unroll 8
    for (int r = r0; r < RB_BM; r += RP)
      if (m0 + r < g.M) part[(size_t)(m0 + r) * g.N] = ct[r * RB_CT + n - n0];
    return;
  }
  const float bn = g.bias ? g.bias[n] : 0.f;
  for (int rb = r0; rb < RB_BM; rb += 16 * RP) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = ct[(rb + RP * u) * RB_CT + n - n0];
    if (g.bias) {
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = v[u] + bn;
    }
    if (g.relu) {
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = v[u] > 0.f ? v[u] : 0.f;
    }
    if (g.dr.on) {
      // gt_drop's v / keep; at keep 0.5 (on == 2) the same value as v * 2
      const bool half = g.dr.on == 2;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const uint32_t e = (uint32_t)((size_t)(m0 + rb + RP * u) * g.N + n);
        v[u] = gt_keep(g.dr, g.key, e)
                   ? (half ? v[u] * 2.f : v[u] / g.dr.keep)
                   : 0.f;
      }
    }
    if (g.gate) {
      float gv[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int m = m0 + rb + RP * u;
        gv[u] = m < g.M ? g.gate[(size_t)m * g.N + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = v[u] * (gv[u] > 0.f ? g.gate_inv : 0.f);
    }
    if (g.add) {
      float av[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int m = m0 + rb + RP * u;
        av[u] = m < g.M && m % g.add_every == 0
                    ? g.add[(size_t)(m / g.add_every) * g.N + n]
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if ((m0 + rb + RP * u) % g.add_every == 0) v[u] = av[u] + v[u];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int m = m0 + rb + RP * u;
      if (m < g.M) g.c[(size_t)m * g.ldc + n] = v[u];
    }
  }
}

// C (+ epilogue) of the block's 256 x 128 tile over its chunk of K, from
// the packed tiles pa (A's, RB_BM rows) and pb (B's, RB_BN columns), ks
// steps of 32 in all: thread 0 keeps RB_STAGES steps' tiles in flight by
// the copy engine; each warpgroup runs its rows' products on the stage that
// has landed, one group in flight; a stage is refilled once both
// warpgroups' products of it are done.
__global__ void __launch_bounds__(RB_THREADS, 1)
    rg_wgmma_bf16_kernel(RgArgs g, const char* __restrict__ pa,
                         const char* __restrict__ pb, int ks) {
  gt_read_seed(g.dr, g.key);
  extern __shared__ __align__(128) char rb_dyn[];
  char* st = (char*)(((uintptr_t)rb_dyn + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(st + RB_STAGES * (RB_TILE_A + RB_TILE_B));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * RB_BM, n0 = blockIdx.x * RB_BN;
  const int k0 = blockIdx.z * g.kchunk;
  const int k1 = min(g.K, k0 + g.kchunk);
  const int s0 = k0 / 32;
  const int steps = k1 > k0 ? (k1 - k0 + 31) / 32 : 0;
  // this block's packed tiles of step s0 + t
  const char* ta = pa + ((long long)blockIdx.y * ks + s0) * RB_TILE_A;
  const char* tb = pb + ((long long)blockIdx.x * ks + s0) * RB_TILE_B;
  if (tid == 0) {
    for (int s = 0; s < RB_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < RB_STAGES && t < steps; ++t)
      rb_load(st + t * (RB_TILE_A + RB_TILE_B), full + t,
              ta + (long long)t * RB_TILE_A, tb + (long long)t * RB_TILE_B);
  }
  __syncthreads();
  // warpgroup wg: rows 128 wg .. +127 as two m64 parts h; its warp q: rows
  // 16 q .. +15 of a part
  const int wg = warp >> 2, q = warp & 3;
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    rg_fence_regs(acc[h]);
  }
  for (int t = 0; t < steps; ++t) {
    const int s = t % RB_STAGES;
    const char* sa = st + s * (RB_TILE_A + RB_TILE_B);
    rb_wait(full + s, (t / RB_STAGES) & 1);
    rg_wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t bd = rb_desc(sa + RB_TILE_A + 32 * kk);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rb_wgmma(acc[h], rb_desc(sa + 64 * (128 * wg + 64 * h) + 32 * kk),
                 bd);
    }
    rg_wg_commit();
    // step t - 1's products done in both warpgroups: its stage takes step
    // t - 1 + RB_STAGES
    rb_wg_wait1();
    __syncthreads();
    const int nt = t - 1 + RB_STAGES;
    if (tid == 0 && t >= 1 && nt < steps) {
      const int ns = (t - 1) % RB_STAGES;
      rb_load(st + ns * (RB_TILE_A + RB_TILE_B), full + ns,
              ta + (long long)nt * RB_TILE_A, tb + (long long)nt * RB_TILE_B);
    }
  }
  rg_wg_wait();
#pragma unroll
  for (int h = 0; h < 2; ++h) rg_fence_regs(acc[h]);
  // the sums through shared memory (the stages' room, free now), so that
  // the epilogue reads and writes whole rows: acc[h][4 j + e] is row 128 wg
  // + 64 h + 16 q + g + 8 (e / 2), column 8 j + 2 t + e % 2
  __syncthreads();
  float* ct = (float*)st;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ct[(128 * wg + 64 * h + 16 * q + gq + 8 * (e >> 1)) * RB_CT + 8 * j +
           2 * tq + (e & 1)] = acc[h][4 * j + e];
  __syncthreads();
  rb_epilogue(g, ct, m0, n0);
}

// ----------------------------------------------------- the second passes
// c[e] = part[0][e] + part[1][e] + ... in chunk order
__global__ void rg_reduce_kernel(const float* __restrict__ part, int chunks,
                                 size_t len, float* __restrict__ c) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int z = 1; z < chunks; ++z) s += part[(size_t)z * len + e];
    c[e] = s;
  }
}

// part[z][n] = sum of b[r][n] over chunk z's rows, in row order
__global__ void rg_colsum_kernel(const void* b, int bf, long long ldb,
                                 int rows, int N, int rchunk,
                                 float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rchunk, r1 = min(rows, r0 + rchunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += rg_ld(b, bf, (size_t)r * ldb + n);
  part[(size_t)blockIdx.y * N + n] = s;
}

static inline int rg_imin(int a, int b) { return a < b ? a : b; }
static inline int rg_imax(int a, int b) { return a > b ? a : b; }

static cudaError_t rg_reduce(const float* part, int chunks, size_t len,
                             float* c, cudaStream_t st) {
  const size_t want = (len + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  rg_reduce_kernel<<<blocks, 256, 0, st>>>(part, chunks, len, c);
  return cudaGetLastError();
}

// ------------------------------------------------------------- C interface
// Chunks of the weight products' rows, a function of the shape (and of the
// product's type) alone, so the sums' order is fixed.  float32: about 1,056
// blocks (eight waves of the float32 kernel's one block on each of 132 SMs;
// a product's tiles in one chunk would leave its last wave part empty), at
// least 512 rows a chunk.  bf16: of 1 to 8 chunks of at least 512 rows, the
// fewest waves of 132 blocks a chunk's share (a last wave part empty costs
// as much as a full one), plus 0.05 a chunk for the partial sums each one
// writes and rg_reduce_kernel reads.
static int rg_bf16_chunks(int M, int N, int K) {
  const int tiles = ((M + RB_BM - 1) / RB_BM) * ((N + RB_BN - 1) / RB_BN);
  const int most = rg_imax(1, rg_imin(8, K / 512));
  int best = 1;
  double cost = 1e30;
  for (int c = 1; c <= most; ++c) {
    const double v = (double)((tiles * c + 131) / 132) / c + 0.05 * c;
    if (v < cost - 1e-9) {
      cost = v;
      best = c;
    }
  }
  return best;
}

extern "C" int gt_k18_chunks(int M, int N, int K, int bf16) {
  if (bf16) return rg_bf16_chunks(M, N, K);
  const int tiles = ((M + RG_BM - 1) / RG_BM) * ((N + RG_BN - 1) / RG_BN);
  const int want = (4 * 264 + tiles - 1) / tiles;
  return rg_imax(1, rg_imin(want, K / 512));
}

extern "C" int gt_k18_colsum_chunks(int rows) {
  return rg_imax(1, (rows + 127) / 128);
}

// C = op(A) op(B) with the epilogue, C's rows ldc floats apart; chunks > 1
// (no epilogue, ldc = N) splits K and writes partial [chunks, M, N] first.
// bytes of the bf16 products' packed tiles of A [M, K] and B [K, N]
extern "C" size_t gt_k18_bf16_scratch(int M, int N, int K) {
  return (size_t)(rb_chunks(M, K, RB_BM) + rb_chunks(N, K, RB_BN)) * 16;
}

// C = op(A) op(B) with the epilogue, C's rows ldc floats apart; chunks > 1
// (no epilogue, ldc = N) splits K and writes partial [chunks, M, N] first.
// bf16 products pack both operands into `scratch`
// (gt_k18_bf16_scratch bytes) first.
extern "C" int gt_k18_gemm(const void* a, int a_bf16, const void* b,
                           int b_bf16, float* c, int M, int N, int K, int sam,
                           int sak, int sbk, int sbn, int ldc, int mma_bf16,
                           const float* bias, int relu, const float* gate,
                           const float* add, float gate_keep, int add_every,
                           const long long* seed, unsigned int stream_id,
                           unsigned int keep24, float keep, int drop_on,
                           int chunks, float* partial, void* scratch,
                           void* stream) {
  // the float32 kernel keeps word offsets within an operand in 32 bits
  const long long lim = 1LL << 31;
  if ((long long)M * sam >= lim || (long long)K * sak >= lim ||
      (long long)K * sbk >= lim || (long long)N * sbn >= lim)
    return (int)cudaErrorInvalidValue;
  if (chunks < 1 || (chunks > 1 && (bias || relu || gate || add || drop_on ||
                                    !partial)) ||
      (!mma_bf16 && (a_bf16 || b_bf16)) ||
      add_every < 1 || (sak != 1 && sam != 1) || (sbk != 1 && sbn != 1) ||
      ldc < N || (chunks > 1 && ldc != N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RgArgs g;
  g.a = a;
  g.b = b;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  g.sam = sam;
  g.sak = sak;
  g.sbk = sbk;
  g.sbn = sbn;
  g.ldc = ldc;
  g.bias = bias;
  g.relu = relu;
  g.gate = gate;
  g.gate_inv = 1.0f / gate_keep;
  g.add = add;
  g.add_every = add_every;
  g.dr = GtDrop{seed, keep24, keep, drop_on};
  g.key = stream_id;  // the stream's key once the kernel reads the seed
  g.kchunk = ((K + chunks - 1) / chunks + RG_BK - 1) / RG_BK * RG_BK;
  g.partial = chunks > 1 ? partial : nullptr;
  if (mma_bf16) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    char* pa = (char*)scratch;
    char* pb = pa + rb_chunks(M, K, RB_BM) * 16;
    rg_pack<RB_BM>(a, a_bf16, M, K, sam, sak, pa, st);
    rg_pack<RB_BN>(b, b_bf16, N, K, sbn, sbk, pb, st);
    cudaError_t err = cudaFuncSetAttribute(
        rg_wgmma_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RG_SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + RB_BN - 1) / RB_BN, (M + RB_BM - 1) / RB_BM, chunks);
    rg_wgmma_bf16_kernel<<<grid, RB_THREADS, RG_SMEM_BF16, st>>>(
        g, pa, pb, (K + 31) / 32);
  } else {
    const dim3 grid((N + RG_BN - 1) / RG_BN, (M + RG_BM - 1) / RG_BM, chunks);
    // the layout of each operand's copies: contiguous along k or not
    void (*kern)(const RgArgs) =
        sak == 1 ? (sbk == 1 ? rg_tf32_kernel<true, true>
                             : rg_tf32_kernel<true, false>)
                 : (sbk == 1 ? rg_tf32_kernel<false, true>
                             : rg_tf32_kernel<false, false>);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, RG_THREADS, RG_SMEM_F32, st>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  return (int)rg_reduce(partial, chunks, (size_t)M * N, c, st);
}

// col[n] = sum over rows of b[r][n] (b [rows, N] at row stride ldb, f32 or
// bf16): per-chunk partials [chunks, N], then their sum in chunk order
extern "C" int gt_k18_colsum(const void* b, int b_bf16, float* col,
                             float* part, int rows, int N, int ldb,
                             int chunks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rchunk = (rows + chunks - 1) / chunks;
  const dim3 grid((N + 255) / 256, chunks);
  rg_colsum_kernel<<<grid, 256, 0, st>>>(b, b_bf16, ldb, rows, N, rchunk,
                                          part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rg_reduce(part, chunks, (size_t)N, col, st);
}
