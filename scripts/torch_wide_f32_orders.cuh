// The wd_gemm section of wide.cuh with its sums in units, for
// scripts/torch_wide_f32_orders.py, which splices it into copies of the
// sources in place of wide.cuh's own (from "// wd_gemm's tile where the
// weights' rows are not 16-byte aligned" to "// LayerNorm statistics of one
// row") and sends the forward layer's four products through wd_fwd_gemm.
// Not built by the port.
// Units of the float32 CUDA-core forward's sums (wd_fwd_gemm): 0 sums each
// product as one FMA chain over K (h W2 over each WD_FC-column chunk, the
// chunks added in order); scripts/torch_wide_f32_orders.py builds other
// values to hold them against the float32 checks.
#ifndef WD_KU_D
#define WD_KU_D 0     // the K = D products: x W_in, ctx W_out, y1 W1
#endif
#ifndef WD_KU_F
#define WD_KU_F 0     // h W2
#endif

// wd_gemm's tile where the weights' rows are not 16-byte aligned (D=65)
// or not neighbouring (wc != 1): a thread owns one output column and 8
// rows, one weight load feeding 8 FMAs; with A16, 4 K values of an A row a
// shared-memory load.
template <bool A16, class Epi>
__device__ __forceinline__ void wd_gemm_col8(const float* A, int lda, int M,
                                             int K,
                                             const float* __restrict__ w,
                                             int wk, int wc, int Nc, int bf,
                                             int unit, Epi epi) {
  const int tiles = (M + WD_RT - 1) / WD_RT;
  for (int item = threadIdx.x; item < Nc * tiles; item += blockDim.x) {
    const int c = item % Nc;
    const int r0 = (item / Nc) * WD_RT;
    float acc[WD_RT];
#pragma unroll
    for (int i = 0; i < WD_RT; ++i) acc[i] = 0.f;
    const float* wp = w + (size_t)c * wc;
    const float* ap = A + (size_t)r0 * lda;
    for (int u0 = 0; u0 < K; u0 += unit) {
      const int ue = min(K, u0 + unit);
      float part[WD_RT];
#pragma unroll
      for (int i = 0; i < WD_RT; ++i) part[i] = 0.f;
      int k = u0;
      if constexpr (A16) {
        for (; k + 4 <= ue; k += 4) {
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = gt_rn(__ldg(wp + (size_t)(k + j) * wk), bf);
#pragma unroll
          for (int i = 0; i < WD_RT; ++i) {
            const float4 a = *(const float4*)(ap + i * lda + k);
            part[i] = fmaf(a.x, wv[0], part[i]);
            part[i] = fmaf(a.y, wv[1], part[i]);
            part[i] = fmaf(a.z, wv[2], part[i]);
            part[i] = fmaf(a.w, wv[3], part[i]);
          }
        }
      }
      for (; k < ue; ++k) {
        const float wv = gt_rn(__ldg(wp + (size_t)k * wk), bf);
#pragma unroll
        for (int i = 0; i < WD_RT; ++i)
          part[i] = fmaf(ap[i * lda + k], wv, part[i]);
      }
#pragma unroll
      for (int i = 0; i < WD_RT; ++i) acc[i] = u0 ? acc[i] + part[i] : part[i];
    }
#pragma unroll
    for (int i = 0; i < WD_RT; ++i)
      if (r0 + i < M) epi(r0 + i, c, acc[i]);
  }
}

// wd_gemm's tile where the weights' rows are 16-byte aligned: a thread owns
// 4 rows and 4 neighbouring columns, so each weight load (16 bytes) brings
// 4 columns and each A value read from shared memory feeds 4 FMAs; with
// A16, 4 K values of an A row a shared-memory load.
template <bool A16, class Epi>
__device__ __forceinline__ void wd_gemm_44(const float* A, int lda, int M,
                                           int K, const float* __restrict__ w,
                                           int wk, int Nc, int bf, int unit,
                                           Epi epi) {
  const int tiles = (M + 3) / 4, cg = Nc / 4;
  for (int item = threadIdx.x; item < cg * tiles; item += blockDim.x) {
    const int c0 = (item % cg) * 4, r0 = (item / cg) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
    const float* wp = w + c0;
    const float* ap = A + (size_t)r0 * lda;
    auto wrow = [&](int k) {  // W(k, c0 .. c0 + 3), rounded
      float4 v = __ldg((const float4*)(wp + (size_t)k * wk));
      v.x = gt_rn(v.x, bf);
      v.y = gt_rn(v.y, bf);
      v.z = gt_rn(v.z, bf);
      v.w = gt_rn(v.w, bf);
      return v;
    };
    auto step = [&](float a, const float4& v, float (&r)[4]) {
      r[0] = fmaf(a, v.x, r[0]);
      r[1] = fmaf(a, v.y, r[1]);
      r[2] = fmaf(a, v.z, r[2]);
      r[3] = fmaf(a, v.w, r[3]);
    };
    for (int u0 = 0; u0 < K; u0 += unit) {
      const int ue = min(K, u0 + unit);
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) part[i][n] = 0.f;
      int k = u0;
      if constexpr (A16) {
        for (; k + 4 <= ue; k += 4) {
          const float4 w0 = wrow(k), w1 = wrow(k + 1), w2 = wrow(k + 2),
                       w3 = wrow(k + 3);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *(const float4*)(ap + i * lda + k);
            step(a.x, w0, part[i]);
            step(a.y, w1, part[i]);
            step(a.z, w2, part[i]);
            step(a.w, w3, part[i]);
          }
        }
      }
      for (; k < ue; ++k) {
        const float4 v = wrow(k);
#pragma unroll
        for (int i = 0; i < 4; ++i) step(ap[i * lda + k], v, part[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[i][n] = u0 ? acc[i][n] + part[i][n] : part[i][n];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < M)
#pragma unroll
        for (int n = 0; n < 4; ++n) epi(r0 + i, c0 + n, acc[i][n]);
  }
}

// C[r][c] = sum_k A[r*lda + k] * W(k, c) with W(k, c) = w[k*wk + c*wc]
// (rounded to bf16 when bf) for rows r < M and columns c < Nc; calls
// epi(r, c, C[r][c]).  A lives in shared memory with wd_pad(M) rows.  The
// sums are FMAs in K order, one accumulator an output, whatever the tile;
// with `unit` > 0 each `unit` values of K are summed so from zero and the
// units' sums added in K order (WD_KU_D, WD_KU_F).  Tiles: 4 x 4 (wd_gemm_44) where a row of 4 neighbouring
// weights is one aligned 16-byte load, else a column of 8 rows
// (wd_gemm_col8): with 4-byte weight loads in the 4 x 4 tile K4tw ran 31%
// slower than on the column at D=65 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
template <class Epi>
__device__ __forceinline__ void wd_gemm(const float* A, int lda, int M, int K,
                                        const float* __restrict__ w, int wk,
                                        int wc, int Nc, int bf, Epi epi,
                                        int unit = 0) {
  const bool a16 = lda % 4 == 0 && ((uintptr_t)A & 15) == 0;
  const int u = unit > 0 ? unit : (K > 0 ? K : 1);
  if (wc == 1 && wk % 4 == 0 && Nc % 4 == 0 && ((uintptr_t)w & 15) == 0) {
    if (a16)
      wd_gemm_44<true>(A, lda, M, K, w, wk, Nc, bf, u, epi);
    else
      wd_gemm_44<false>(A, lda, M, K, w, wk, Nc, bf, u, epi);
  } else if (a16) {
    wd_gemm_col8<true>(A, lda, M, K, w, wk, wc, Nc, bf, u, epi);
  } else {
    wd_gemm_col8<false>(A, lda, M, K, w, wk, wc, Nc, bf, u, epi);
  }
}

// wd_gemm as the product routine of wd_fwd_layer and wd_bwd_body (their
// default, the forward kernels' and K6's; the tensor-core routine is
// WdMmaGemm, wide_mma.cuh)
struct WdCoreGemm {
  template <class Epi>
  __device__ __forceinline__ void operator()(const float* A, int lda, int M,
                                             int K,
                                             const float* __restrict__ w,
                                             int wk, int wc, int Nc, int bf,
                                             Epi epi) const {
    wd_gemm(A, lda, M, K, w, wk, wc, Nc, bf, epi);
  }
};

// A product of the forward layer through the layer's routine; on the CUDA
// cores, float32 operands sum K in units of `unit` (wd_gemm).
template <class Gemm, class Epi>
__device__ __forceinline__ void wd_fwd_gemm(const Gemm& gemm, int unit,
                                            const float* A, int lda, int M,
                                            int K, const float* __restrict__ w,
                                            int wk, int wc, int Nc, int bf,
                                            Epi epi) {
  gemm(A, lda, M, K, w, wk, wc, Nc, bf, epi);
}

template <class Epi>
__device__ __forceinline__ void wd_fwd_gemm(const WdCoreGemm&, int unit,
                                            const float* A, int lda, int M,
                                            int K, const float* __restrict__ w,
                                            int wk, int wc, int Nc, int bf,
                                            Epi epi) {
  wd_gemm(A, lda, M, K, w, wk, wc, Nc, bf, epi, bf ? 0 : unit);
}

