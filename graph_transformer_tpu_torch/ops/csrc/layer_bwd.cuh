// The backward of one encoder layer over a block's rows, shared by K2/K3
// (layer_bwd.cu: residuals stored by K1's forward), K8/K8s and K10
// (recompute_bwd.cu, encoder_layer.cu: residuals recomputed from the
// layer's input by a forward launch just before, recompute.cuh) and K14
// (mega_bwd.cu).  Products take operands in the compute dtype (mmbf: bf16,
// else f32) and accumulate in f32.
//
// Inputs: the layer's input rows x [N*S, D] (bf16 or f32), q/k/v
// [N*S, 3D], the attention probabilities, the LayerNorm strip and the output
// cotangent.  In a full layer every row is a query row; in the last layer
// (SLOT0) only slot 0 of a neighborhood is, while its keys and values span
// all S slots, so attn, strip and dout are per neighborhood ([N, S],
// [N, 4D+2], [N, D]).  The FFN hidden of the query rows is recomputed chunk
// by chunk from y1 and the four dropout masks are regenerated from the same
// counters as the forward, so nothing of size [rows, F] is stored.
// Outputs: dx [N*S, D] and the block's row of partial weight gradients
// (KERNEL_ORDER), which gt_reduce_partials sums in block order.
//
// Layout: a thread per row for the row-wise work (LayerNorm, attention, the
// small gradients), as the forward; the FFN, ~5*D*F of the ~6*D*F product
// operations a row, runs on the tensor cores over all the block's query
// rows (gt_mma_tile: bf16 m16n8k16 or 3xTF32 from shared memory), every
// warp of the block taking 16 x 8 tiles, so the idle threads past the
// block's rows (GT_BWD_THREADS) work there too.  On the CUDA cores, a thread
// per row walking F with one shared-memory load a product, the FFN bound
// these kernels at 2 blocks (8 warps) an SM.
#pragma once

#include "common.cuh"

// hidden columns a chunk of the body's FFN: enough 16 x 8 tiles of the
// [QR, FC] chunk for the block's warps where the query rows are few (the
// last layer's G); past 32 query rows 64, which measured faster than 32
// (fewer chunks and barriers; PERF.md, PR 8) and keeps the body at two
// blocks an SM at S=9, D=4, G=14
__host__ __device__ inline int gt_bwd_fc(int QR) {
  return QR <= 32 ? 128 : 64;
}

// floats of dynamic shared memory: the R = G*S rows of a block hold x, q/k/v
// and dq/dk/dv; its QR query rows (R, or G in the last layer) hold the
// per-query vectors, attention rows, hidden chunks and their index in the
// layer; the FFN's column sums of dh, one row per 16 query rows
static inline size_t gt_bwd_smem_floats(int G, int S, int D, bool slot0) {
  const size_t R = (size_t)G * S;
  const size_t QR = slot0 ? (size_t)G : R;
  const size_t FC = gt_bwd_fc((int)QR);
  return (size_t)D * 3 * D + D * D + 2 * D + R * 7 * D +
         QR * (9 * D + 3 * S + 1) + FC * (2 * D + 1) + 2 * QR * FC +
         (QR + 15) / 16 * FC;
}

// the small weight gradients: w_in/b_in over rq rows of (x, dqkv); the rest
// over rs rows of the per-row vectors
__device__ __forceinline__ void gt_small_grads(
    const float* sX, const float* sDQKV, int rq, const float* sCTX,
    const float* sDA, const float* sDY1U, const float* sDY1, const float* sDZ,
    const float* sGU2, const float* sG, int rs, int D, const GtGradOff& o,
    float* part, int mmbf) {
  const int D3 = 3 * D;
  const int n_win = D * D3, n_wout = D * D;
  const int total = n_win + D3 + n_wout + 6 * D;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    float acc = 0.f;
    int q = p;
    if (q < n_win) {
      const int d = q / D3, e = q - d * D3;
      for (int rr = 0; rr < rq; ++rr)
        acc += gt_rn(sX[rr * D + d], mmbf) * gt_rn(sDQKV[rr * D3 + e], mmbf);
      part[o.w_in + q] = acc;
      continue;
    }
    q -= n_win;
    if (q < D3) {
      for (int rr = 0; rr < rq; ++rr) acc += sDQKV[rr * D3 + q];
      part[o.b_in + q] = acc;
      continue;
    }
    q -= D3;
    if (q < n_wout) {
      const int c = q / D, d = q - c * D;
      for (int rr = 0; rr < rs; ++rr)
        acc += gt_rn(sCTX[rr * D + c], mmbf) * gt_rn(sDA[rr * D + d], mmbf);
      part[o.w_out + q] = acc;
      continue;
    }
    q -= n_wout;
    const int which = q / D, d = q - which * D;
    const float* src;
    int off;
    switch (which) {
      case 0: src = sDA; off = o.b_out; break;
      case 1: src = sDY1U; off = o.g1; break;
      case 2: src = sDY1; off = o.c1; break;
      case 3: src = sDZ; off = o.b2; break;
      case 4: src = sGU2; off = o.g2; break;
      default: src = sG; off = o.c2; break;
    }
    for (int rr = 0; rr < rs; ++rr) acc += src[rr * D + d];
    part[off + d] = acc;
  }
}

// The block's share of the backward of layer `layer` (its dropout
// streams); one thread per row r = threadIdx.x, as in the forward.  `part`
// is this block's row of partial weight gradients.
template <int DM, bool SLOT0>
__device__ __forceinline__ void gt_layer_bwd_body(
    float* smem, const void* xs, int x_bf16, const float* qkv,
    const float* attn, const float* strip, const float* dout,
    const GtLayer& w, const GtDrop& dr, int layer, float* dx, float* part,
    int N, int S, int D, int F, int G, float scale, int mmbf) {
  const int R = G * S;
  const int QR = SLOT0 ? G : R;  // query rows in the block
  const int NQ = SLOT0 ? 1 : S;  // query rows per neighborhood
  const int D3 = 3 * D;
  const int SW = 4 * D + 2;
  const int FC = gt_bwd_fc(QR);
  const GtGradOff o = gt_grad_offsets(D, F);
  float* sWin = smem;
  float* sWout = sWin + D * D3;
  float* sG1 = sWout + D * D;
  float* sG2 = sG1 + D;
  // per row
  float* sX = sG2 + D;
  float* sQKV = sX + R * D;
  float* sDQKV = sQKV + R * D3;
  // per query row
  float* sG = sDQKV + R * D3;
  float* sGU2 = sG + QR * D;
  float* sDZ = sGU2 + QR * D;
  float* sY1b = sDZ + QR * D;
  float* sDY1 = sY1b + QR * D;
  float* sDY1U = sDY1 + QR * D;
  float* sDA = sDY1U + QR * D;
  float* sCTX = sDA + QR * D;
  float* sDCTX = sCTX + QR * D;
  float* sA = sDCTX + QR * D;
  float* sAD = sA + QR * S;
  float* sDS = sAD + QR * S;
  float* sW1c = sDS + QR * S;
  float* sW2c = sW1c + D * FC;
  float* sB1c = sW2c + FC * D;
  float* sH = sB1c + FC;
  float* sDH = sH + QR * FC;
  float* sDB1 = sDH + QR * FC;  // [ceil(QR / 16), FC]
  // query row q's index in the layer, -1 past the N neighborhoods
  int* sQI = (int*)(sDB1 + (QR + 15) / 16 * FC);

  const int tid = threadIdx.x;
  const int r = tid;
  const int g = r / S;
  const int i = r - g * S;
  const int n = blockIdx.x * G + g;
  const bool inb = r < R;
  const bool valid = inb && (n < N);
  const uint32_t row = (uint32_t)n * S + i;
  // this thread's query row: its own, or its neighborhood's slot 0
  const int qr = SLOT0 ? g : r;
  const uint32_t qidx = SLOT0 ? (uint32_t)n : row;  // its index in the layer
  const bool qown = valid && (!SLOT0 || i == 0);   // computes the query row
  const bool qlead = inb && (!SLOT0 || i == 0);    // writes its shared slots
  const uint32_t kA = gt_stream_key(dr.seed, 4 * layer + 0);
  const uint32_t kO = gt_stream_key(dr.seed, 4 * layer + 1);
  const uint32_t kH = gt_stream_key(dr.seed, 4 * layer + 2);
  const uint32_t kZ = gt_stream_key(dr.seed, 4 * layer + 3);

  __syncthreads();  // earlier users of shared memory are done
  for (int e = tid; e < D * D3; e += blockDim.x) sWin[e] = gt_rn(w.w_in[e], mmbf);
  for (int e = tid; e < D * D; e += blockDim.x) sWout[e] = gt_rn(w.w_out[e], mmbf);
  for (int e = tid; e < D; e += blockDim.x) {
    sG1[e] = w.g1[e];
    sG2[e] = w.g2[e];
  }
  __syncthreads();

  // ---- LayerNorm 2 backward, then the FFN-output dropout
  float gv[DM], y1[DM], u1h[DM], u2h[DM], ctx[DM], du2[DM], dz[DM];
  float rstd1 = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) gv[d] = y1[d] = u1h[d] = u2h[d] = ctx[d] = du2[d] = dz[d] = 0.f;
  if (qown) {
    const float* st = strip + (size_t)qidx * SW;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) {
        gv[d] = dout[(size_t)qidx * D + d];
        ctx[d] = st[d];
        y1[d] = st[D + d];
        u1h[d] = st[2 * D + d];
        u2h[d] = st[3 * D + d];
      }
    rstd1 = st[4 * D];
    gt_ln_bwd<DM>(gv, sG2, u2h, st[4 * D + 1], D, du2);
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) dz[d] = gt_drop(dr, kZ, qidx * D + d, du2[d]);
  }
  if (qlead) {
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) {
        sG[qr * D + d] = gv[d];
        sGU2[qr * D + d] = gv[d] * u2h[d];
        sDZ[qr * D + d] = dz[d];
        sY1b[qr * D + d] = gt_rn(y1[d], mmbf);
      }
    sQI[qr] = qown ? (int)qidx : -1;
  }
  __syncthreads();

  // ---- FFN on the tensor cores (gt_mma_tile), a chunk of FC hidden
  // columns at a time over the QR query rows: the hidden recomputed from
  // the rounded y1, its cotangent dh = (dz W2^T) * relu' * dropout, dy1's
  // FFN term dh W1^T summed into sDY1 (each (q, d) by one thread, chunk
  // after chunk), and the chunk's dW1 = y1^T dh, db1 and dW2 = h^T dz over
  // the block's query rows.  Products round dz and dh to the compute dtype
  // as they load them; rows past the N neighborhoods hold zeros.
  const int warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int mt = (QR + 15) >> 4, ntd = (D + 7) >> 3, mtd = (D + 15) >> 4;
  const float ikeep = dr.on ? 1.f / dr.keep : 1.f;
  for (int e = tid; e < QR * D; e += blockDim.x) sDY1[e] = 0.f;
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nfc = min(FC, F - f0);
    __syncthreads();
    for (int e = tid; e < D * nfc; e += blockDim.x) {
      const int d = e / nfc, fc = e - d * nfc;
      sW1c[d * FC + fc] = gt_rn(w.w1[(size_t)d * F + f0 + fc], mmbf);
    }
    for (int e = tid; e < nfc * D; e += blockDim.x)
      sW2c[e] = gt_rn(w.w2[(size_t)f0 * D + e], mmbf);
    for (int e = tid; e < nfc; e += blockDim.x) sB1c[e] = w.b1[f0 + e];
    __syncthreads();
    // h and dh of each 16 x 8 tile of [QR, nfc], and the tile's column sums
    // of dh (summed over its 16 rows across the lanes of one column pair);
    // a warp takes a column of tiles, its weights' fragments loaded once
    const int nt = (nfc + 7) >> 3;
    const int lane = tid & 31;
    for (int cn = warp; cn < nt; cn += nwarp) {
      const int tn = cn * 8;
      GtBFrag fw1, fw2;
      gt_bfrag(fw1, sW1c, FC, 1, nfc, D, tn, mmbf);
      gt_bfrag(fw2, sW2c, 1, D, nfc, D, tn, mmbf);
      const int c0 = gt_frag_col(tn, 0);
      const float b1c[2] = {c0 < nfc ? sB1c[c0] : 0.f,
                            c0 + 1 < nfc ? sB1c[c0 + 1] : 0.f};
      for (int tm = 0; tm < QR; tm += 16) {
        float hp[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
        gt_mma_tile_pre(hp, sY1b, D, 1, QR, fw1, D, tm, mmbf);
        gt_mma_tile_pre(dh, sDZ, D, 1, QR, fw2, D, tm, mmbf);
        const int qa = gt_frag_row(tm, 0), qb = qa + 8;
        const int qi[2] = {qa < QR ? sQI[qa] : -1, qb < QR ? sQI[qb] : -1};
        float cs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = j < 2 ? qa : qb, c = c0 + (j & 1);
          if (q >= QR || c >= nfc) continue;
          float hb = 0.f, dhp = 0.f;
          if (qi[j >> 1] >= 0) {
            const float hpv = hp[j] + b1c[j & 1];
            // relu' times the dropout factor (1/keep as the forward divides)
            float fac = hpv > 0.f ? 1.f : 0.f;
            if (dr.on &&
                !gt_keep(dr, kH, (uint32_t)qi[j >> 1] * F + f0 + c))
              fac = 0.f;
            fac *= ikeep;
            hb = gt_rn(hpv * fac, mmbf);
            dhp = dh[j] * fac;
          }
          sH[q * FC + c] = hb;
          sDH[q * FC + c] = dhp;
          cs[j & 1] += dhp;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[0] += __shfl_xor_sync(0xffffffffu, cs[0], off);
          cs[1] += __shfl_xor_sync(0xffffffffu, cs[1], off);
        }
        if (lane < 4) {
          sDB1[(tm >> 4) * FC + tn + 2 * lane] = cs[0];
          sDB1[(tm >> 4) * FC + tn + 2 * lane + 1] = cs[1];
        }
      }
    }
    __syncthreads();
    // db1: the tiles' column sums in tile order
    for (int c = tid; c < nfc; c += blockDim.x) {
      float s = 0.f;
      for (int m = 0; m < mt; ++m) s += sDB1[m * FC + c];
      part[o.b1 + f0 + c] = s;
    }
    // dy1 [QR, D] += dh W1^T
    for (int tile = warp; tile < mt * ntd; tile += nwarp) {
      const int tm = (tile / ntd) * 16, tn = (tile % ntd) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      gt_mma_tile(acc, sDH, FC, 1, QR, sW1c, 1, FC, D, nfc, tm, tn, mmbf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = gt_frag_row(tm, j), d = gt_frag_col(tn, j);
        if (q < QR && d < D) sDY1[q * D + d] += acc[j];
      }
    }
    // dW1 [D, nfc] = y1^T dh
    for (int tile = warp; tile < mtd * nt; tile += nwarp) {
      const int tm = (tile / nt) * 16, tn = (tile % nt) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      gt_mma_tile(acc, sY1b, 1, D, D, sDH, FC, 1, nfc, QR, tm, tn, mmbf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = gt_frag_row(tm, j), c = gt_frag_col(tn, j);
        if (d < D && c < nfc) part[o.w1 + d * F + f0 + c] = acc[j];
      }
    }
    // dW2 [nfc, D] = h^T dz
    const int mtc = (nfc + 15) >> 4;
    for (int tile = warp; tile < mtc * ntd; tile += nwarp) {
      const int tm = (tile / ntd) * 16, tn = (tile % ntd) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      gt_mma_tile(acc, sH, 1, FC, nfc, sDZ, D, 1, D, QR, tm, tn, mmbf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = gt_frag_row(tm, j), d = gt_frag_col(tn, j);
        if (c < nfc && d < D) part[o.w2 + (f0 + c) * D + d] = acc[j];
      }
    }
  }
  __syncthreads();
  float dyp[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) dyp[d] = 0.f;
  if (qown) {
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) dyp[d] = sDY1[qr * D + d];
  }

  // ---- LayerNorm 1, attention-output dropout and projection
  float dy1[DM], du1[DM], da[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) dy1[d] = du1[d] = da[d] = 0.f;
  if (qown) {
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) dy1[d] = du2[d] + dyp[d];
    gt_ln_bwd<DM>(dy1, sG1, u1h, rstd1, D, du1);
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) da[d] = gt_drop(dr, kO, qidx * D + d, du1[d]);
  }
  if (qlead) {
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) {
        sDY1[qr * D + d] = dy1[d];
        sDY1U[qr * D + d] = dy1[d] * u1h[d];
        sDA[qr * D + d] = da[d];
        sCTX[qr * D + d] = ctx[d];
      }
    for (int c = 0; c < D; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) acc += gt_rn(da[d], mmbf) * sWout[c * D + d];
      sDCTX[qr * D + c] = acc;
    }
    for (int j = 0; j < S; ++j) sA[qr * S + j] = qown ? attn[(size_t)qidx * S + j] : 0.f;
  }
  if (inb) {
    for (int e = 0; e < D3; ++e) sQKV[r * D3 + e] = valid ? qkv[(size_t)row * D3 + e] : 0.f;
    float xr[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) xr[d] = 0.f;
    if (valid) gt_load_row<DM>(xs, x_bf16, row, D, xr);
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) sX[r * D + d] = xr[d];
  }
  __syncthreads();

  // ---- attention backward, query side
  float dq[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) dq[d] = 0.f;
  if (qown) {
    float sdot = 0.f;
    for (int j = 0; j < S; ++j) {
      const float a = sA[qr * S + j];
      const bool kp = !dr.on || gt_keep(dr, kA, qidx * S + j);
      const float ad = dr.on ? (kp ? a / dr.keep : 0.f) : a;
      sAD[qr * S + j] = gt_rn(ad, mmbf);
      const float* vv = sQKV + (g * S + j) * D3 + 2 * D;
      float dd = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) dd += gt_rn(sDCTX[qr * D + d], mmbf) * gt_rn(vv[d], mmbf);
      const float dat = dr.on ? (kp ? dd / dr.keep : 0.f) : dd;
      sDS[qr * S + j] = dat;
      sdot += dat * a;
    }
    for (int j = 0; j < S; ++j) {
      const float ds = sA[qr * S + j] * (sDS[qr * S + j] - sdot) * scale;
      sDS[qr * S + j] = ds;
      const float* kk = sQKV + (g * S + j) * D3 + D;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) dq[d] += gt_rn(ds, mmbf) * gt_rn(kk[d], mmbf);
    }
  }
  __syncthreads();

  // ---- key/value side (this thread is key slot i of the neighborhood's NQ
  // query rows), dqkv, dx
  if (valid) {
    float dk[DM], dv[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) dk[d] = dv[d] = 0.f;
    for (int qq = 0; qq < NQ; ++qq) {
      const int rq = SLOT0 ? g : g * S + qq;  // the query row's slots
      const float ad = sAD[rq * S + i];
      const float ds = gt_rn(sDS[rq * S + i], mmbf);
      const float* qv = sQKV + (g * S + qq) * D3;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) {
          dv[d] += ad * gt_rn(sDCTX[rq * D + d], mmbf);
          dk[d] += ds * gt_rn(qv[d], mmbf);
        }
    }
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) {
        sDQKV[r * D3 + d] = dq[d];
        sDQKV[r * D3 + D + d] = dk[d];
        sDQKV[r * D3 + 2 * D + d] = dv[d];
      }
    for (int c = 0; c < D; ++c) {
      float acc = 0.f;
      for (int e = 0; e < D3; ++e) acc += gt_rn(sDQKV[r * D3 + e], mmbf) * sWin[c * D3 + e];
      dx[(size_t)row * D + c] = du1[c] + acc;
    }
  } else if (inb) {
    for (int e = 0; e < D3; ++e) sDQKV[r * D3 + e] = 0.f;
  }
  __syncthreads();
  gt_small_grads(sX, sDQKV, R, sCTX, sDA, sDY1U, sDY1, sDZ, sGU2, sG, QR, D, o,
                 part, mmbf);
}

template <int DM, bool SLOT0>
__global__ void __launch_bounds__(GT_BWD_THREADS)
gt_layer_bwd_kernel(const void* xs, int x_bf16, const float* qkv,
                    const float* attn, const float* strip, const float* dout,
                    GtLayer w, GtDrop dr, int layer, float* dx, float* partial,
                    int N, int S, int D, int F, int G, float scale) {
  extern __shared__ float smem[];
  float* part = partial + (size_t)blockIdx.x * gt_grad_offsets(D, F).P;
  gt_layer_bwd_body<DM, SLOT0>(smem, xs, x_bf16, qkv, attn, strip, dout, w,
                               dr, layer, dx, part, N, S, D, F, G, scale,
                               x_bf16);
}

// The body over ceil(N/G) blocks, then the partial gradients summed in block
// order into grads.  Products in the rows' dtype (bf16 when x_bf16).
template <int DM, bool SLOT0>
static cudaError_t gt_launch_layer_bwd(const void* xs, int x_bf16,
                                       const float* qkv, const float* attn,
                                       const float* strip, const float* dout,
                                       const GtLayer& w, const GtDrop& dr,
                                       int layer, float* dx, float* partial,
                                       float* grads, int N, int S, int D,
                                       int F, int G, float scale,
                                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * gt_bwd_smem_floats(G, S, D, SLOT0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gt_layer_bwd_kernel<DM, SLOT0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + G - 1) / G;
  gt_layer_bwd_kernel<DM, SLOT0><<<blocks, GT_BWD_THREADS, smem, stream>>>(
      xs, x_bf16, qkv, attn, strip, dout, w, dr, layer, dx, partial, N, S, D,
      F, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gt_reduce_partials(partial, blocks, gt_grad_offsets(D, F).P, grads,
                            stream);
}
