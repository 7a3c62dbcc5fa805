// Gradient of the Mamba-2 SSD intra-chunk pass (kernel.cu) for Hopper
// (sm_90a), f32.
//
// The TPU kernel src/repro/kernels/ssd_scan/kernel.py:59 `ssd_intra_pallas`
// has no VJP of its own: the JAX trainer differentiates the jnp SSD
// (`ref.py` `ssd_reference`).  This kernel computes the gradient XLA derives
// from its intra-chunk part, given the output gradients gy (Q, P),
// gst (P, N) and gcs (Q) of one (batch b, head h, chunk c).  With u = x dt,
// G = C B^T, L_ij = exp(cs_i - cs_j) (i >= j), S = G o L and
// w_j = exp(cs_last - cs_j):
//   gS  = gy u^T masked to i >= j,          gG = gS o L
//   gu  = S^T gy + w o (B gst^T)
//   gC  = gG B,   gB = gG^T C + w o (u gst)
//   gcs_i += sum_j (gS o S)_ij,  gcs_j -= sum_i (gS o S)_ij
//   gw_j = sum_p u_jp (B gst^T)_jp:  gcs_j -= gw_j w_j,  gcs_last += sum gw w
//   gdA = reverse cumsum of gcs,  gdt = gdA A + rowsum(gu o x),  gx = gu dt
//   gA  = sum_t gdA_t dt_t  (one f64 partial per block; the wrapper sums
//         them in f64)
// gB and gC are written per head (the wrapper sums a group's heads), so no
// block shares an output with another and no atomics touch device memory.
//
// What bounds it on an H100: at the training shape (1,024 blocks of
// Q 256, P 64, N 128) about 2Q^2(2P + 3N) + 4QPN = 77 GFLOP, 1.15 ms on the
// 67 TFLOP/s f32 units, against ~450 MB moved: bound by operations.  Like
// the forward this first kernel runs on the FMA units from shared memory.
//
// Design.  One block per (b, h, c) walks the 64 x 64 tile pairs (i >= j)
// on and below the diagonal with the column tile j outer: the scores G_ij and gS_ij
// are recomputed in registers from C_i, B_j, gy_i and x_j, masked and decayed
// (exp only where i >= j); S and gG are staged in shared memory; gB_j and
// gu_j accumulate in registers over the row tiles i >= j, and gC_i
// accumulates in device memory (each element is read and written by the
// one thread that owns it, so a plain read-modify-write is safe).  After a
// column tile's row tiles, the state terms (B gst^T, x gst) are added with
// gst staged where C_i was.  gcs accumulates in shared memory (row and
// column sums of gS o S by shared atomics); the reverse cumsum is a
// block-wide scan.  About 136 KB of shared memory a block.
//
// gcs, gdA and gA accumulate in f64.  gA = sum_s g_s (dt_0 + ... + dt_s)
// weighs each row's gcs by a prefix sum of dt that reaches ~200 at the
// training shape, while the row and column sums of gS o S that make up g
// cancel to a small remainder; so a head's gA (~1e4) is a sum of terms
// many times larger, and rounding g or gdA to f32 moved gA by up to 2x
// the 3e-4 tolerance on some random inputs (the f32 plain version by up
// to 8x).  The products themselves stay f32; only their sums are f64,
// about 2 f64 adds per (i, j) pair against ~2(N + P) f32 FMAs.
//
// ptxas -v (sm_90a): 168 registers, no spills.
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

// gacc (f64), red (f64), then the f32 arrays and tiles
constexpr int SMEM_FLOATS =
    2 * QMAX + 2 * 32 + 4 * QMAX + 2 * TQ * NP + 2 * TQ * PP + 2 * TQ * TP;
static_assert(PMAX <= TQ, "gst is staged in the C tile");

__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ cs_in,
                     const float* __restrict__ gy, const float* __restrict__ gst,
                     const float* __restrict__ gcs, float* __restrict__ gx,
                     float* __restrict__ gdt, double* __restrict__ gA_blk,
                     float* __restrict__ gB, float* __restrict__ gC, int H,
                     int nc, int Q, int P, int G, int N) {
  extern __shared__ double smem_d[];
  double* gacc = smem_d;            // [QMAX] gradient of cs, accumulated
  double* red = gacc + QMAX;        // [32] scan scratch
  float* cs = reinterpret_cast<float*>(red + 32);  // [QMAX] cumsum of dt A
  float* dts = cs + QMAX;           // [QMAX] dt
  float* ws = dts + QMAX;           // [QMAX] w = exp(cs_last - cs)
  float* gux = ws + QMAX;           // [QMAX] rowsum(gu o x)
  float* Ci = gux + QMAX;           // [TQ][NP] C rows of the row tile; gst
  float* Bj = Ci + TQ * NP;         // [TQ][NP] B rows of the column tile
  float* GYi = Bj + TQ * NP;        // [TQ][PP] gy rows of the row tile
  float* Xj = GYi + TQ * PP;        // [TQ][PP] x rows of the column tile
  float* Sc = Xj + TQ * PP;         // [TQ][TP] S = G o L
  float* GG = Sc + TQ * TP;         // [TQ][TP] gG = gS o L
  float* Gst = Ci;                  // [PMAX][NP] gst, between row-tile loops

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h * G / H;
  const size_t blk = ((size_t)b * H + h) * nc + c;
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* xb = x + blk * Q * P;
  const float* gyb = gy + blk * Q * P;
  const float* gstb = gst + blk * P * N;
  const float* Bb = Bm + gblk * Q * N;
  const float* Cb = Cm + gblk * Q * N;
  float* gxb = gx + blk * Q * P;
  float* gBb = gB + blk * Q * N;
  float* gCb = gC + blk * Q * N;
  const float a = A[h];

  if (tid < Q) {
    cs[tid] = cs_in[blk * Q + tid];
    dts[tid] = dt[blk * Q + tid];
    gacc[tid] = gcs[blk * Q + tid];
  }
  __syncthreads();
  if (tid < Q) ws[tid] = expf(cs[Q - 1] - cs[tid]);

  const int nt = (Q + TQ - 1) / TQ;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TQ, nj = min(TQ, Q - j0);
    __syncthreads();                // readers of Bj, Xj, Gst done
    load_rows(Bj, NP, Bb, j0, nj, N);
    load_rows(Xj, PP, xb, j0, nj, P);
    float gbacc[4][8];              // gB[j = ty + 16r][n = tx + 16q]
    float guacc[4][4];              // gu[j = ty + 16r][p = tx + 16q]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) gbacc[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) guacc[r][q] = 0.f;
    }

    for (int it = jt; it < nt; ++it) {
      const int i0 = it * TQ, ni = min(TQ, Q - i0);
      __syncthreads();              // readers of Ci, GYi, Sc, GG done
      load_rows(Ci, NP, Cb, i0, ni, N);
      load_rows(GYi, PP, gyb, i0, ni, P);
      __syncthreads();

      // G_ij = C_i . B_j and gy_i . x_j for i = ty + 16r, j = tx + 16q
      float gt[4][4], yt[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[r][q] = yt[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ci[(ty + 16 * r) * NP + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bj[(tx + 16 * q) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) gt[r][q] = fmaf(cv[r], bv[q], gt[r][q]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = GYi[(ty + 16 * r) * PP + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xj[(tx + 16 * q) * PP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yt[r][q] = fmaf(gv[r], xv[q], yt[r][q]);
      }
      double colpart[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        double rowpart = 0.0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          const bool ok = i < ni && j < nj && i0 + i >= j0 + j;
          // exp only below the diagonal (no overflow, no inf * 0); rows
          // past the chunk hold stale tiles, so every term is selected
          const float L = ok ? expf(cs[i0 + i] - cs[j0 + j]) : 0.f;
          const float S = ok ? gt[r][q] * L : 0.f;
          const float gG = ok ? yt[r][q] * dts[j0 + j] * L : 0.f;  // gS o L
          const float R = ok ? gG * gt[r][q] : 0.f;                  // gS o S
          Sc[i * TP + j] = S;
          GG[i * TP + j] = gG;
          rowpart += R;
          colpart[q] += R;
        }
        rowpart = row_sum16(rowpart);
        if (tx == 0 && i < ni) atomicAdd(&gacc[i0 + i], rowpart);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tx + 16 * q;
        if (j < nj) atomicAdd(&gacc[j0 + j], -colpart[q]);
      }
      __syncthreads();              // Sc, GG complete

      // gC_i += gG B_j  (i = ty + 16r, n = tx + 16q)
      {
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 4
        for (int j = 0; j < nj; ++j) {
          float gv[4], bv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r] = GG[(ty + 16 * r) * TP + j];
#pragma unroll
          for (int q = 0; q < 8; ++q) bv[q] = Bj[j * NP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(gv[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r;
          if (i >= ni) continue;
          float* row = gCb + (size_t)(i0 + i) * N;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = tx + 16 * q;
            if (n < N) row[n] = jt == 0 ? acc[r][q] : row[n] + acc[r][q];
          }
        }
      }
      // gB_j += gG^T C_i,  gu_j += S^T gy_i  (j = ty + 16r)
#pragma unroll 4
      for (int i = 0; i < ni; ++i) {
        float gv[4], sv[4], cv[8], yv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          gv[r] = GG[i * TP + ty + 16 * r];
          sv[r] = Sc[i * TP + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) cv[q] = Ci[i * NP + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[q] = GYi[i * PP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 8; ++q) gbacc[r][q] = fmaf(gv[r], cv[q], gbacc[r][q]);
#pragma unroll
          for (int q = 0; q < 4; ++q) guacc[r][q] = fmaf(sv[r], yv[q], guacc[r][q]);
        }
      }
    }

    // the chunk-state terms of column tile j, with gst where C_i was
    __syncthreads();                // readers of Ci done
    load_rows(Gst, NP, gstb, 0, P, N);
    __syncthreads();
    float bg[4][4], xg[4][8];       // (B gst^T)[j][p], (x gst)[j][n]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) bg[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) xg[r][q] = 0.f;
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bj[(ty + 16 * r) * NP + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = Gst[(tx + 16 * q) * NP + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) bg[r][q] = fmaf(bv[r], sv[q], bg[r][q]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float xv[4], sv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = Xj[(ty + 16 * r) * PP + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) sv[q] = Gst[p * NP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) xg[r][q] = fmaf(xv[r], sv[q], xg[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      const bool live = j < nj;
      const float wj = live ? ws[j0 + j] : 0.f;
      const float dj = live ? dts[j0 + j] : 0.f;
      float gxs = 0.f, gw = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (live && p < P) {
          const float xv = Xj[j * PP + p];
          const float gu = guacc[r][q] + wj * bg[r][q];
          gxb[(size_t)(j0 + j) * P + p] = gu * dj;
          gxs = fmaf(gu, xv, gxs);
          gw = fmaf(xv, bg[r][q], gw);
        }
      }
      gxs = row_sum16(gxs);
      const double gws = (double)row_sum16(gw) * dj * wj;  // gw_j w_j
      if (tx == 0 && live) {
        gux[j0 + j] = gxs;
        atomicAdd(&gacc[j0 + j], -gws);
        atomicAdd(&gacc[Q - 1], gws);
      }
      if (live) {
        float* row = gBb + (size_t)(j0 + j) * N;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (n < N) row[n] = gbacc[r][q] + wj * dj * xg[r][q];
        }
      }
    }
  }
  __syncthreads();                  // gacc, gux complete

  // gdA = reverse cumsum of gacc: scan the reversed sequence
  const int t = Q - 1 - tid;
  const double gdA_rev = block_scan(tid < Q ? gacc[t] : 0.0, red);
  double part = 0.0;
  if (tid < Q) {
    gdt[blk * Q + t] = (float)(gdA_rev * a + gux[t]);
    part = gdA_rev * dts[t];
  }
  // gA: block sum of gdA dt
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  __syncthreads();                  // block_scan's readers of red are done
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int k = 0; k < THREADS / 32; ++k) s += red[k];
    gA_blk[blk] = s;
  }
}

}  // namespace

extern "C" {

// Inputs as the forward's, plus cs (B, H, nc, Q) from the forward and the
// output gradients gy (B, H, nc, Q, P), gst (B, H, nc, P, N),
// gcs (B, H, nc, Q); writes gx (B, H, nc, Q, P), gdt (B, H, nc, Q),
// gA_blk (B, H, nc) in f64, and per-head gB, gC (B, H, nc, Q, N).  The
// rest f32; all contiguous.  Returns the cudaError_t of the launch.
int ssd_intra_bwd_launch(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* cs,
                         const void* gy, const void* gst, const void* gcs,
                         void* gx, void* gdt, void* gA_blk, void* gB, void* gC,
                         int B, int H, int nc, int Q, int P, int G, int N,
                         void* stream) {
  if (B < 1 || H < 1 || nc < 1 || Q < 1 || Q > QMAX || P < 1 || P > PMAX ||
      N < 1 || N > NMAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  ssd_intra_bwd_kernel<<<dim3(nc, H, B), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      f(x), f(dt), f(A), f(Bm), f(Cm), f(cs), f(gy), f(gst), f(gcs), m(gx),
      m(gdt), static_cast<double*>(gA_blk), m(gB), m(gC), H, nc, Q, P, G, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
