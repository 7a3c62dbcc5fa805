// Mamba-2 SSD intra-chunk pass for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:59
// `ssd_intra_pallas` (`_ssd_kernel` :26).  Per (batch b, head h, chunk c),
// with the chunk's Q rows of x (Q, P), dt (Q), B and C (Q, N) of group
// g = h G / H and the head's A:
//   cs      = inclusive cumsum of dt A                     (Q)
//   y_intra = ((C B^T) o L) (x dt),  L_ij = exp(cs_i - cs_j) for i >= j
//   state   = (x dt exp(cs_{Q-1} - cs))^T B                (P, N)
// Outputs y (B, H, nc, Q, P), states (B, H, nc, P, N), cs (B, H, nc, Q).
//
// What bounds it on an H100: at the training shape (B 4, 32 heads, 8 chunks
// of Q 256, P 64, N 128; 1,024 blocks) the reference's matmuls are
// 2Q^2N + 2Q^2P + 2QPN = 29.4 MFLOP a block, 30 GFLOP a call, 0.45 ms on
// the 67 TFLOP/s f32 units, against 178 MB moved (0.053 ms at 3.35 TB/s):
// bound by operations.  This first kernel does them on the FMA units from
// shared memory (no TF32, no wgmma), and skips the tiles above the
// diagonal, which the causal mask zeroes (about 2/3 of the reference's
// count remains).
//
// Design.  The TPU keeps the whole Q x Q score tile in VMEM; at Q = 256
// that is 256 KB, more than a Hopper block's 227 KB of shared memory.  So
// one block per (b, h, c) walks 64-row tiles of queries i and, for each,
// the column tiles j <= i: the 64 x 64 scores C_i B_j^T are scaled by the
// decay and masked in registers (exp only where i >= j, so no inf * 0),
// staged in shared memory, and y_i accumulates S_ij u_j in registers.  The
// last row tile visits every column tile, so the chunk state accumulates
// there from the same B_j and u_j tiles.  The cumsum is a block-wide scan
// (the TPU builds it with a triangular matmul because Mosaic has none).
// Any Q <= 256, P <= 64, N <= 128; rows past Q are never read.  B and C
// are read per group (h G / H), never repeated.  About 100 KB of shared
// memory a block, two blocks an SM.
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

constexpr int SMEM_FLOATS = 2 * QMAX + 32 + 2 * TQ * NP + TQ * PP + TQ * TP;

__global__ void __launch_bounds__(THREADS, 2)
ssd_intra_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, float* __restrict__ cs_out, int H,
                     int nc, int Q, int P, int G, int N) {
  extern __shared__ float smem[];
  float* cs = smem;                 // [QMAX] cumsum of dt A
  float* dts = cs + QMAX;           // [QMAX] dt
  float* red = dts + QMAX;          // [32] scan scratch
  float* Ci = red + 32;             // [TQ][NP] C rows of the row tile
  float* Bj = Ci + TQ * NP;         // [TQ][NP] B rows of the column tile
  float* Uj = Bj + TQ * NP;         // [TQ][PP] u = x dt, column tile
  float* Sc = Uj + TQ * PP;         // [TQ][TP] masked, decayed scores

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h * G / H;
  const size_t blk = ((size_t)b * H + h) * nc + c;
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* xb = x + blk * Q * P;
  const float* Bb = Bm + gblk * Q * N;
  const float* Cb = Cm + gblk * Q * N;

  const float dtv = tid < Q ? dt[blk * Q + tid] : 0.f;
  const float csv = block_scan(dtv * A[h], red);
  if (tid < Q) {
    cs[tid] = csv;
    dts[tid] = dtv;
    cs_out[blk * Q + tid] = csv;
  }

  float sacc[4][8];                 // state[p = ty + 16r][n = tx + 16q]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) sacc[r][q] = 0.f;

  const int nt = (Q + TQ - 1) / TQ;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * TQ, ni = min(TQ, Q - i0);
    __syncthreads();                // cs / dts written; Ci readers done
    load_rows(Ci, NP, Cb, i0, ni, N);
    float yacc[4][4];               // y[i = ty + 16r][p = tx + 16q]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[r][q] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * TQ, nj = min(TQ, Q - j0);
      __syncthreads();              // readers of Bj, Uj, Sc done
      load_rows(Bj, NP, Bb, j0, nj, N);
      load_rows(Uj, PP, xb, j0, nj, P, dts);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
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
          for (int q = 0; q < 4; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          const bool ok = i < ni && j < nj && i0 + i >= j0 + j;
          // exp only below the diagonal: above it cs_i - cs_j > 0 can
          // overflow, and inf * 0 would be NaN
          Sc[i * TP + j] = ok ? s[r][q] * expf(cs[i0 + i] - cs[j0 + j])
                              : 0.f;
        }
      }
      if (it == nt - 1) {
        // the chunk state from the same tiles: sum_j u_jp w_j B_jn
        const float last = cs[Q - 1];
        for (int j = 0; j < nj; ++j) {
          const float wj = expf(last - cs[j0 + j]);
          float uv[4], bv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) uv[r] = Uj[j * PP + ty + 16 * r] * wj;
#pragma unroll
          for (int q = 0; q < 8; ++q) bv[q] = Bj[j * NP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              sacc[r][q] = fmaf(uv[r], bv[q], sacc[r][q]);
        }
      }
      __syncthreads();              // Sc complete
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        float sv[4], uv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = Sc[(ty + 16 * r) * TP + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) uv[q] = Uj[j * PP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] = fmaf(sv[r], uv[q], yacc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i >= ni) continue;
      float* yrow = y + (blk * Q + i0 + i) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) yrow[p] = yacc[r][q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
    float* srow = st + (blk * P + p) * N;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (n < N) srow[n] = sacc[r][q];
    }
  }
}

}  // namespace

extern "C" {

// x (B, H, nc, Q, P), dt (B, H, nc, Q), A (H), Bm / Cm (B, G, nc, Q, N), all
// f32 and contiguous; writes y (B, H, nc, Q, P), st (B, H, nc, P, N),
// cs (B, H, nc, Q).  Returns the cudaError_t of the launch.
int ssd_intra_launch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* st,
                     void* cs, int B, int H, int nc, int Q, int P, int G,
                     int N, void* stream) {
  if (B < 1 || H < 1 || nc < 1 || Q < 1 || Q > QMAX || P < 1 || P > PMAX ||
      N < 1 || N > NMAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  ssd_intra_fwd_kernel<<<dim3(nc, H, B), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(cs), H, nc, Q, P, G, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
