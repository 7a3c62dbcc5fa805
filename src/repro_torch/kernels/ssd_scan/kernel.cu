// Mamba-2 SSD intra-chunk pass for Hopper (sm_90a), f32 in and out.
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
// What bounds it on an H100.  C B^T depends on the group only, so the work
// the function needs is B G nc pairs 2N for it plus B H nc (pairs 2P +
// 2QPN) for the heads, pairs = Q (Q + 1) / 2 causal (i, j): at the
// training shape (B 4, H 32, G 1, nc 8, Q 256, P 64, N 128) 8.9 GFLOP,
// 0.054 ms at the 165 TFLOP/s of f32-accurate tensor-core products (three
// TF32 passes of 495), against 78 MB moved (0.023 ms at 3.35 TB/s): bound
// by operations.
//
// Design: three launches in one call.
//   1. `ssd_cb_kernel` (ssd_common.cuh): C_i B_j^T once per (b, g, c) and
//      causal tile pair, f32 on the FMA units (0.27 GFLOP at the training
//      shape), into a (B, G, nc, pairs, 64, 64) scratch of the wrapper.
//   2. `ssd_fwd_y_kernel`, one block per (head, row tile i, chunk, batch),
//      heads fastest, so the heads of one (b, g, c) run together while
//      their C B^T tiles sit in L2.  For j <= i it copies the C B^T tile
//      and x_j with 16-byte `cp.async` through a two-stage ring, turns the
//      tile into S = CB o L o dt_j in place (exp only where i >= j, so no
//      inf * 0), and accumulates y_i += S x_j on the tensor cores
//      (`mma.sync` m16n8k8 TF32, three passes, `warp_mma`).  dt is folded
//      into S, so x is copied as it is.
//   3. `ssd_fwd_state_kernel`, one block per (head, chunk, batch): the
//      state sum_j (x_j dt_j w_j)^T B_j, w = exp(cs_last - cs), the same
//      way, the row scale applied as the A fragment is read.
// Each block rebuilds the head's cumsum with a block-wide scan (the TPU
// builds it with a triangular matmul).  Any Q <= 256, P <= 64, N <= 128;
// rows past Q are zero-filled, never read.  Shared memory: 72 KB a block
// for pass 2 (three blocks an SM), 110 KB for pass 3 (two).
//
// ptxas -v (sm_90a): `ssd_fwd_y_kernel` 79 registers,
// `ssd_fwd_state_kernel` 119, `ssd_cb_kernel` 32; no spills.  At the
// training shape pass 2 takes about 0.25 ms, pass 3 0.13, pass 1 0.03 on
// an H100 (PERF.md): latency-bound, the tensor cores busy a fifth of the
// time.
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

constexpr int SP = TQ + 4;       // S tile [i][j]: A operand, t walks j
constexpr int XP = PMAX + 8;     // x tile [j][p]: B operand (y) and A^T (state)
constexpr int BP = NMAX + 8;     // B tile [j][n]: B operand, g walks n
constexpr int Y_STAGE = TQ * SP + TQ * XP;
constexpr int Y_SMEM = (2 * QMAX + 32 + 2 * Y_STAGE) * (int)sizeof(float);
constexpr int ST_STAGE = TQ * XP + TQ * BP;
constexpr int ST_SMEM = (3 * QMAX + 32 + 2 * ST_STAGE) * (int)sizeof(float);

// cs = cumsum(dt A) of the head into shared cs[], dt into dts[]; returns
// this thread's cs (row tid).
__device__ __forceinline__ float head_cumsum(const float* dt, float a, int Q,
                                             float* cs, float* dts,
                                             float* red) {
  const int tid = threadIdx.x;
  const float dtv = tid < Q ? dt[tid] : 0.f;
  const float csv = block_scan(dtv * a, red);
  if (tid < Q) {
    cs[tid] = csv;
    dts[tid] = dtv;
  }
  return csv;
}

__global__ void __launch_bounds__(THREADS, 3)
ssd_fwd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ cb,
                 float* __restrict__ y, float* __restrict__ cs_out, int H,
                 int nc, int Q, int P, int G) {
  extern __shared__ float smem[];
  float* cs = smem;                 // [QMAX] cumsum of dt A
  float* dts = cs + QMAX;           // [QMAX] dt
  float* red = dts + QMAX;          // [32] scan scratch
  float* ring = red + 32;           // 2 x {S [TQ][SP], X [TQ][XP]}

  const int h = blockIdx.x, c = blockIdx.y % nc, it = blockIdx.y / nc;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const size_t blk = ((size_t)b * H + h) * nc + c;
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* xb = x + blk * Q * P;
  const float* cbb = cb + gblk * n_pairs(Q) * TILE;
  const int i0 = it * TQ, ni = min(TQ, Q - i0);

  const float csv = head_cumsum(dt + blk * Q, A[h], Q, cs, dts, red);
  if (it == 0 && (int)threadIdx.x < Q) cs_out[blk * Q + threadIdx.x] = csv;
  __syncthreads();

  const int warp = threadIdx.x >> 5, m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float acc[1][4][4];
  zero(acc);
  auto S = [&](int s) { return ring + s * Y_STAGE; };
  auto X = [&](int s) { return ring + s * Y_STAGE + TQ * SP; };
  pipeline(
      it + 1,
      [&](int jt, int s) {
        const float* src = cbb + (size_t)(it * (it + 1) / 2 + jt) * TILE;
        load_rows<TQ>(S(s), SP, src, 0, TQ, TQ);
        load_rows<PMAX>(X(s), XP, xb, jt * TQ, min(TQ, Q - jt * TQ), P);
      },
      [&](int jt, int s) {
        float* St = S(s);
        const int j0 = jt * TQ;
        for (int e = threadIdx.x; e < TILE; e += THREADS) {
          const int r = e / TQ, q = e % TQ;
          const int gi = i0 + r, gj = j0 + q;
          const bool ok = gi < Q && gj < Q && gi >= gj;
          float* v = St + r * SP + q;
          *v = ok ? *v * expf(cs[gi] - cs[gj]) * dts[gj] : 0.f;
        }
        __syncthreads();
        const float* Xt = X(s);
        warp_mma<1, 4>(
            acc, round8(min(TQ, Q - j0)), P - n0,
            [&](int m, int k) { return St[(m0 + m) * SP + k]; },
            [&](int k, int n) { return Xt[k * XP + n0 + n]; });
      });
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = m0 + acc_row(0, r), p = n0 + acc_col(nt, r);
      if (i < ni && p < P) y[(blk * Q + i0 + i) * P + p] = acc[0][nt][r];
    }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     float* __restrict__ st, int H, int nc, int Q, int P,
                     int G, int N) {
  extern __shared__ float smem[];
  float* cs = smem;                 // [QMAX]
  float* dts = cs + QMAX;           // [QMAX]
  float* sc = dts + QMAX;           // [QMAX] dt w, the row scale of x
  float* red = sc + QMAX;           // [32]
  float* ring = red + 32;           // 2 x {X [TQ][XP], B [TQ][BP]}

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const size_t blk = ((size_t)b * H + h) * nc + c;
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* xb = x + blk * Q * P;
  const float* Bb = Bm + gblk * Q * N;

  head_cumsum(dt + blk * Q, A[h], Q, cs, dts, red);
  __syncthreads();
  if ((int)threadIdx.x < Q)
    sc[threadIdx.x] = dts[threadIdx.x] * expf(cs[Q - 1] - cs[threadIdx.x]);
  else
    sc[threadIdx.x] = 0.f;
  __syncthreads();

  // st (p, n), 64 x 128: warps 2 (p) x 4 (n), 32 x 32 each
  const int warp = threadIdx.x >> 5, m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  float acc[2][4][4];
  zero(acc);
  auto X = [&](int s) { return ring + s * ST_STAGE; };
  auto Bt = [&](int s) { return ring + s * ST_STAGE + TQ * XP; };
  pipeline(
      n_tiles(Q),
      [&](int jt, int s) {
        const int nj = min(TQ, Q - jt * TQ);
        load_rows<PMAX>(X(s), XP, xb, jt * TQ, nj, P);
        load_rows<NMAX>(Bt(s), BP, Bb, jt * TQ, nj, N);
      },
      [&](int jt, int s) {
        if (m0 >= P) return;
        const float* Xt = X(s);
        const float* Bs = Bt(s);
        const float* scj = sc + jt * TQ;
        warp_mma<2, 4>(
            acc, round8(min(TQ, Q - jt * TQ)), N - n0,
            [&](int m, int k) { return Xt[k * XP + m0 + m] * scj[k]; },
            [&](int k, int n) { return Bs[k * BP + n0 + n]; });
      });
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = m0 + acc_row(mt, r), n = n0 + acc_col(nt, r);
        if (p < P && n < N) st[(blk * P + p) * N + n] = acc[mt][nt][r];
      }
}

}  // namespace

extern "C" {

// x (B, H, nc, Q, P), dt (B, H, nc, Q), A (H), Bm / Cm (B, G, nc, Q, N), all
// f32 and contiguous; cb is the wrapper's (B, G, nc, pairs, 64, 64) f32
// scratch.  Writes y (B, H, nc, Q, P), st (B, H, nc, P, N),
// cs (B, H, nc, Q).  Returns the cudaError_t of the first failing launch.
int ssd_intra_launch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* st,
                     void* cs, void* cb, int B, int H, int nc, int Q, int P,
                     int G, int N, void* stream) {
  if (B < 1 || H < 1 || nc < 1 || Q < 1 || Q > QMAX || P < 1 || P > PMAX ||
      N < 1 || N > NMAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = allow_smem(ssd_cb_kernel, CB_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_fwd_y_kernel, Y_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_fwd_state_kernel, ST_SMEM)) != cudaSuccess)
    return (int)e;
  ssd_cb_kernel<<<dim3(n_pairs(Q), nc, B * G), THREADS, CB_SMEM, s>>>(
      f(Bm), f(Cm), m(cb), nc, Q, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_fwd_y_kernel<<<dim3(H, nc * n_tiles(Q), B), THREADS, Y_SMEM, s>>>(
      f(x), f(dt), f(A), f(cb), m(y), m(cs), H, nc, Q, P, G);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_fwd_state_kernel<<<dim3(H, nc, B), THREADS, ST_SMEM, s>>>(
      f(x), f(dt), f(A), f(Bm), m(st), H, nc, Q, P, G, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
