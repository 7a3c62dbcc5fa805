// Gradient of the Mamba-2 SSD intra-chunk pass (kernel.cu) for Hopper
// (sm_90a), f32 in and out.
//
// The TPU kernel src/repro/kernels/ssd_scan/kernel.py:59 `ssd_intra_pallas`
// has no VJP of its own: the JAX trainer differentiates the jnp SSD
// (`ref.py` `ssd_reference`).  These kernels compute the gradient XLA
// derives from its intra-chunk part, given the output gradients gy (Q, P),
// gst (P, N) and gcs (Q) of each (batch b, head h, chunk c).  With u = x dt,
// CB = C B^T, L_ij = exp(cs_i - cs_j) (i >= j), S = CB o L and
// w_j = exp(cs_last - cs_j):
//   gS  = gy u^T masked to i >= j,          gG = gS o L
//   gu  = S^T gy + w o (B gst^T)
//   gC  = (sum_h gG) B,   gB = (sum_h gG)^T C + sum_h w o (u gst)
//   gcs_i += sum_j (gS o S)_ij,  gcs_j -= sum_i (gS o S)_ij
//   gw_j = sum_p u_jp (B gst^T)_jp:  gcs_j -= gw_j w_j,  gcs_last += sum gw w
//   gdA = reverse cumsum of gcs,  gdt = gdA A + rowsum(gu o x),  gx = gu dt
//   gA  = sum_t gdA_t dt_t  (one f64 partial per block; the wrapper sums
//         them in f64)
// sum_h runs over the heads of the group.
//
// What bounds it on an H100.  The work the function needs: B G nc pairs 6N
// for the group's products (C B^T, gC, gB) plus B H nc (pairs 4P + 4QPN)
// for the heads' (gS, S^T gy, B gst^T, u gst): 18.0 GFLOP at the training
// shape (B 4, H 32, G 1, nc 8, Q 256, P 64, N 128), 0.109 ms at the 165
// TFLOP/s of f32-accurate tensor-core products (three TF32 passes of 495),
// against 105 MB moved (0.031 ms): bound by operations.  This design does
// pairs 2P a head more (gS is formed twice, below).
//
// Design: five launches in one call, no f32 atomics to device memory, no
// per-head (Q, N) or (Q, Q) buffer.
//   1. `ssd_cb_kernel` (ssd_common.cuh): C B^T once per (b, g, c) and tile
//      pair into the wrapper's (B, G, nc, pairs, 64, 64) scratch.
//   2. `ssd_bwd_head_kernel`, one block per (head, chunk, batch): walks the
//      column tiles j, and for each a two-stage `cp.async` ring of items:
//      first B_j and gst in 64-column parts of N, which start gu_j as
//      (w o B_j) gst^T (the chunk-state term; gw_j is read off it), then
//      the row tiles i >= j with their C B^T and gy_i tiles.  gS =
//      gy_i x_j^T dt_j runs on the tensor cores; S, gG and R = gG o CB are
//      formed at the accumulators (exp only where i >= j); R's row and
//      column sums go to gcs in f64, through one shared slot per warp
//      summed in a fixed order; S is written back into its tile and
//      gu_j += S^T gy_i runs on the tensor cores.  Then gx and
//      rowsum(gu o x); last the reverse cumsum and gA in f64.  97 KB of
//      shared memory, two blocks an SM.
//   3. `ssd_bwd_gsum_kernel`, one block per (tile pair, chunk, batch and
//      group): the sum over the group's heads of gG_ij, in head order, in
//      registers, from gS recomputed per head (gy_i x_j^T through a ring of
//      the heads' tiles); written to a second pair scratch.
//   4-5. `ssd_bwd_bc_kernel`, one block per (row tile, chunk, batch and
//      group): gC_t = sum_{j <= t} gGsum_tj B_j; gB_t = sum_{i >= t}
//      gGsum_it^T C_i + sum_h (x dt w)_h,t gst_h, the last one product over
//      the group's heads and P.
// Every product except C B^T runs in three TF32 passes (ssd_common.cuh).
//
// gcs, gdA and gA accumulate in f64.  gA = sum_s g_s (dt_0 + ... + dt_s)
// weighs each row's gcs by a prefix sum of dt that reaches ~200 at the
// training shape, while the row and column sums of gS o S that make up g
// cancel to a small remainder; so a head's gA (~1e4) is a sum of terms
// many times larger, and rounding g or gdA to f32 moved gA by up to 2x the
// 3e-4 tolerance on some random inputs.  The products stay f32-accurate;
// only those sums are f64, from the first add of R's terms on.
//
// ptxas -v (sm_90a): `ssd_bwd_head_kernel` 128 registers (the
// cap for two blocks an SM) with 16 bytes spilled, `ssd_bwd_bc_kernel`
// 121 / 123, `ssd_bwd_gsum_kernel` 79, `ssd_cb_kernel` 32.  At the training
// shape pass 2 takes about 0.63 ms, pass 3 0.25, passes 4-5 0.19, pass 1
// 0.03 on an H100 (PERF.md): latency-bound per ring item, and passes 3-5
// walk a group's 32 heads in sequence on few blocks.
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

// ---- pass 2: per head
constexpr int HX = PMAX + 4;     // x_j [j][p]: B operand of gS (g walks j)
constexpr int HS = TQ + 8;       // CB / S [i][j]: S^T is gu's A (g walks j)
constexpr int HY = PMAX + 4;     // gy_i [i][p]: gS's A; gu's B (2-way)
constexpr int HN = TQ + 4;       // B_j / gst, 64 columns of N at a time
constexpr int H_STAGE = TQ * HS + TQ * HY;
static_assert(TQ * HN <= TQ * HS && TQ * HN <= TQ * HY, "state parts fit");
constexpr int H_SMEM = (QMAX + 32 + 6 * TQ) * (int)sizeof(double) +
                       (4 * QMAX + 4 * TQ + TQ * HX + 2 * H_STAGE) *
                           (int)sizeof(float);

// ---- pass 3: per group, sum of gG over heads
constexpr int GP = PMAX + 4;     // gy_i and x_j of one head
constexpr int G_STAGE = 2 * TQ * GP + 3 * TQ;
constexpr int G_SMEM = 2 * G_STAGE * (int)sizeof(float);

// ---- passes 4-5: gC and gB per group
constexpr int BA = TQ + 8;       // A tiles: gGsum [i][j] (68 used for gC), x
constexpr int BB = NMAX + 8;     // B tiles: B_j / C_i / gst [k][n]
constexpr int BC_STAGE = TQ * BA + TQ * BB + 2 * TQ + 4;
constexpr int BC_SMEM = (2 * BC_STAGE + TQ) * (int)sizeof(float);

__device__ __forceinline__ double shfl_xor(double v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ cb, const float* __restrict__ cs_in,
                    const float* __restrict__ gy, const float* __restrict__ gst,
                    const float* __restrict__ gcs, float* __restrict__ gx,
                    float* __restrict__ gdt, double* __restrict__ gA_blk, int H,
                    int nc, int Q, int P, int G, int N) {
  extern __shared__ double smem_d[];
  double* gacc = smem_d;            // [QMAX] gradient of cs, accumulated
  double* red = gacc + QMAX;        // [32] scan scratch
  double* rsum = red + 32;          // [2][TQ] row sums of R by column half
  double* csum = rsum + 2 * TQ;     // [4][TQ] column sums of R by row slab
  float* cs = reinterpret_cast<float*>(csum + 4 * TQ);  // [QMAX] cumsum
  float* dts = cs + QMAX;           // [QMAX]
  float* ws = dts + QMAX;           // [QMAX] w = exp(cs_last - cs), 0 past Q
  float* gux = ws + QMAX;           // [QMAX] rowsum(gu o x)
  float* part = gux + QMAX;         // [2][2][TQ] per column-half row sums
  float* Xj = part + 4 * TQ;        // [TQ][HX]
  float* ring = Xj + TQ * HX;       // 2 x {CB/S [TQ][HS], gy [TQ][HY]}

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3, g8 = lane >> 2;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const size_t blk = ((size_t)b * H + h) * nc + c;
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* xb = x + blk * Q * P;
  const float* gyb = gy + blk * Q * P;
  const float* gstb = gst + blk * P * N;
  const float* Bb = Bm + gblk * Q * N;
  const float* cbb = cb + gblk * n_pairs(Q) * TILE;
  float* gxb = gx + blk * Q * P;
  const float a = A[h];

  if (tid < Q) {
    cs[tid] = cs_in[blk * Q + tid];
    dts[tid] = dt[blk * Q + tid];
    gacc[tid] = gcs[blk * Q + tid];
  }
  __syncthreads();
  ws[tid] = tid < Q ? expf(cs[Q - 1] - cs[tid]) : 0.f;

  // warps 4 (rows) x 2 (columns) over 64 x 64 tiles
  const int wm = warp & 3, wn = warp >> 2, m0 = wm * 16, n0 = wn * 32;
  const int nt = n_tiles(Q), ns = (N + TQ - 1) / TQ;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TQ, nj = min(TQ, Q - j0);
    __syncthreads();                // readers of Xj, the ring, part done
    load_rows<PMAX>(Xj, HX, xb, j0, nj, P);
    float gu[1][4][4];
    zero(gu);
    // items: ns parts of N for the state term, then the row tiles i >= j
    pipeline(
        ns + nt - jt,
        [&](int k, int s) {
          float* st = ring + s * H_STAGE;
          if (k < ns) {             // gst[:, part] and B_j[:, part]
            const int nn = min(TQ, N - k * TQ);
            load_tile<TQ>(st, HN, gstb + k * TQ, N, 0, P, nn);
            load_tile<TQ>(st + TQ * HS, HN, Bb + k * TQ, N, j0, nj, nn);
          } else {
            const int it = jt + k - ns;
            load_rows<TQ>(st, HS,
                          cbb + (size_t)(it * (it + 1) / 2 + jt) * TILE, 0,
                          TQ, TQ);
            load_rows<PMAX>(st + TQ * HS, HY,
                            gyb, it * TQ, min(TQ, Q - it * TQ), P);
          }
        },
        [&](int k, int s) {
          float* St = ring + s * H_STAGE;
          const float* Gy = St + TQ * HS;
          if (k < ns) {
            // gu_j starts as w_j (B_j gst^T)_j: the chunk-state term
            const int nn = min(TQ, N - k * TQ);
            warp_mma<1, 4>(
                gu, round8(nn), P - n0,
                [&](int m, int kk) {
                  return Gy[(m0 + m) * HN + kk] * ws[j0 + m0 + m];
                },
                [&](int kk, int n) { return St[(n0 + n) * HN + kk]; });
            if (k == ns - 1) {      // gw_j w_j / dt_j = sum_p x_jp gu_jp
              float gw[2] = {0.f, 0.f};
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int j = m0 + acc_row(0, r), p = n0 + acc_col(q, r);
                  if (p < P) gw[r >> 1] = fmaf(Xj[j * HX + p], gu[0][q][r],
                                               gw[r >> 1]);
                }
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float v = gw[u];
                v += shfl_xor(v, 1);
                v += shfl_xor(v, 2);
                if (t4 == 0) part[2 * TQ + wn * TQ + m0 + g8 + 8 * u] = v;
              }
            }
            return;
          }
          const int i0 = (jt + k - ns) * TQ;
          float gs[1][4][4];
          zero(gs);
          warp_mma<1, 4>(
              gs, round8(P), TQ - n0,
              [&](int m, int kk) { return Gy[(m0 + m) * HY + kk]; },
              [&](int kk, int n) { return Xj[(n0 + n) * HX + kk]; });
          // R = gS o S: its row sums (over this thread's columns, then the
          // 4 lanes of a row) and column sums (over the 8 lanes of a
          // column) in f64 go to one slot per warp, summed in a fixed order
          // below (no atomics)
          double rowp[2] = {0.0, 0.0};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            double colp[2] = {0.0, 0.0};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = m0 + acc_row(0, r), j = n0 + acc_col(q, r);
              const int gi = i0 + i, gj = j0 + j;
              const bool ok = gi < Q && gj < Q && gi >= gj;
              float* v = St + i * HS + j;
              const float cbv = *v;
              // exp only below the diagonal (no overflow, no inf * 0)
              const float L = ok ? expf(cs[gi] - cs[gj]) : 0.f;
              const float gG = ok ? gs[0][q][r] * dts[gj] * L : 0.f;
              const double R = (double)(gG * cbv);
              *v = cbv * L;         // S, read transposed below
              rowp[r >> 1] += R;
              colp[r & 1] += R;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              double v = colp[u];
              v += shfl_xor(v, 4);
              v += shfl_xor(v, 8);
              v += shfl_xor(v, 16);
              if (g8 == 0) csum[wm * TQ + n0 + q * 8 + 2 * t4 + u] = v;
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            double v = rowp[u];
            v += shfl_xor(v, 1);
            v += shfl_xor(v, 2);
            if (t4 == 0) rsum[wn * TQ + m0 + g8 + 8 * u] = v;
          }
          __syncthreads();          // S, rsum, csum complete
          if (tid < TQ) {           // rows i0 + tid and columns j0 + tid
            if (i0 + tid < Q) gacc[i0 + tid] += rsum[tid] + rsum[TQ + tid];
            if (j0 + tid < Q)
              gacc[j0 + tid] -= ((csum[tid] + csum[TQ + tid]) +
                                 csum[2 * TQ + tid]) + csum[3 * TQ + tid];
          }
          // gu_j += S^T gy_i: rows j (m0..), columns p (n0..)
          warp_mma<1, 4>(
              gu, round8(min(TQ, Q - i0)), P - n0,
              [&](int m, int kk) { return St[kk * HS + m0 + m]; },
              [&](int kk, int n) { return Gy[kk * HY + n0 + n]; });
        });

    // gx, rowsum(gu o x), and gw's share of gcs
    float gxs[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = m0 + acc_row(0, r), p = n0 + acc_col(q, r);
        if (j0 + j < Q && p < P) {
          const float guv = gu[0][q][r];
          gxb[(size_t)(j0 + j) * P + p] = guv * dts[j0 + j];
          gxs[r >> 1] = fmaf(guv, Xj[j * HX + p], gxs[r >> 1]);
        }
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = gxs[u];
      v += shfl_xor(v, 1);
      v += shfl_xor(v, 2);
      if (t4 == 0) part[wn * TQ + m0 + g8 + 8 * u] = v;
    }
    __syncthreads();
    if (tid < nj) {
      const int j = j0 + tid;
      gux[j] = part[tid] + part[TQ + tid];
      // gw_j w_j, with u = x dt
      const double gws =
          (double)(part[2 * TQ + tid] + part[3 * TQ + tid]) * dts[j];
      atomicAdd(&gacc[j], -gws);
      atomicAdd(&gacc[Q - 1], gws);
    }
  }
  __syncthreads();                  // gacc, gux complete

  // gdA = reverse cumsum of gacc: scan the reversed sequence
  const int t = Q - 1 - tid;
  const double gdA_rev = block_scan(tid < Q ? gacc[t] : 0.0, red);
  double partA = 0.0;
  if (tid < Q) {
    gdt[blk * Q + t] = (float)(gdA_rev * a + gux[t]);
    partA = gdA_rev * dts[t];
  }
  // gA: block sum of gdA dt
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) partA += shfl_xor(partA, off);
  __syncthreads();                  // block_scan's readers of red are done
  if (lane == 0) red[warp] = partA;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int k = 0; k < THREADS / 32; ++k) s += red[k];
    gA_blk[blk] = s;
  }
}

// sum over the group's heads of gG_ij = (gy_i x_j^T) dt_j L_ij (i >= j)
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_gsum_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cs_in, const float* __restrict__ gy,
                    float* __restrict__ gsum, int H, int nc, int Q, int P,
                    int G) {
  extern __shared__ float smem[];
  const int p = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / G, g = bg % G, HG = H / G;
  const int it = pair_row(p), jt = p - it * (it + 1) / 2;
  const int i0 = it * TQ, j0 = jt * TQ;
  const int ni = min(TQ, Q - i0), nj = min(TQ, Q - j0);
  const int warp = threadIdx.x >> 5, m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float sum[1][4][4];
  zero(sum);
  pipeline(
      HG,
      [&](int k, int s) {
        const size_t blk = ((size_t)b * H + g * HG + k) * nc + c;
        float* st = smem + s * G_STAGE;
        load_rows<PMAX>(st, GP, gy + blk * Q * P, i0, ni, P);
        load_rows<PMAX>(st + TQ * GP, GP, x + blk * Q * P, j0, nj, P);
        float* v = st + 2 * TQ * GP;
        load_vec(v, cs_in + blk * Q + i0, ni);
        load_vec(v + TQ, cs_in + blk * Q + j0, nj);
        load_vec(v + 2 * TQ, dt + blk * Q + j0, nj);
      },
      [&](int, int s) {
        const float* Gy = smem + s * G_STAGE;
        const float* Xt = Gy + TQ * GP;
        const float* csi = Xt + TQ * GP;
        const float* csj = csi + TQ;
        const float* dtj = csj + TQ;
        float gs[1][4][4];
        zero(gs);
        warp_mma<1, 4>(
            gs, round8(P), TQ - n0,
            [&](int m, int kk) { return Gy[(m0 + m) * GP + kk]; },
            [&](int kk, int n) { return Xt[(n0 + n) * GP + kk]; });
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = m0 + acc_row(0, r), j = n0 + acc_col(q, r);
            const bool ok = i < ni && j < nj && i0 + i >= j0 + j;
            if (ok) sum[0][q][r] += gs[0][q][r] * dtj[j] * expf(csi[i] - csj[j]);
          }
      });
  float* out = gsum + (((size_t)b * G + g) * nc + c) * n_pairs(Q) * TILE +
               (size_t)p * TILE;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(m0 + acc_row(0, r)) * TQ + n0 + acc_col(q, r)] = sum[0][q][r];
}

// GB false: gC_t = sum_{j <= t} gsum_tj B_j.  GB true: gB_t =
// sum_{i >= t} gsum_it^T C_i + sum_h (x dt w)_h,t gst_h.
template <bool GB>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ BCm, const float* __restrict__ cs_in,
                  const float* __restrict__ gst, const float* __restrict__ gsum,
                  float* __restrict__ out, int H, int nc, int Q, int P, int G,
                  int N) {
  extern __shared__ float smem[];
  float* sc = smem;                 // [TQ] row scale dt w of one head
  float* ring = sc + TQ;            // 2 x {A [TQ][BA], B [TQ][BB], vec}
  const int tt = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / G, g = bg % G, HG = H / G;
  const int t0 = tt * TQ, nrow = min(TQ, Q - t0), nt = n_tiles(Q);
  const size_t gblk = ((size_t)b * G + g) * nc + c;
  const float* gs = gsum + gblk * n_pairs(Q) * TILE;
  const float* mat = BCm + gblk * Q * N;
  // output 64 x 128: warps 2 (rows) x 4 (columns), 32 x 32 each
  const int warp = threadIdx.x >> 5, m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  constexpr int AP = GB ? BA : TQ + 4;
  const int n1 = GB ? nt - tt : tt + 1;   // tile products, then heads
  float acc[2][4][4];
  zero(acc);
  pipeline(
      n1 + (GB ? HG : 0),
      [&](int k, int s) {
        float* At = ring + s * BC_STAGE;
        float* Bt = At + TQ * BA;
        if (k < n1) {
          const int i = GB ? tt + k : tt, j = GB ? tt : k;
          const int o = GB ? i : j;     // rows of B (gC) or C (gB)
          load_rows<TQ>(At, AP, gs + (size_t)(i * (i + 1) / 2 + j) * TILE, 0,
                        TQ, TQ);
          load_rows<NMAX>(Bt, BB, mat, o * TQ, min(TQ, Q - o * TQ), N);
        } else {
          const size_t blk = ((size_t)b * H + g * HG + (k - n1)) * nc + c;
          float* v = Bt + TQ * BB;
          load_rows<PMAX>(At, TQ + 4, x + blk * Q * P, t0, nrow, P);
          load_rows<NMAX>(Bt, BB, gst + blk * P * N, 0, P, N);
          load_vec(v, cs_in + blk * Q + t0, nrow);
          load_vec(v + TQ, dt + blk * Q + t0, nrow);
          if (threadIdx.x == 0) cp_async4(v + 2 * TQ, cs_in + blk * Q + Q - 1, 4);
        }
      },
      [&](int k, int s) {
        const float* At = ring + s * BC_STAGE;
        const float* Bt = At + TQ * BA;
        if (k < n1) {
          if (GB)                       // gsum_it^T: rows j = t, k = i
            warp_mma<2, 4>(
                acc, TQ, N - n0,
                [&](int m, int kk) { return At[kk * AP + m0 + m]; },
                [&](int kk, int n) { return Bt[kk * BB + n0 + n]; });
          else
            warp_mma<2, 4>(
                acc, TQ, N - n0,
                [&](int m, int kk) { return At[(m0 + m) * AP + kk]; },
                [&](int kk, int n) { return Bt[kk * BB + n0 + n]; });
        } else {
          const float* v = Bt + TQ * BB;
          if (threadIdx.x < TQ)
            sc[threadIdx.x] = (int)threadIdx.x < nrow
                                  ? v[TQ + threadIdx.x] *
                                        expf(v[2 * TQ] - v[threadIdx.x])
                                  : 0.f;
          __syncthreads();
          warp_mma<2, 4>(
              acc, round8(P), N - n0,
              [&](int m, int kk) { return At[(m0 + m) * (TQ + 4) + kk] * sc[m0 + m]; },
              [&](int kk, int n) { return Bt[kk * BB + n0 + n]; });
        }
      });
  float* ob = out + gblk * Q * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m0 + acc_row(mt, r), n = n0 + acc_col(q, r);
        if (i < nrow && n < N) ob[(size_t)(t0 + i) * N + n] = acc[mt][q][r];
      }
}

}  // namespace

extern "C" {

// Inputs as the forward's, plus cs (B, H, nc, Q) from the forward and the
// output gradients gy (B, H, nc, Q, P), gst (B, H, nc, P, N),
// gcs (B, H, nc, Q); cb and gsum are the wrapper's two
// (B, G, nc, pairs, 64, 64) f32 scratch buffers.  Writes gx (B, H, nc, Q, P),
// gdt (B, H, nc, Q), gA_blk (B, H, nc) in f64, and gB, gC (B, G, nc, Q, N).
// The rest f32; all contiguous.  Returns the cudaError_t of the first
// failing launch.
int ssd_intra_bwd_launch(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* cs,
                         const void* gy, const void* gst, const void* gcs,
                         void* gx, void* gdt, void* gA_blk, void* gB, void* gC,
                         void* cb, void* gsum, int B, int H, int nc, int Q,
                         int P, int G, int N, void* stream) {
  if (B < 1 || H < 1 || nc < 1 || Q < 1 || Q > QMAX || P < 1 || P > PMAX ||
      N < 1 || N > NMAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = allow_smem(ssd_cb_kernel, CB_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_bwd_head_kernel, H_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_bwd_gsum_kernel, G_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_bwd_bc_kernel<false>, BC_SMEM)) != cudaSuccess ||
      (e = allow_smem(ssd_bwd_bc_kernel<true>, BC_SMEM)) != cudaSuccess)
    return (int)e;
  ssd_cb_kernel<<<dim3(n_pairs(Q), nc, B * G), THREADS, CB_SMEM, s>>>(
      f(Bm), f(Cm), m(cb), nc, Q, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_head_kernel<<<dim3(H, nc, B), THREADS, H_SMEM, s>>>(
      f(x), f(dt), f(A), f(Bm), f(cb), f(cs), f(gy), f(gst), f(gcs), m(gx),
      m(gdt), static_cast<double*>(gA_blk), H, nc, Q, P, G, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_gsum_kernel<<<dim3(n_pairs(Q), nc, B * G), THREADS, G_SMEM, s>>>(
      f(x), f(dt), f(cs), f(gy), m(gsum), H, nc, Q, P, G);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles(Q), nc, B * G);
  ssd_bwd_bc_kernel<false><<<grid, THREADS, BC_SMEM, s>>>(
      f(x), f(dt), f(Bm), f(cs), f(gst), f(gsum), m(gC), H, nc, Q, P, G, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_kernel<true><<<grid, THREADS, BC_SMEM, s>>>(
      f(x), f(dt), f(Cm), f(cs), f(gst), f(gsum), m(gB), H, nc, Q, P, G, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
