// Shared by the SSD intra-chunk kernels (kernel.cu, bwd_kernel.cu): tile
// geometry, asynchronous tile loads, the f32-accurate tensor-core product,
// the C B^T pass that both directions run once per group, and the
// block-wide scan of the chunk's cumulative decay.
//
// Tiles.  A chunk of Q <= 256 rows is cut into 64-row tiles; the causal
// (i >= j) tile pairs of a chunk are numbered p = i (i + 1) / 2 + j, and
// the per-group scratch of C B^T (and of the gradient's sum over heads)
// holds one contiguous 64 x 64 tile per pair.  Every other operand is
// copied into shared memory with 16-byte `cp.async` (4-byte where a row is
// not a multiple of 4 floats), zero-filled past the matrix's rows and up
// to the next multiple of 8 columns, through a ring of two stages
// (`pipeline`), so the next tiles arrive while the current ones are
// multiplied.
//
// Products.  `warp_mma` runs D += A B on `mma.sync.m16n8k8` TF32 with f32
// accumulation in three passes: a = big + small with big = a cut to TF32
// and small the remainder rounded to TF32 (`split_tf32`), then each k-step
// of 8 forms big small' + small big' + big big' in a fresh f32 sum that is
// added to D with a rounded f32 add.  The dropped small small' term and
// the rounding of small leave about 2^-21 of each product, close to an f32
// FMA; one TF32 pass would keep ~3 digits and miss the 3e-4 check.  The fresh sum per
// k-step matters too: the tensor cores truncate the sums they form, and
// 32 heads x 24 mma into one accumulator of gB put the gradient at 2.4x
// the check (`chip_smoke.py` on an H100); a rounded add per k-step leaves
// only the truncation inside one step.  The fragments are read by hand through accessors,
// so any shared layout (transposed, scaled per row) can feed either
// operand.  Shared pitches are chosen per access pattern: an operand whose
// fragment walks its rows with the lane's group id (g = lane / 4) and its
// columns with t = lane % 4 has a pitch of 4 mod 32 floats, one that walks
// the other way 8 mod 32; both read 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int TQ = 64;           // chunk rows per tile
constexpr int QMAX = 256;        // longest chunk (the published ssm_chunk)
constexpr int PMAX = 64;         // widest head (ssm_head_dim)
constexpr int NMAX = 128;        // largest state (ssm_state)
constexpr int TILE = TQ * TQ;    // floats of one scratch tile

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ __forceinline__ int n_tiles(int Q) { return (Q + TQ - 1) / TQ; }
__host__ __device__ __forceinline__ int n_pairs(int Q) {
  const int nt = n_tiles(Q);
  return nt * (nt + 1) / 2;
}
__device__ __forceinline__ int pair_row(int p) {  // i of pair p
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  return i;
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + nrows) and columns [0, ncols) of a
// row-major matrix with row stride ``ld`` into rows 0..63 of a shared tile of
// pitch ``pitch``, columns [0, round8(ncols)); rows past nrows and columns
// past ncols become 0.  CW (a power of two >= ncols) fixes the walk, so no
// division per element.
template <int CW>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, int ld, int row0,
                                          int nrows, int ncols) {
  const int kw = round8(ncols);
  const float* base = src + (size_t)row0 * ld;
  if ((ld & 3) == 0 && (ncols & 3) == 0 && (pitch & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    constexpr int V = CW / 4;
    for (int e = threadIdx.x; e < TQ * V; e += THREADS) {
      const int r = e / V, c = 4 * (e % V);
      if (c >= kw) continue;
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * pitch + c, ok ? base + r * ld + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < TQ * CW; e += THREADS) {
      const int r = e / CW, c = e % CW;
      if (c >= kw) continue;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * pitch + c, ok ? base + r * ld + c : src,
                ok ? 4 : 0);
    }
  }
}

// A whole (*, width) matrix's rows: load_tile with ld = ncols = width.
template <int CW>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, int row0,
                                          int nrows, int width) {
  load_tile<CW>(dst, pitch, src, width, row0, nrows, width);
}

// Start copying n <= 64 floats src[0..n) into dst[0..64), zero past n.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  const int e = threadIdx.x;
  if (e < TQ) cp_async4(dst + e, e < n ? src + e : src, e < n ? 4 : 0);
}

// Two-stage ring over ``n`` items: issue(k, stage) starts item k's copies
// (the copies a caller started before the call join item 0's group);
// compute(k, stage) runs once item k has arrived, between barriers.
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int n, Issue issue, Compute compute) {
  if (n > 0) issue(0, 0);
  cp_async_commit();
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) issue(k + 1, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- products

// One warp: acc[MT][NT] (16 MT x 8 NT outputs) += A B over k < kmax (a
// multiple of 8, at most 64: every product here runs over one tile, so the
// loop unrolls), with a(m, k) and b(k, n) reading the warp's operands
// (m < 16 MT, n < 8 NT).  n-tiles at or past ``ncols`` are skipped.
// Accumulator element r of tile (mt, nt) is row mt 16 + g + 8 (r / 2),
// column nt 8 + 2 t + r % 2 (`acc_row`, `acc_col`).
template <int MT, int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], int kmax,
                                         int ncols, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < TQ; k0 += 8) {
    if (k0 >= kmax) break;
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 16 + g;
      split_tf32(a(m, k0 + t), ab[mt][0], as[mt][0]);
      split_tf32(a(m + 8, k0 + t), ab[mt][1], as[mt][1]);
      split_tf32(a(m, k0 + t + 4), ab[mt][2], as[mt][2]);
      split_tf32(a(m + 8, k0 + t + 4), ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 >= ncols) break;
      uint32_t bb[2], bs[2];
      split_tf32(b(k0 + t, nt * 8 + g), bb[0], bs[0]);
      split_tf32(b(k0 + t + 4, nt * 8 + g), bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // a fresh sum for each k-step, added with a rounded f32 add: the
        // tensor cores truncate their sums, and a long run of mma into
        // one large accumulator piles that bias up
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, ab[mt], bs);
        mma_tf32(d, as[mt], bb);
        mma_tf32(d, ab[mt], bb);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] += d[r];
      }
    }
  }
}

__device__ __forceinline__ int acc_row(int mt, int r) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * (r >> 1);
}
__device__ __forceinline__ int acc_col(int nt, int r) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (r & 1);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
}

// ---------------------------------------------------------------- C B^T

constexpr int CBP = NMAX + 1;    // odd pitch of the FMA pass's C and B tiles
constexpr int CB_SMEM = 2 * TQ * CBP * (int)sizeof(float);

// CB[b, g, c, pair (i, j)] = C_i B_j^T, one 64 x 64 tile per block, in f32
// on the FMA units: a 4 x 4 register micro-tile a thread (rows ty + 16 r,
// columns tx + 16 q), both tiles at an odd pitch so the half-warp's 16
// columns read distinct banks.  Rows past Q are zero-filled and give 0.
// Grid (pairs, nc, B G).  The forward and the gradient each run it once
// per (b, g, c); the heads of the group then read the tile from L2.
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int nc, int Q, int N) {
  extern __shared__ float smem_cb[];
  float* Ci = smem_cb;
  float* Bj = Ci + TQ * CBP;
  const int p = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int it = pair_row(p), jt = p - it * (it + 1) / 2;
  const size_t gblk = (size_t)bg * nc + c;
  const float* Cb = Cm + gblk * Q * N;
  const float* Bb = Bm + gblk * Q * N;
  load_rows<NMAX>(Ci, CBP, Cb, it * TQ, min(TQ, Q - it * TQ), N);
  load_rows<NMAX>(Bj, CBP, Bb, jt * TQ, min(TQ, Q - jt * TQ), N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = Ci[(ty + 16 * r) * CBP + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Bj[(tx + 16 * q) * CBP + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
  }
  float* out = cb + (gblk * n_pairs(Q) + p) * TILE;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[(ty + 16 * r) * TQ + tx + 16 * q] = s[r][q];
}

// ---------------------------------------------------------------- scans

// Inclusive prefix sum of one value per thread over the block (256 values);
// ``red`` holds 8 values of shared scratch.  All threads must call it.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  __syncthreads();               // red may still be read by a caller
  if (lane == 31) red[warp] = v;
  __syncthreads();
  T base = 0;
  for (int k = 0; k < warp; ++k) base += red[k];
  return v + base;
}

// Dynamic shared memory above 48 KB is opted into per device, so it is set
// on every launch (a host call of a few microseconds), not once a process.
template <class K>
__host__ inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
