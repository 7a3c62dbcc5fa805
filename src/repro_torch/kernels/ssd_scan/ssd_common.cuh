// Shared by the SSD intra-chunk kernels (kernel.cu, bwd_kernel.cu): tile
// geometry, shared-memory pitches and the block-wide scan of the chunk's
// cumulative decay.
//
// Tiles: 256 threads see a 64 x 64 output tile as a 16 x 16 grid (tx, ty);
// a thread owns rows ty + 16 r and columns tx + 16 c.  Every operand tile in
// shared memory is row-major with an odd pitch (K + 1), so a reduction over
// either axis reads distinct banks across the half-warp's 16 columns and
// the two rows a warp holds.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;           // chunk rows per tile
constexpr int QMAX = 256;        // longest chunk (the published ssm_chunk)
constexpr int PMAX = 64;         // widest head (ssm_head_dim)
constexpr int NMAX = 128;        // largest state (ssm_state)
constexpr int NP = NMAX + 1;     // pitch of (rows, N) tiles
constexpr int PP = PMAX + 1;     // pitch of (rows, P) tiles
constexpr int TP = TQ + 1;       // pitch of (rows, rows) tiles

// Copy rows [row0, row0 + nrows) of a row-major (*, width) matrix into a
// shared tile of pitch ``pitch``, times ``scale[row]`` when given.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int pitch,
                                          const float* __restrict__ src,
                                          int row0, int nrows, int width,
                                          const float* scale = nullptr) {
  const int n = nrows * width;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int r = e / width, c = e - r * width;
    float v = src[(size_t)(row0 + r) * width + c];
    if (scale) v *= scale[row0 + r];
    dst[r * pitch + c] = v;
  }
}

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

// Sum of one value per thread over the 16 threads of a half-warp row (tx).
template <typename T>
__device__ __forceinline__ T row_sum16(T v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
