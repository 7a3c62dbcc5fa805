// Pieces shared by the forward attention kernel (kernel.cu) and its
// backward (bwd_kernel.cu): tile sizes, the shared-memory row layout of a
// 64-row tile of a (B, S, heads, HD) tensor, its asynchronous load, the
// half-warp reductions of a score row and 4-wide stores.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "../attention_common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // a 16 x 16 grid of threads
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// one 64-row tile in shared memory: rows of HD elements in the stored
// dtype, padded by 16 bytes so rows 16 bytes apart fall in other banks
// (HD 64, 80, 112, 128: LD / 16 is odd)
template <typename T, int HD>
struct TileRows {
  static constexpr int ROW = HD * (int)sizeof(T);    // one row, bytes
  static constexpr int LD = ROW + 16;                // padded row stride
  static constexpr int CH = ROW / 16;                // 16-byte chunks a row
  static constexpr int VE = 16 / (int)sizeof(T);     // elements a chunk
  static constexpr int C4 = HD / 4;                  // 4-column chunks
  static constexpr int NC = (C4 + 15) / 16;          // of them per thread
  static constexpr int TILE = 64 * LD;               // one tile, bytes
};

// rows [r0, r0 + 64) of a (B, S, heads, HD) tensor into shared memory at
// dst (row stride LD) by the block's THREADS threads; rows at or past S are
// zero
template <typename T, int HD, int THREADS = NT>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          int b, int r0, int S, int heads,
                                          int head, int tid) {
  using L = TileRows<T, HD>;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
  for (int e = tid; e < 64 * L::CH; e += THREADS) {
    const int r = e / L::CH, c = e - r * L::CH;
    unsigned char* d = dst + r * L::LD + c * 16;
    if (r0 + r < S) {
      const size_t off =
          ((((size_t)b * S + r0 + r) * heads + head) * HD) * sizeof(T) + c * 16;
      cp_async16(d, base + off);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int N>
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int N>
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

}  // namespace
