// Warp-level tensor-core pieces shared by the bf16 forward (kernel.cu,
// `flash_fwd_kernel_tc`) and the backward (bwd_kernel.cu): `ldmatrix`
// loads of the padded tiles of TileRows, `mma.sync` m16n8k16 bf16 with f32
// accumulators, the hi + lo bf16 split of an f32 operand, and the masks'
// liveness tests.
//
// Fragment layouts (PTX ISA, m16n8k16): the C fragment of an m16n8 tile
// holds rows g, g + 8 and columns 2t, 2t + 1 (g = lane / 4, t = lane % 4);
// the C fragments of two neighbouring 8-column tiles are the A fragment of
// the k-step over those 16 columns, so P and dS feed the next product from
// the registers they were computed in.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "flash_common.cuh"

namespace {

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the low
// half (the smaller k of an A fragment register)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  memcpy(&hi, &h, 4);
  memcpy(&lo, &l, 4);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[n][r] = 0.f;
}

__device__ __forceinline__ bool live(int i, int j, int Sq, int Sk, int causal,
                                     int window) {
  return i < Sq && j < Sk && (!causal || j <= i) &&
         (window <= 0 || i - j < window);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace
