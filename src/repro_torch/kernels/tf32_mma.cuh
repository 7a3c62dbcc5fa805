// The f32-accurate product on the tensor cores, shared by the SSD kernels
// (ssd_scan/ssd_common.cuh `warp_mma`) and the flash backward
// (flash_attention/bwd_kernel.cu): an f32 operand cut into a TF32 big part
// and a TF32-rounded remainder, and one m16n8k8 TF32 `mma.sync` with f32
// accumulation; three of them (big x small + small x big + big x big) keep
// about 2^-21 of each product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// big is a with its 13 low mantissa bits cleared (a TF32 value), and
// small the remainder a - big (exact in f32, |small| < 2^-10 |a|) rounded to
// TF32 to nearest (ties away from zero) in integer arithmetic, so
// a = big + small within 2^-21 |a|.  Rounding small, rather than letting
// the tensor cores drop its low bits, took the gradient's worst error at
// 32 heads a group from 0.125 to 0.076 of the check (`chip_smoke.py` on an
// H100).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
