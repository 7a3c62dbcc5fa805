// Selection keys and helpers of the selection kernels: the exact top-k kernel
// (knn_topk/kernel.cu), the IVF scan (knn_ivf/kernel.cu), the fused IVF-PQ
// shortlist (knn_ivf/pq_kernel.cu) and the per-query selection they share
// (knn_ivf/select.cuh).
//
//   keys          64 bits: the high 32 bits are the score in an
//                 order-preserving unsigned form, the low 32 bits ~id, so a
//                 larger key is a higher score and, among equal scores, a
//                 lower row id.  Masked candidates (padding rows, lists a
//                 query does not probe, NaN or -inf scores) get key 0, below
//                 every valid key, so they never leak an id.  Keys are
//                 unique, so every threshold below selects an exact set,
//                 ties included.
//   cp.async      16- and 4-byte asynchronous copies into shared memory that
//                 zero-fill where the source is out of range.
//   warp_topk_threshold
//                 radix select on one warp over any set of keys the warp
//                 visits (8-bit digits from the top, a 256-bin histogram in
//                 the warp's shared memory, the digit found by a warp prefix
//                 scan).  It returns T such that exactly min(k, n) nonzero
//                 keys are >= T, stopping as soon as the digit's bin holds
//                 just the keys still needed.  Lanes that add to one bin
//                 together add once (`hist_add`).
//   warp_sort_desc, warp_sort_regs
//                 bitonic sorts of a power-of-two run of keys on one warp, in
//                 shared memory or (up to 128 keys) in registers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long u64;

// -------------------------------------------------------------- keys

__device__ __forceinline__ u64 make_key(float s, int id, bool ok) {
  if (!ok || !(s > -CUDART_INF_F)) return 0ull;   // also drops NaN
  unsigned int b = __float_as_uint(s);
  b ^= (b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u;
  return ((u64)b << 32) | (u64)(0xFFFFFFFFu - (unsigned int)id);
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned int b = (unsigned int)(key >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// ------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------- warp selection

// hist[bin] += 1 from each calling lane, one atomic per distinct bin among
// the lanes that call together (scores cluster in few bins of a digit, and
// 32 lanes adding to one word one by one would serialise)
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin) {
  const unsigned peers = __match_any_sync(__activemask(), bin);
  if ((threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], (unsigned)__popc(peers));
}

// Threshold T of the top k among the nonzero keys a warp visits: exactly
// min(k, n) of them are >= T, and T >= 1.  ``visit(f)`` calls f(key) for
// each of this lane's keys (each key of the set on exactly one lane); it
// runs once per digit pass.  ``hist`` is 256 words of this warp's shared
// memory.  All 32 lanes call it.
template <class Visit>
__device__ u64 warp_topk_threshold(Visit visit, int k, unsigned* hist) {
  const int lane = threadIdx.x & 31;
  u64 prefix = 0ull, mask = 0ull;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) hist[lane + 32 * j] = 0u;
    __syncwarp();
    visit([&](u64 key) {
      if (key != 0ull && (key & mask) == prefix)
        hist_add(hist, (unsigned)(key >> shift) & 0xFFu);
    });
    __syncwarp();
    // lane l owns bins 255 - 8 l down to 248 - 8 l: a descending scan
    int c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = (int)hist[255 - 8 * lane - j];
      sum += c[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, incl >= need);
    __syncwarp();                       // hist is zeroed by the next pass
    if (ball == 0u) return 1ull;        // fewer than k keys: take them all
    const int src = __ffs(ball) - 1;
    int d = 0, cum = incl - sum, hit = 0;
    if (lane == src) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cum + c[j] >= need) {
          d = 255 - 8 * lane - j;
          hit = c[j];
          break;
        }
        cum += c[j];
      }
    }
    d = __shfl_sync(0xffffffffu, d, src);
    cum = __shfl_sync(0xffffffffu, cum, src);
    hit = __shfl_sync(0xffffffffu, hit, src);
    need -= cum;
    prefix |= (u64)d << shift;
    mask |= 0xFFull << shift;
    // every key of this bin is needed: the keys >= prefix (its low bits
    // zero) are exactly the top k
    if (hit == need) return prefix ? prefix : 1ull;
  }
  return prefix;
}

// Descending bitonic sort of a[0, width) in shared memory on one warp;
// width is a power of two.
__device__ void warp_sort_desc(u64* a, int width) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < width; i += 32) {
        const int j = i ^ stride;
        if (j > i) {
          const u64 x = a[i], y = a[j];
          const bool desc = (i & size) == 0;
          if (desc ? x < y : x > y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int E, int S>
__device__ __forceinline__ void cmpx_slots(u64 (&v)[E], int lane, int size) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int pj = j ^ S;
    if (pj > j && pj < E) {
      const u64 x = v[j], y = v[pj];
      const bool up = ((j * 32 + lane) & size) == 0;
      v[j] = up ? (x > y ? x : y) : (x < y ? x : y);
      v[pj] = up ? (x < y ? x : y) : (x > y ? x : y);
    }
  }
}

// Descending bitonic sort of a[0, 32 E) on one warp in registers (element
// j 32 + lane in the lane's slot j): strides below 32 by warp shuffles, the
// others between a lane's own slots.  E is 1, 2 or 4.
template <int E>
__device__ void warp_sort_regs(u64* a) {
  const int lane = threadIdx.x & 31;
  u64 v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = a[j * 32 + lane];
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      if (st >= 32) {
        if (st == 32) cmpx_slots<E, 1>(v, lane, size);
        else cmpx_slots<E, 2>(v, lane, size);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = j * 32 + lane;
          const u64 x = v[j];
          const u64 y = __shfl_xor_sync(0xffffffffu, x, st);
          const bool up = (e & size) == 0, lower = (e & st) == 0;
          v[j] = (up == lower) ? (x > y ? x : y) : (x < y ? x : y);
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < E; ++j) a[j * 32 + lane] = v[j];
  __syncwarp();
}

// Stable compaction by one warp of the keys for which ``keep`` holds,
// appended at dst[*w]; ``w`` is warp-uniform and advanced.
__device__ __forceinline__ void warp_append(u64 key, bool keep, u64* dst,
                                            int& w, int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  const int pos = w + __popc(ball & ((1u << lane) - 1u));
  if (keep && pos < cap) dst[pos] = key;
  w += __popc(ball);
}

}  // namespace
