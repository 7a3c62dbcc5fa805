// Per-query top-k selection shared by the IVF scan (kernel.cu) and the
// IVF-PQ ADC shortlist (pq_kernel.cu): the counterpart of `merge_topk`
// (src/repro/kernels/knn_topk/kernel.py:23), which the TPU kernels run on a
// running top-k carried along a sequential grid axis.  Hopper blocks share
// nothing across a grid, so the scan kernels write one 64-bit key per
// candidate and this pass selects per query.
//
// Key: the high 32 bits are the score mapped to an unsigned integer with
// the same order, the low 32 bits are ~id, so a larger key is a higher
// score and, among equal scores, a lower row id.  Masked candidates (padding
// rows, lists the query does not probe, NaN or -inf scores) get key 0,
// below every valid key, so they never leak an id: slots no valid candidate
// fills come out as -inf / -1.
//
// Selection: one block per query finds the k-th largest key by radix
// select (8 passes of 8-bit digits with a shared-memory histogram), keeps
// the keys at or above it, and sorts them with a bitonic sort in shared
// memory.  k <= KMAX; the candidate count is unbounded (nprobe may equal
// the number of lists).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_KMAX = 1024;

__device__ __forceinline__ unsigned long long make_key(float s, int id,
                                                       bool ok) {
  if (!ok || !(s > -CUDART_INF_F)) return 0ull;   // also drops NaN
  unsigned int b = __float_as_uint(s);
  b ^= (b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u;
  return ((unsigned long long)b << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned int)id);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  unsigned int b = (unsigned int)(key >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// keys (Q, n) -> out_s / out_i (Q, k), sorted descending, -inf / -1 tail.
__global__ void __launch_bounds__(SEL_THREADS)
select_topk_kernel(const unsigned long long* __restrict__ keys, int n, int k,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long sel[SEL_KMAX];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_need;
  __shared__ int s_cnt;
  const int tid = threadIdx.x;
  const unsigned long long* row = keys + (size_t)blockIdx.x * n;

  // the k-th largest key; with n <= k every candidate is kept (thr = 0)
  unsigned long long thr = 0ull;
  if (n > k) {
    unsigned long long prefix = 0ull, mask = 0ull;
    int need = k;            // rank of the k-th key among those matching prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += SEL_THREADS) hist[b] = 0u;
      __syncthreads();
      for (int i = tid; i < n; i += SEL_THREADS) {
        const unsigned long long key = row[i];
        if ((key & mask) == prefix)
          atomicAdd(&hist[(unsigned int)(key >> shift) & 0xFFu], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, d = 255;
        for (; d > 0; --d) {
          if (cum + (int)hist[d] >= need) break;
          cum += (int)hist[d];
        }
        s_need = need - cum;
        s_prefix = prefix | ((unsigned long long)d << shift);
      }
      __syncthreads();
      need = s_need;
      prefix = s_prefix;
      mask |= 0xFFull << shift;
    }
    thr = prefix;
  }

  if (tid == 0) s_cnt = 0;
  __syncthreads();
  for (int i = tid; i < n; i += SEL_THREADS) {
    const unsigned long long key = row[i];
    if (key > thr || (key == thr && thr != 0ull)) {
      const int pos = atomicAdd(&s_cnt, 1);
      if (pos < k) sel[pos] = key;
    }
  }
  __syncthreads();
  const int cnt = min(s_cnt, k);
  int width = 1;
  while (width < k) width <<= 1;
  for (int i = cnt + tid; i < width; i += SEL_THREADS) sel[i] = 0ull;
  __syncthreads();
  // bitonic sort of sel[0, width), descending
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < width; i += SEL_THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = sel[i], b = sel[j];
          const bool desc = (i & size) == 0;
          if (desc ? a < b : a > b) {
            sel[i] = b;
            sel[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const size_t base = (size_t)blockIdx.x * k;
  for (int t = tid; t < k; t += SEL_THREADS) {
    const unsigned long long key = sel[t];
    out_s[base + t] = key ? key_score(key) : -CUDART_INF_F;
    out_i[base + t] = key ? key_id(key) : -1;
  }
}

}  // namespace
