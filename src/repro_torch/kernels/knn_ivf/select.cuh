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
// memory.  One pass keeps at most SEL_KMAX keys in shared memory, so a
// larger k runs in rounds (`select_topk`): round r takes the top
// min(SEL_KMAX, k - SEL_KMAX r) keys strictly below the last key of round
// r - 1 (its ceiling, rebuilt from that round's last output slot) and
// writes the next column range of the same (Q, k) output.  Keys are unique
// (~id in the low bits), so the rounds are exact and keep the tie order;
// once a round's last slot is empty, every later round finds no key below
// the ceiling 0 and writes -inf / -1.  The candidate count is unbounded
// (nprobe may equal the number of lists).
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

// One round: keys (Q, n) -> columns [col0, col0 + k) of out_s / out_i
// (Q, ld), the top k keys strictly below the ceiling (all keys in round 0;
// afterwards the key of column col0 - 1), sorted descending, -inf / -1 in
// slots no key fills.  k <= SEL_KMAX.
__global__ void __launch_bounds__(SEL_THREADS)
select_topk_kernel(const unsigned long long* __restrict__ keys, int n, int k,
                   int col0, int ld, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long sel[SEL_KMAX];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_need;
  __shared__ int s_cnt;
  const int tid = threadIdx.x;
  const unsigned long long* row = keys + (size_t)blockIdx.x * n;
  const size_t base = (size_t)blockIdx.x * ld;
  // no key reaches ~0 (its score bits would be a NaN, which maps to key 0)
  unsigned long long ceil = ~0ull;
  if (col0 > 0) {
    const int id = out_i[base + col0 - 1];
    ceil = id < 0 ? 0ull : make_key(out_s[base + col0 - 1], id, true);
  }

  // the k-th largest key below the ceiling; with n <= k every candidate
  // below it is kept (thr = 0)
  unsigned long long thr = 0ull;
  if (n > k) {
    unsigned long long prefix = 0ull, mask = 0ull;
    int need = k;            // rank of the k-th key among those matching prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += SEL_THREADS) hist[b] = 0u;
      __syncthreads();
      for (int i = tid; i < n; i += SEL_THREADS) {
        const unsigned long long key = row[i];
        if ((key & mask) == prefix && key < ceil)
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
    if (key < ceil && (key > thr || (key == thr && thr != 0ull))) {
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
  for (int t = tid; t < k; t += SEL_THREADS) {
    const unsigned long long key = sel[t];
    out_s[base + col0 + t] = key ? key_score(key) : -CUDART_INF_F;
    out_i[base + col0 + t] = key ? key_id(key) : -1;
  }
}

// keys (Q, n) -> out_s / out_i (Q, k) for any k >= 1: ceil(k / SEL_KMAX)
// rounds of `select_topk_kernel` on one stream, each reading the previous
// round's last column as its ceiling.
inline cudaError_t select_topk(const unsigned long long* keys, int Q, int n,
                               int k, float* out_s, int* out_i,
                               cudaStream_t st) {
  for (int col0 = 0; col0 < k; col0 += SEL_KMAX) {
    const int kr = k - col0 < SEL_KMAX ? k - col0 : SEL_KMAX;
    select_topk_kernel<<<Q, SEL_THREADS, 0, st>>>(keys, n, kr, col0, k,
                                                  out_s, out_i);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
