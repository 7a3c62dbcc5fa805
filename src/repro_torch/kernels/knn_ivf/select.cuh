// Per-query top-k selection over 64-bit keys (`topk_common.cuh`), one block
// of SEL_THREADS threads a query: the counterpart of `merge_topk`
// (src/repro/kernels/knn_topk/kernel.py:23), which the TPU kernels run on a
// running top-k carried along a sequential grid axis.  Hopper blocks share
// nothing across a grid, so the scans write one key per candidate and a
// block selects per query.  The one selection algorithm of the port:
//
//   block_topk          the device function.  Radix select with 11-, 11- and
//                       10-bit digits over the score's 32 bits, then over the
//                       id's (a 2,048-bin histogram of plain shared atomics,
//                       one add a warp where all its lanes share a bin: on an
//                       H100 the `__match_any` aggregation of `hist_add` cost
//                       more than the atomics it saved; the digit found by a
//                       parallel prefix scan over the bins), stopping as soon
//                       as the digit's bin holds just the keys still needed;
//                       the survivors are gathered by ballot (one atomic a
//                       warp) and placed by rank (each thread counts the keys
//                       above its own: up to 256 survivors) or sorted by the
//                       block (`block_sort_write`: register stages, warp
//                       shuffles, shared memory for the widest strides).  It
//                       takes k <= SEL_BLOCK_KMAX and a key source: shared
//                       memory where the caller's keys fit there, else device
//                       memory read through L2 on every pass.  Its callers:
//                       the IVF scan's selector blocks (knn_ivf/kernel.cu),
//                       the fused IVF-PQ leader (pq_kernel.cu), and
//   select_topk_kernel  one block a query over keys (Q, n) in device memory,
//                       in rounds (`select_topk`): round r takes the top
//                       min(SEL_KMAX, k - SEL_KMAX r) keys strictly below the
//                       last key of round r - 1 (its ceiling, rebuilt from
//                       that round's last output slot) and writes the next
//                       column range of the same (Q, k) output.  Keys are
//                       unique, so the rounds are exact and keep the tie
//                       order; once a round's last slot is empty, every later
//                       round finds no key below the ceiling 0 and writes
//                       -inf / -1.  The candidate count is unbounded.  It
//                       serves the IVF scan above k = 2,048, kernel 5's three
//                       launches and exact top-k above k = 128 (over its
//                       candidate buffer, and over all keys for the queries
//                       whose buffer overflowed: `select_flagged`).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "../topk_common.cuh"

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_KMAX = 1024;         // keys a round of select_topk_kernel
constexpr int SEL_BLOCK_KMAX = 2048;   // k of one block_topk
constexpr int SEL_NB = 2048;           // bins of an 11-bit digit

// keys of block_topk's sort buffer for k: max(256, the next power of two)
__host__ __device__ constexpr int sel_width(int k) {
  int w = SEL_THREADS;
  while (w < k) w <<= 1;
  return w;
}

// shared-memory bytes block_topk takes from its caller: histogram and sort
// buffer
__host__ __device__ constexpr int sel_smem(int k) {
  return SEL_NB * 4 + sel_width(k) * 8;
}

template <int E, int S>
__device__ __forceinline__ void cmpx_regs(u64 (&v)[E], int base, int size) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int pj = j ^ S;
    if (pj > j && pj < E) {
      const u64 x = v[j], y = v[pj];
      const bool up = ((base + j) & size) == 0;
      v[j] = up ? (x > y ? x : y) : (x < y ? x : y);
      v[pj] = up ? (x < y ? x : y) : (x > y ? x : y);
    }
  }
}

// The block's descending bitonic sort of E SEL_THREADS keys in buf (element
// e = tid E + j held in v[j]), then the first min(k, E SEL_THREADS) written
// to out_s / out_i (-inf / -1 for key 0).  Strides below E swap registers,
// below 32 E go through warp shuffles, the rest through shared memory
// (stored j-major, so the reads hit distinct banks).
template <int E>
__device__ void block_sort_write(u64* buf, float* __restrict__ out_s,
                                 int* __restrict__ out_i, int k) {
  constexpr int T = SEL_THREADS;
  const int tid = threadIdx.x;
  const int base = tid * E;
  u64 v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = buf[base + j];
  for (int size = 2; size <= E * T; size <<= 1) {
    for (int st = size >> 1; st > 0; st >>= 1) {
      if (st < E) {
        if (st == 1) cmpx_regs<E, 1>(v, base, size);
        else if (st == 2) cmpx_regs<E, 2>(v, base, size);
        else cmpx_regs<E, 4>(v, base, size);
      } else if (st < 32 * E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = base + j;
          const u64 x = v[j];
          const u64 y = __shfl_xor_sync(0xffffffffu, x, st / E);
          const bool up = (e & size) == 0, lower = (e & st) == 0;
          v[j] = (up == lower) ? (x > y ? x : y) : (x < y ? x : y);
        }
      } else {
        __syncthreads();
#pragma unroll
        for (int j = 0; j < E; ++j) buf[j * T + tid] = v[j];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = base + j, f = e ^ st;
          const u64 x = v[j], y = buf[(f % E) * T + f / E];
          const bool up = (e & size) == 0, lower = (e & st) == 0;
          v[j] = (up == lower) ? (x > y ? x : y) : (x < y ? x : y);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = base + j;
    if (e < k) {
      out_s[e] = v[j] ? key_score(v[j]) : -CUDART_INF_F;
      out_i[e] = v[j] ? key_id(v[j]) : -1;
    }
  }
}

// hist[bin] += 1 from each calling lane: one add where all the lanes that
// call together share the bin (ties), else one add a lane
__device__ __forceinline__ void hist_inc(unsigned* hist, unsigned bin) {
  const unsigned act = __activemask();
  const int lead = __ffs(act) - 1;
  const unsigned lead_bin = __shfl_sync(act, bin, lead);
  if (__all_sync(act, bin == lead_bin)) {
    if ((int)(threadIdx.x & 31) == lead)
      atomicAdd(&hist[bin], (unsigned)__popc(act));
  } else {
    atomicAdd(&hist[bin], 1u);
  }
}

// The top k (1 <= k <= SEL_BLOCK_KMAX) of the nonzero keys below ``ceil``
// among get(0) .. get(n - 1), sorted descending into out_s / out_i [0, k),
// -inf / -1 in the slots no key fills.  ``hist`` (SEL_NB words) and ``sel``
// (sel_width(k) keys) are shared memory of the caller's; every thread of the
// block calls, and may reuse both once it returns.  A key that occurs more
// than once (a list probed twice by one query) is kept as often as it occurs.
template <class Get>
__device__ void block_topk(Get get, int n, int k, u64 ceil, unsigned* hist,
                           u64* sel, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
  constexpr int T = SEL_THREADS, PER = SEL_NB / T, UNROLL = 8;
  __shared__ int red[T / 32];
  __shared__ int s_d, s_cum, s_hit, s_found, s_cnt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64 prefix = 0ull, mask = 0ull, thr = 1ull;
  int need = k, shift = 64, copies = 0;
  for (int pass = 0; pass < 6; ++pass) {
    const int wd = pass % 3 == 2 ? 10 : 11;
    shift -= wd;
    const unsigned dmask = (1u << wd) - 1u;
    for (int b = tid; b < SEL_NB; b += T) hist[b] = 0u;
    __syncthreads();
    // UNROLL keys a thread in flight (device memory: L2 round trips)
    for (int i0 = tid; i0 < n; i0 += UNROLL * T) {
      u64 key[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * T;
        key[u] = i < n ? get(i) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (key[u] != 0ull && key[u] < ceil && (key[u] & mask) == prefix)
          hist_inc(hist, (unsigned)(key[u] >> shift) & dmask);
    }
    __syncthreads();
    // thread t owns bins NB-1-PER t down to NB-PER (t+1): a descending scan
    const unsigned* h = hist + SEL_NB - 1 - PER * tid;
    int sum = 0;
#pragma unroll 8
    for (int i = 0; i < PER; ++i) sum += (int)h[-i];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) red[warp] = incl;
    if (tid == 0) s_found = 0;
    __syncthreads();
    int base = 0;
    for (int w = 0; w < warp; ++w) base += red[w];
    incl += base;
    const int excl = incl - sum;
    if (excl < need && incl >= need) {
      int cum = excl;
      for (int i = 0; i < PER; ++i) {
        const int c = (int)h[-i];
        if (cum + c >= need) {
          s_d = SEL_NB - 1 - PER * tid - i;
          s_cum = cum;
          s_hit = c;
          s_found = 1;
          break;
        }
        cum += c;
      }
    }
    __syncthreads();
    const bool found = s_found;
    const int d = s_d, cum = s_cum, hit = s_hit;
    __syncthreads();                     // s_* are written again next pass
    if (!found) break;                    // fewer than k keys: take all
    need -= cum;
    prefix |= (u64)d << shift;
    mask |= (u64)dmask << shift;
    thr = prefix ? prefix : 1ull;
    if (hit == need) break;               // the bin holds just what is needed
    if (shift == 0) {                     // copies of one key fill the rest
      thr = prefix + 1ull;
      copies = need;
    }
  }

  // the survivors, exactly min(k, keys below the ceiling) in any order: a
  // warp counts its own, takes its range with one atomic, then fills it
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  auto keep = [&](u64 key) { return key != 0ull && key >= thr && key < ceil; };
  int mine = 0;
  for (int e0 = 0; e0 < n; e0 += UNROLL * T) {
    bool kp[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * T + tid;
      kp[u] = e < n && keep(get(e));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      mine += __popc(__ballot_sync(0xffffffffu, kp[u]));
  }
  int at = 0;
  if (lane == 0 && mine) at = atomicAdd(&s_cnt, mine);
  at = __shfl_sync(0xffffffffu, at, 0);
  for (int e0 = 0; mine && e0 < n; e0 += UNROLL * T) {
    u64 key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * T + tid;
      key[u] = e < n ? get(e) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool kp = keep(key[u]);
      const unsigned ball = __ballot_sync(0xffffffffu, kp);
      const int pos = at + __popc(ball & ((1u << lane) - 1u));
      if (kp && pos < k) sel[pos] = key[u];
      at += __popc(ball);
    }
  }
  __syncthreads();
  int cnt = min(s_cnt, k);
  for (int e = cnt + tid; e < min(cnt + copies, k); e += T) sel[e] = prefix;
  cnt = min(cnt + copies, k);
  __syncthreads();
  if (cnt <= T) {
    // each survivor's place is the count of survivors above it (copies of
    // one key in their gathered order)
    if (tid < cnt) {
      const u64 key = sel[tid];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) {
        const u64 o = sel[j];
        rank += o > key || (o == key && j < tid);
      }
      out_s[rank] = key_score(key);
      out_i[rank] = key_id(key);
    }
    for (int e = cnt + tid; e < k; e += T) {
      out_s[e] = -CUDART_INF_F;
      out_i[e] = -1;
    }
  } else {
    int w = T;
    while (w < cnt) w <<= 1;
    for (int e = cnt + tid; e < w; e += T) sel[e] = 0ull;
    __syncthreads();
    switch (w / T) {
      case 2: block_sort_write<2>(sel, out_s, out_i, k); break;
      case 4: block_sort_write<4>(sel, out_s, out_i, k); break;
      default: block_sort_write<8>(sel, out_s, out_i, k); break;
    }
    for (int e = w + tid; e < k; e += T) {
      out_s[e] = -CUDART_INF_F;
      out_i[e] = -1;
    }
  }
  __syncthreads();
}

// One round: keys (Q, n) -> columns [col0, col0 + k) of out_s / out_i
// (Q, ld), the top k keys strictly below the ceiling (all keys in round 0;
// afterwards the key of column col0 - 1), sorted descending, -inf / -1 in
// slots no key fills.  k <= SEL_KMAX.  With ``flag``, only the queries
// whose flag is set select; the others leave at once.
__global__ void __launch_bounds__(SEL_THREADS)
select_topk_kernel(const u64* __restrict__ keys, const int* __restrict__ flag,
                   int n, int k, int col0, int ld, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  if (flag != nullptr && !flag[blockIdx.x]) return;
  __shared__ unsigned hist[SEL_NB];
  __shared__ u64 sel[SEL_KMAX];         // sel_width(SEL_KMAX)
  const u64* row = keys + (size_t)blockIdx.x * n;
  const size_t base = (size_t)blockIdx.x * ld + col0;
  // no key reaches ~0 (its score bits would be a NaN, which maps to key 0)
  u64 ceil = ~0ull;
  if (col0 > 0) {
    const int id = out_i[base - 1];
    ceil = id < 0 ? 0ull : make_key(out_s[base - 1], id, true);
  }
  block_topk([&](int i) { return __ldcg(row + i); }, n, k, ceil, hist, sel,
             out_s + base, out_i + base);
}

inline cudaError_t select_rounds(const u64* keys, const int* flag, int Q,
                                 int n, int k, float* out_s, int* out_i,
                                 cudaStream_t st) {
  for (int col0 = 0; col0 < k; col0 += SEL_KMAX) {
    const int kr = k - col0 < SEL_KMAX ? k - col0 : SEL_KMAX;
    select_topk_kernel<<<Q, SEL_THREADS, 0, st>>>(keys, flag, n, kr, col0, k,
                                                  out_s, out_i);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// keys (Q, n) -> out_s / out_i (Q, k) for any k >= 1: ceil(k / SEL_KMAX)
// rounds of `select_topk_kernel` on one stream, each reading the previous
// round's last column as its ceiling.
inline cudaError_t select_topk(const u64* keys, int Q, int n, int k,
                               float* out_s, int* out_i, cudaStream_t st) {
  return select_rounds(keys, nullptr, Q, n, k, out_s, out_i, st);
}

// The same for the queries with flag[q] != 0 only (exact top-k's queries
// whose candidate buffer overflowed select over all their keys).
inline cudaError_t select_flagged(const u64* keys, const int* flag, int Q,
                                  int n, int k, float* out_s, int* out_i,
                                  cudaStream_t st) {
  return select_rounds(keys, flag, Q, n, k, out_s, out_i, st);
}

}  // namespace
