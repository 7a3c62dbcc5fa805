// Exact cosine top-k retrieval for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_topk/kernel.py:79
// `knn_topk_pallas` (`_knn_kernel` :54, `merge_topk` :23):
//   score(q, n) = q . s_n * rsqrt(|s_n|^2 + 1e-12), top-k over n,
//   scores f32 descending, ids int32 (ties to the lower row id, as
//   `lax.top_k`), -inf / -1 in slots no row fills, NaN rows masked.
//
// What bounds it on an H100: the support set is read once per call
// (N x D x 4 bytes, 215 MB at N = 70,000, D = 768 in f32: 64 us at
// 3.35 TB/s), while the dot products cost 2 Q N D flops on the f32 FMA
// units (26 us at Q = 16 at 67 TFLOP/s).  So a serving batch of a few
// queries is bound by bytes: the design keeps copies in flight on every SM
// for the whole scan and issues one launch.
//
// Design (k <= 128, one launch).
//   grid    sized to the card: blocks_per_SM x SMs (from the occupancy
//           calculator and the device, at launch), split into query tiles of
//           16 (the fastest index, so the tiles of one row range run side by
//           side and read it from HBM once) and row ranges: each block walks
//           a contiguous range of whole 64-row tiles.
//   scan    the support streams through a ring of shared-memory stages of
//           256 bytes of each of 64 rows (and the stage's f32 query slices),
//           filled by 16-byte `cp.async` (4-byte where D x element size is
//           not a multiple of 16) that zero-fills past N and D; the next
//           stages are in flight while the FMAs run on the current one.
//           3 stages for k <= 128, so two blocks fit an SM and one computes
//           while the other waits; 4-5 beside the k > 128 path's
//           histograms.  On an H100, 256-byte row pieces stream at 2.6 TB/s
//           and more where 64-byte pieces reach 1.8 (development probes on
//           the card, PERF.md section 6, PR 16); one copying warp
//           feeding eight computing warps through mbarriers, one block an
//           SM, was slower than this.  Each warp takes 32 bytes of
//           every row of a stage; a lane keeps 4 rows x 8 queries of partial
//           sums (and its rows' partial squared norms), so every 16-byte
//           shared read feeds 16 or 32 FMAs.  At the end of a tile the eight
//           warps' partial sums are added through shared memory in a fixed
//           order (warps 0-3 written, 4-7 added, the four sums added in
//           order).  bf16 rows are read 16 bytes (8 values) at a time, and
//           their query slices go through registers one stage ahead, rounded
//           through the support dtype.
//   select  each block keeps a running top-k per query in shared memory (one
//           warp per query), with the list's smallest key as threshold, so a
//           row costs one compare once the list is full; a tile whose rows
//           beat it is merged by a register sort on the warp where list and
//           candidates are at most 128 keys, else by a warp radix select
//           (`topk_common.cuh`).
//   merge   each block writes its sorted per-query lists, fences, and takes
//           a ticket on its query tile's counter; the block that takes the
//           last ticket merges all lists: the k-th largest of the lists'
//           first ceil(k / lists) entries (copied into shared memory) bounds
//           the result from below, so only the lists' prefixes above it are
//           read, copied into shared memory where they fit (read again from
//           L2 where they do not: ties), and a radix select over them gives
//           the top k.  It resets the counter for the next call.  The merge
//           is a function of all lists, so which block finishes last does
//           not matter.
//
// k > 128: the same scan writes one 64-bit key per (query, row) and adds
// each key's top 10 bits to a per-query histogram (counted in shared memory,
// then added into a (Q, 1024) histogram in device memory).  The card finds
// the threshold bin per query from that histogram.  Where that bin leaves
// more keys than the candidate buffer holds (scores crowding a few
// exponents, as the cosines of similar texts do), a refine kernel counts
// the next 11 bits of the keys in the bin, and where that digit still
// leaves too many, a second one the 11 after (as AIR top-k iterates its
// digits): the threshold then spans the score's 32 bits.  A compaction
// kernel copies the keys at or above the threshold into a per-query
// candidate buffer of bounded size; `select_topk` (select.cuh) selects over
// that buffer.  A query whose candidates still overflow the buffer (keys of
// equal score, such as an all-equal support) selects over all its keys
// instead, in the same call (`select_flagged`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "../knn_ivf/select.cuh"
#include "../topk_common.cuh"

namespace {

// CUDA kernels this library has launched (`knn_topk_device_launches`)
unsigned long long g_launches = 0;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 16;          // queries per block
constexpr int TN = 64;          // support rows per tile
constexpr int RPT = 4;          // rows per lane: rg, rg + 16, ...
constexpr int QPT = 8;          // queries per lane: 8 qh .. 8 qh + 7
constexpr int RG = 16;          // row groups of a warp (lanes 0-15, 16-31)
constexpr int ROW_BYTES = 256;  // bytes of each row per ring stage
constexpr int WARP_BYTES = ROW_BYTES / WARPS;   // a warp's bytes of a row
constexpr int PITCH = ROW_BYTES + 16;  // the 16-byte reads of 8 neighbouring
                                       // rows hit 32 different banks
constexpr int KMAX = 128;
constexpr int HBITS = 10;       // histogram digit of the k > 128 path
constexpr int NBINS = 1 << HBITS;
constexpr int RBITS = 11;       // its refine digits, 11 bits each
constexpr int RBINS = 1 << RBITS;
constexpr int REFINE_LEVELS = 2;  // 10 + 2 x 11 bits: the whole score
constexpr int COMPACT_PER_THREAD = 16;
constexpr int NRB_MAX = 512;    // row ranges of a query tile (merge heads)
constexpr int RED_PITCH = BQ + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round a query value through the support dtype, as the reference does
__device__ __forceinline__ float as_t(float x, float) { return x; }
__device__ __forceinline__ float as_t(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, bool KEYS>
struct Ring {
  // k <= 128: 3 stages, so two blocks fit an SM (one computes while the
  // other waits at its barrier); k > 128: as many as fit beside the
  // 1,024-bin histograms (one block an SM)
  static constexpr int STAGES = KEYS ? (sizeof(T) == 4 ? 5 : 4) : 3;
  static constexpr int TD = ROW_BYTES / (int)sizeof(T);      // values a stage
  static constexpr int QPER = BQ * TD / THREADS;             // query values
  static constexpr int Q_BYTES = BQ * TD * 4;
  static constexpr int STAGE = TN * PITCH + Q_BYTES;
  static constexpr int BYTES = STAGES * STAGE;
  // the warps' partial sums of a tile, added in two rounds of 4 warps:
  // (4, TN, BQ + 1) and norms (4, TN)
  static constexpr int RED = 4 * TN * RED_PITCH * 4 + 4 * TN * 4;
};

// Dynamic shared memory of the kernel: the ring (which the merging block
// reuses), the reduction buffer, then (k <= 128) the score tile, the lists,
// their counts and thresholds, the warps' histograms, or (k > 128) the
// per-query histogram.
template <typename T, bool KEYS>
__host__ __device__ inline int smem_bytes(int kw) {
  using R = Ring<T, KEYS>;
  if (KEYS) return R::BYTES + R::RED + BQ * NBINS * 4;
  return R::BYTES + R::RED + BQ * TN * 4 + BQ * kw * 8 + BQ * 8 + BQ * 4 +
         WARPS * 256 * 4;
}

__host__ __device__ inline int pow2_at_least(int k) {
  int w = 1;
  while (w < k) w <<= 1;
  return w;
}

// VEC: bytes per cp.async (16, or 4 where D x sizeof(T) is not a multiple
// of 16).  keys / ghist: the k > 128 path; part / ticket: the k <= 128 path.
template <typename T, bool KEYS, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
knn_scan_kernel(const float* __restrict__ q, const T* __restrict__ s,
                int Q, int N, int D, int k, int nrb,
                u64* __restrict__ part, int* __restrict__ ticket,
                float* __restrict__ out_s, int* __restrict__ out_i,
                u64* __restrict__ keys, unsigned* __restrict__ ghist) {
  using R = Ring<T, KEYS>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nqt = gridDim.x / nrb;
  const int qt = blockIdx.x % nqt, rb = blockIdx.x / nqt;
  const int q0 = qt * BQ;
  const int ntiles = (N + TN - 1) / TN;
  const int t_begin = (int)((long long)ntiles * rb / nrb);
  const int t_end = (int)((long long)ntiles * (rb + 1) / nrb);
  const long long row_bytes = (long long)D * sizeof(T);
  const int steps = (int)((row_bytes + ROW_BYTES - 1) / ROW_BYTES);
  const int total = (t_end - t_begin) * steps;

  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem + R::BYTES);    // partial sums
  float* nred = red + 4 * TN * RED_PITCH;                    // partial norms
  unsigned char* rest = smem + R::BYTES + R::RED;
  const int kw = pow2_at_least(k);
  float* sc = reinterpret_cast<float*>(rest);                // [BQ][TN]
  u64* lists = reinterpret_cast<u64*>(rest + BQ * TN * 4);   // [BQ][kw]
  u64* lmin = lists + BQ * kw;                               // [BQ]
  int* lcnt = reinterpret_cast<int*>(lmin + BQ);             // [BQ]
  unsigned* whist = reinterpret_cast<unsigned*>(lcnt + BQ) + warp * 256;
  unsigned* hist = reinterpret_cast<unsigned*>(rest);        // KEYS: [BQ][NBINS]

  if (KEYS) {
    for (int e = tid; e < BQ * NBINS; e += THREADS) hist[e] = 0u;
  } else if (tid < BQ) {
    lcnt[tid] = 0;
    lmin[tid] = 0ull;
  }

  // the query slices: by cp.async with the stage where they are f32 rows of
  // whole 16-byte pieces, else through registers one stage ahead (rounded
  // through the support dtype)
  constexpr bool Q_ASYNC = sizeof(T) == 4 && VEC == 16;
  auto issue = [&](int g) {
    if (g < total) {
      const int tile = t_begin + g / steps;
      const long long c0 = (long long)(g % steps) * ROW_BYTES;
      unsigned char* st = ring + (g % STAGES) * R::STAGE;
      constexpr int CPR = ROW_BYTES / VEC;                   // copies a row
      for (int e = tid; e < TN * CPR; e += THREADS) {
        const int r = e / CPR, c = e % CPR;
        const int row = tile * TN + r;
        const long long byte = c0 + (long long)c * VEC;
        const bool ok = row < N && byte < row_bytes;
        const unsigned char* src =
            ok ? reinterpret_cast<const unsigned char*>(s) +
                     (long long)row * row_bytes + byte
               : reinterpret_cast<const unsigned char*>(s);
        if (VEC == 16)
          cp_async16_zfill(st + r * PITCH + c * VEC, src, ok);
        else
          cp_async4_zfill(st + r * PITCH + c * VEC, src, ok);
      }
      if (Q_ASYNC) {
        // f32 query slices copy as they are: 16 bytes a thread
        constexpr int QC = R::TD / 4;                        // copies a query
        const int d0 = (g % steps) * R::TD;
        for (int e = tid; e < BQ * QC; e += THREADS) {
          const int qi = e / QC, d = d0 + 4 * (e % QC), qq = q0 + qi;
          const bool ok = qq < Q && d < D;
          cp_async16_zfill(st + TN * PITCH + e * 16,
                           ok ? q + (long long)qq * D + d : q, ok);
        }
      }
    }
    cp_async_commit();
  };
  auto load_q = [&](int g, float (&v)[R::QPER]) {
    if (Q_ASYNC) return;
    const int d0 = (g % steps) * R::TD;
#pragma unroll
    for (int i = 0; i < R::QPER; ++i) {
      const int e = tid + i * THREADS, qi = e / R::TD, d = d0 + e % R::TD;
      const int qq = q0 + qi;
      v[i] = (g < total && qq < Q && d < D)
                 ? as_t(q[(long long)qq * D + d], T())
                 : 0.f;
    }
  };
  auto store_q = [&](int g, const float (&v)[R::QPER]) {
    if (Q_ASYNC) return;
    float* qs = reinterpret_cast<float*>(ring + (g % STAGES) * R::STAGE +
                                         TN * PITCH);
#pragma unroll
    for (int i = 0; i < R::QPER; ++i) qs[tid + i * THREADS] = v[i];
  };

  float qv[R::QPER];
  for (int g = 0; g < STAGES - 1; ++g) {
    issue(g);
    load_q(g, qv);
    store_q(g, qv);
  }
  load_q(STAGES - 1, qv);

  const int rg = lane % RG, qh = lane / RG;
  float acc[RPT][QPT], nrm[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    nrm[j] = 0.f;
#pragma unroll
    for (int i = 0; i < QPT; ++i) acc[j][i] = 0.f;
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot of step g + STAGES - 1 was read in step g - 1, which every
    // thread has finished at the barrier above
    issue(g + STAGES - 1);
    store_q(g + STAGES - 1, qv);
    load_q(g + STAGES, qv);

    const unsigned char* st = ring + (g % STAGES) * R::STAGE + warp * WARP_BYTES;
    constexpr int EPC = 16 / (int)sizeof(T);                 // values a read
    const float* qs = reinterpret_cast<const float*>(
                          ring + (g % STAGES) * R::STAGE + TN * PITCH) +
                      qh * QPT * R::TD + warp * (WARP_BYTES / (int)sizeof(T));
#pragma unroll
    for (int c = 0; c < WARP_BYTES / 16; ++c) {
      float sv[RPT][EPC];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const uint4 raw = reinterpret_cast<const uint4*>(
            st + (rg + RG * j) * PITCH)[c];
        const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          sv[j][e] = to_f(tv[e]);
          nrm[j] = fmaf(sv[j][e], sv[j][e], nrm[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4* qp =
            reinterpret_cast<const float4*>(qs + i * R::TD + c * EPC);
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 x = qp[e4];
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            acc[j][i] = fmaf(x.x, sv[j][4 * e4 + 0], acc[j][i]);
            acc[j][i] = fmaf(x.y, sv[j][4 * e4 + 1], acc[j][i]);
            acc[j][i] = fmaf(x.z, sv[j][4 * e4 + 2], acc[j][i]);
            acc[j][i] = fmaf(x.w, sv[j][4 * e4 + 3], acc[j][i]);
          }
        }
      }
    }
    if (g % steps != steps - 1) continue;

    // ---- a tile is scored: the warps' partial sums, warps 0-3 written,
    // warps 4-7 added to them, then the four sums added in order
    const int slot = warp & 3;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if ((warp >> 2) == round) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = rg + RG * j;
          float* dst = red + (slot * TN + r) * RED_PITCH + qh * QPT;
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            dst[i] = round ? dst[i] + acc[j][i] : acc[j][i];
            acc[j][i] = 0.f;
          }
          if (qh == 0) {
            float* nd = nred + slot * TN + r;
            *nd = round ? *nd + nrm[j] : nrm[j];
          }
          nrm[j] = 0.f;
        }
      }
      __syncthreads();
    }
    const int tile = t_begin + g / steps;
    for (int e = tid; e < TN * BQ; e += THREADS) {
      const int r = e % TN, qi = e / TN, row = tile * TN + r, qq = q0 + qi;
      float dot = 0.f, nn = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dot += red[(w * TN + r) * RED_PITCH + qi];
        nn += nred[w * TN + r];
      }
      const float x = dot * rsqrtf(nn + 1e-12f);
      const bool live = row < N;
      if (KEYS) {
        if (!live || qq >= Q) continue;
        const u64 key = make_key(x, row, x == x);
        keys[(long long)qq * N + row] = key;
        if (key) hist_add(hist + qi * NBINS, (unsigned)(key >> (64 - HBITS)));
      } else {
        sc[qi * TN + r] = live ? x : CUDART_NAN_F;
      }
    }
    __syncthreads();
    if (KEYS) continue;
    // one warp per query merges the tile into the query's running list
    for (int qi = warp; qi < BQ; qi += WARPS) {
      if (q0 + qi >= Q) break;                         // warp-uniform
      const float* srow_q = sc + qi * TN;
      u64* lst = lists + qi * kw;
      const int n = lcnt[qi];
      const u64 lo = n < k ? 1ull : lmin[qi] + 1ull;   // keys are unique
      auto tile_key = [&](int j) {
        const float x = srow_q[j];
        const int r = tile * TN + j;
        return r < N ? make_key(x, r, x == x) : 0ull;
      };
      int c = 0;
      for (int j = lane; j < TN; j += 32) c += tile_key(j) >= lo;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      if (c == 0) continue;
      int w = n;
      if (n + c <= k) {
        for (int j0 = 0; j0 < TN; j0 += 32) {
          const u64 key = tile_key(j0 + lane);
          warp_append(key, key >= lo, lst, w, k);
        }
      } else if (n + c <= 128) {
        // few keys: sort the list and the candidates in registers (the
        // warp's histogram words hold them) and keep the first k
        u64* buf = reinterpret_cast<u64*>(whist);
        for (int e = lane; e < 128; e += 32) buf[e] = e < n ? lst[e] : 0ull;
        __syncwarp();
        for (int j0 = 0; j0 < TN; j0 += 32) {
          const u64 key = tile_key(j0 + lane);
          warp_append(key, key >= lo, buf, w, 128);
        }
        __syncwarp();
        if (w <= 32)
          warp_sort_regs<1>(buf);
        else if (w <= 64)
          warp_sort_regs<2>(buf);
        else
          warp_sort_regs<4>(buf);
        for (int e = lane; e < k; e += 32) lst[e] = buf[e];
        w = k;
      } else {
        const u64 thr = warp_topk_threshold(
            [&](auto f) {
              for (int e = lane; e < n; e += 32) f(lst[e]);
              for (int j = lane; j < TN; j += 32) {
                const u64 key = tile_key(j);
                if (key >= lo) f(key);
              }
            },
            k, whist);
        w = 0;
        for (int e0 = 0; e0 < n; e0 += 32) {
          const int e = e0 + lane;
          const u64 key = e < n ? lst[e] : 0ull;
          __syncwarp();
          warp_append(key, key >= thr && key != 0ull, lst, w, k);
          __syncwarp();
        }
        for (int j0 = 0; j0 < TN; j0 += 32) {
          const u64 key = tile_key(j0 + lane);
          warp_append(key, key >= thr && key >= lo, lst, w, k);
        }
      }
      __syncwarp();
      w = min(w, k);
      if (w == k) {
        u64 m = ~0ull;
        for (int e = lane; e < k; e += 32) m = min(m, lst[e]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) lmin[qi] = m;
      }
      if (lane == 0) lcnt[qi] = w;
      __syncwarp();
    }
  }
  cp_async_wait<0>();

  if (KEYS) {
    __syncthreads();
    for (int e = tid; e < BQ * NBINS; e += THREADS) {
      const unsigned v = hist[e];
      const int qq = q0 + e / NBINS;
      if (v && qq < Q) atomicAdd(&ghist[(long long)qq * NBINS + e % NBINS], v);
    }
    return;
  }

  // ---- this block's sorted lists -> part (Q, nrb, k)
  __syncthreads();
  for (int qi = warp; qi < BQ; qi += WARPS) {
    const int qq = q0 + qi;
    if (qq >= Q) break;
    u64* lst = lists + qi * kw;
    for (int e = lcnt[qi] + lane; e < kw; e += 32) lst[e] = 0ull;
    __syncwarp();
    warp_sort_desc(lst, kw);
    u64* dst = part + ((long long)qq * nrb + rb) * k;
    for (int e = lane; e < k; e += 32) dst[e] = lst[e];
  }
  __threadfence();
  __syncthreads();
  __shared__ int s_last;
  if (tid == 0) s_last = atomicAdd(&ticket[qt], 1) == nrb - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- the last block of this query tile merges every block's list; each
  // warp's share of the ring, the reduction buffer and the score tile holds
  // a query's list heads and candidates
  constexpr int WKEYS = (R::BYTES + R::RED + BQ * TN * 4) / 8 / WARPS;
  constexpr int HCAP = NRB_MAX + KMAX;
  constexpr int CCAP = WKEYS - HCAP;
  u64* heads = reinterpret_cast<u64*>(ring) + warp * WKEYS;
  u64* cand = heads + HCAP;
  // the first jh entries of every list: at least k keys in all
  const int jh = (k + nrb - 1) / nrb;
  for (int qi = warp; qi < BQ; qi += WARPS) {
    const int qq = q0 + qi;
    if (qq >= Q) break;
    const u64* pq = part + (long long)qq * nrb * k;
    for (int e = lane; e < nrb * jh; e += 32)
      heads[e] = __ldcg(pq + (long long)(e / jh) * k + e % jh);
    __syncwarp();
    // k of those keys are >= t0, so the top k are >= t0 too: only list
    // prefixes at or above t0 can hold them
    const u64 t0 = warp_topk_threshold(
        [&](auto f) {
          for (int e = lane; e < nrb * jh; e += 32) f(heads[e]);
        },
        k, whist);
    auto prefixes = [&](auto f) {
      for (int b = lane; b < nrb; b += 32) {
        if (heads[b * jh] < t0) continue;
        const u64* l = pq + (long long)b * k;
        for (int e = 0; e < k; ++e) {
          const u64 key = __ldcg(l + e);
          if (key < t0) break;
          f(key);
        }
      }
    };
    int* cnt = lcnt + qi;
    if (lane == 0) *cnt = 0;
    __syncwarp();
    prefixes([&](u64 key) {
      const int pos = atomicAdd(cnt, 1);
      if (pos < CCAP) cand[pos] = key;
    });
    __syncwarp();
    const int nc = *cnt;
    __syncwarp();
    auto from_smem = [&](auto f) {
      for (int e = lane; e < nc; e += 32) f(cand[e]);
    };
    // more prefix keys than the shared copy holds (ties): read them again
    // from L2 on every pass
    const bool fit = nc <= CCAP;
    const u64 thr = fit ? warp_topk_threshold(from_smem, k, whist)
                        : warp_topk_threshold(prefixes, k, whist);
    u64* lst = lists + qi * kw;
    for (int e = lane; e < kw; e += 32) lst[e] = 0ull;
    if (lane == 0) *cnt = 0;
    __syncwarp();
    auto take = [&](u64 key) {
      if (key >= thr) {
        const int pos = atomicAdd(cnt, 1);
        if (pos < k) lst[pos] = key;
      }
    };
    if (fit)
      from_smem(take);
    else
      prefixes(take);
    __syncwarp();
    warp_sort_desc(lst, kw);
    for (int e = lane; e < k; e += 32) {
      const u64 key = lst[e];
      out_s[(long long)qq * k + e] = key ? key_score(key) : -CUDART_INF_F;
      out_i[(long long)qq * k + e] = key ? key_id(key) : -1;
    }
  }
  if (tid == 0) ticket[qt] = 0;        // ready for the next call
}

// The threshold bin of one query's NB-bin histogram h, read by the whole
// block: the highest bin whose count from the top reaches need (bin 0 when
// fewer than need keys exist).  Every thread receives the bin, the count
// in the bins above it (excl) and in the bin itself (hit).
template <int NB>
__device__ void threshold_bin(const unsigned* __restrict__ h, int need,
                              int* bin, int* excl, int* hit) {
  __shared__ int red[WARPS];
  __shared__ int s_bin, s_excl, s_hit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int PER = NB / THREADS;
  // thread t owns bins NB-1-PER t down to NB-PER (t+1): descending
  int c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = (int)h[NB - 1 - PER * tid - j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += red[w];
  incl += base;
  const int excl0 = incl - sum;
  if (excl0 < need && incl >= need) {   // exactly one thread
    int cum = excl0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (cum + c[j] >= need) {
        s_bin = NB - 1 - PER * tid - j;
        s_excl = cum;
        s_hit = c[j];
        break;
      }
      cum += c[j];
    }
  }
  if (tid == THREADS - 1 && incl < need) {   // fewer than need keys
    s_bin = 0;
    s_excl = incl - c[PER - 1];
    s_hit = c[PER - 1];
  }
  __syncthreads();
  *bin = s_bin;
  *excl = s_excl;
  *hit = s_hit;
  __syncthreads();                      // s_* are written again next call
}

// One query's threshold for the k > 128 path, through `levels` digits:
// the 10-bit bin of its (NBINS) histogram, then, while the keys at or above
// the threshold are more than cap, the 11-bit digit of the next refine
// histogram (RBINS words a level, counting only the keys of the bucket so
// far).  Every thread receives the threshold's prefix and its width in bits,
// and the count of keys at or above it.
__device__ void keyed_threshold(const unsigned* __restrict__ h,
                                const unsigned* __restrict__ hr, int levels,
                                int k, int cap, u64* prefix, int* bits,
                                int* above) {
  int bin, excl, hit;
  threshold_bin<NBINS>(h, k, &bin, &excl, &hit);
  u64 pre = (u64)bin;
  int nb = HBITS, base = excl;
  for (int l = 0; l < levels && base + hit > cap; ++l) {
    threshold_bin<RBINS>(hr + l * RBINS, k - base, &bin, &excl, &hit);
    pre = (pre << RBITS) | (u64)bin;
    nb += RBITS;
    base += excl;
  }
  *prefix = pre;
  *bits = nb;
  *above = base + hit;
}

// Refine level `level` (0 or 1) of the k > 128 path, per query: where the
// keys at or above the threshold of the levels before it are more than cap,
// the next 11 bits of the keys in that bucket are counted into ghr (Q,
// REFINE_LEVELS, RBINS), as AIR top-k iterates its digits.  Scores that
// crowd a few exponents (the cosines of similar texts, all in [0.5, 1))
// fill one or two 10-bit bins; two refine levels take the threshold to the
// score's whole 32 bits, so only keys of equal score can still overflow.
// Every block of a query computes the threshold alike.
__global__ void __launch_bounds__(THREADS)
knn_refine_kernel(const u64* __restrict__ keys,
                  const unsigned* __restrict__ ghist,
                  unsigned* __restrict__ ghr, int N, int k, int cap,
                  int level) {
  __shared__ unsigned sh[RBINS];
  const int tid = threadIdx.x;
  const int qq = blockIdx.y;
  unsigned* hr = ghr + (long long)qq * REFINE_LEVELS * RBINS;
  u64 prefix;
  int bits, above;
  keyed_threshold(ghist + (long long)qq * NBINS, hr, level, k, cap, &prefix,
                  &bits, &above);
  if (above <= cap) return;             // the threshold so far is enough
  for (int b = tid; b < RBINS; b += THREADS) sh[b] = 0u;
  __syncthreads();
  const u64* krow = keys + (long long)qq * N;
  const long long i0 = (long long)blockIdx.x * THREADS * COMPACT_PER_THREAD;
  for (int j = 0; j < COMPACT_PER_THREAD; ++j) {
    const long long i = i0 + (long long)j * THREADS + tid;
    const u64 key = i < N ? krow[i] : 0ull;
    if (key != 0ull && (key >> (64 - bits)) == prefix)
      hist_add(sh, (unsigned)(key >> (64 - bits - RBITS)) & (RBINS - 1));
  }
  __syncthreads();
  for (int b = tid; b < RBINS; b += THREADS)
    if (sh[b]) atomicAdd(&hr[level * RBINS + b], sh[b]);
}

// Per query: the threshold through every refine level and the count of keys
// at or above it.  If the count exceeds cap (keys of equal score), the query
// is flagged for the full-key selection; otherwise its keys at or above the
// threshold are copied into cand (Q, cap) and the rest of its row is zeroed.
__global__ void __launch_bounds__(THREADS)
knn_compact_kernel(const u64* __restrict__ keys,
                   const unsigned* __restrict__ ghist,
                   const unsigned* __restrict__ ghr, u64* __restrict__ cand,
                   int* __restrict__ ccount, int* __restrict__ overflow, int N,
                   int k, int cap) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int qq = blockIdx.y;
  u64 prefix;
  int bits, above;
  keyed_threshold(ghist + (long long)qq * NBINS,
                  ghr + (long long)qq * REFINE_LEVELS * RBINS, REFINE_LEVELS,
                  k, cap, &prefix, &bits, &above);
  if (above > cap) {
    if (blockIdx.x == 0 && tid == 0) overflow[qq] = 1;
    return;
  }
  if (blockIdx.x == 0 && tid == 0) overflow[qq] = 0;
  const u64 lo = prefix << (64 - bits);
  u64* crow = cand + (long long)qq * cap;
  for (long long i = above + (long long)blockIdx.x * THREADS + tid; i < cap;
       i += (long long)gridDim.x * THREADS)
    crow[i] = 0ull;
  const u64* krow = keys + (long long)qq * N;
  const long long i0 = (long long)blockIdx.x * THREADS * COMPACT_PER_THREAD;
  for (int j = 0; j < COMPACT_PER_THREAD; ++j) {
    const long long i = i0 + (long long)j * THREADS + tid;
    const u64 key = i < N ? krow[i] : 0ull;
    const bool keep = key != 0ull && key >= lo;
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (!ball) continue;
    int at = 0;
    if (lane == __ffs(ball) - 1) at = atomicAdd(ccount + qq, __popc(ball));
    at = __shfl_sync(0xffffffffu, at, __ffs(ball) - 1);
    if (keep) crow[at + __popc(ball & ((1u << lane) - 1u))] = key;
  }
}

template <typename T, bool KEYS, int VEC>
cudaError_t plan(int Q, int N, int k, int* nrb_out) {
  const int smem = smem_bytes<T, KEYS>(pow2_at_least(k));
  auto fn = knn_scan_kernel<T, KEYS, VEC>;
  // the attribute is per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, bps = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, THREADS,
                                                         smem)) != cudaSuccess)
    return e;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  const int nqt = (Q + BQ - 1) / BQ;
  const int ntiles = (N + TN - 1) / TN;
  int nrb = bps * sms / nqt;
  if (nrb < 1) nrb = 1;
  if (nrb > ntiles) nrb = ntiles;
  if (nrb > NRB_MAX) nrb = NRB_MAX;
  *nrb_out = nrb;
  return cudaSuccess;
}

template <typename T, bool KEYS, int VEC>
cudaError_t scan(const float* q, const T* s, int Q, int N, int D, int k,
                 int nrb, u64* part, int* ticket, float* out_s, int* out_i,
                 u64* keys, unsigned* ghist, cudaStream_t st) {
  int want = 0;
  cudaError_t e = plan<T, KEYS, VEC>(Q, N, k, &want);
  if (e != cudaSuccess) return e;
  if (nrb != want) return cudaErrorInvalidValue;
  const int nqt = (Q + BQ - 1) / BQ;
  knn_scan_kernel<T, KEYS, VEC>
      <<<nqt * nrb, THREADS, smem_bytes<T, KEYS>(pow2_at_least(k)), st>>>(
          q, s, Q, N, D, k, nrb, part, ticket, out_s, out_i, keys, ghist);
  const cudaError_t err = cudaGetLastError();
  g_launches += err == cudaSuccess;
  return err;
}

template <typename T, int VEC>
int launch(const float* q, const T* s, int Q, int N, int D, int k, int nrb,
           float* out_s, int* out_i, u64* part, int* ticket, u64* keys,
           unsigned* ghist, unsigned* ghist2, u64* cand, int* ccount,
           int* overflow, int cap, cudaStream_t st) {
  if (k <= KMAX)
    return (int)scan<T, false, VEC>(q, s, Q, N, D, k, nrb, part, ticket,
                                    out_s, out_i, nullptr, nullptr, st);
  cudaError_t e = scan<T, true, VEC>(q, s, Q, N, D, k, nrb, nullptr, nullptr,
                                     nullptr, nullptr, keys, ghist, st);
  if (e != cudaSuccess) return (int)e;
  const int per = THREADS * COMPACT_PER_THREAD;
  const dim3 grid((N + per - 1) / per, Q);
  for (int level = 0; level < REFINE_LEVELS; ++level) {
    knn_refine_kernel<<<grid, THREADS, 0, st>>>(keys, ghist, ghist2, N, k,
                                                cap, level);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ++g_launches;
  }
  knn_compact_kernel<<<grid, THREADS, 0, st>>>(keys, ghist, ghist2, cand,
                                               ccount, overflow, N, k, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++g_launches;
  const int rounds = (k + SEL_KMAX - 1) / SEL_KMAX;
  if ((e = select_topk(cand, Q, cap, k, out_s, out_i, st)) != cudaSuccess)
    return (int)e;
  g_launches += rounds;
  e = select_flagged(keys, overflow, Q, N, k, out_s, out_i, st);
  g_launches += e == cudaSuccess ? rounds : 0;
  return (int)e;
}

template <typename T>
int plan_rows(int Q, int N, int D, int k, int* nrb) {
  const bool v16 = ((long long)D * sizeof(T)) % 16 == 0;
  if (k <= KMAX)
    return (int)(v16 ? plan<T, false, 16>(Q, N, k, nrb)
                     : plan<T, false, 4>(Q, N, k, nrb));
  return (int)(v16 ? plan<T, true, 16>(Q, N, k, nrb)
                   : plan<T, true, 4>(Q, N, k, nrb));
}

}  // namespace

extern "C" {

// CUDA kernels launched by this library since it was loaded
unsigned long long knn_topk_device_launches() { return g_launches; }

// The number of row ranges (blocks per query tile) a call of these sizes
// runs; the caller sizes the (Q, nrb, k) list scratch with it.
int knn_topk_plan(int s_bf16, int Q, int N, int D, int k, int* nrb) {
  if (k < 1 || Q < 1 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (s_bf16 && D % 2) return (int)cudaErrorInvalidValue;
  return s_bf16 ? plan_rows<__nv_bfloat16>(Q, N, D, k, nrb)
                : plan_rows<float>(Q, N, D, k, nrb);
}

// q (Q, D) f32; s (N, D) f32 or bf16 (s_bf16 != 0); out (Q, k).
// k <= 128: part (Q, nrb, k) u64 scratch, ticket (ceil(Q / 16),) int32
// holding zeros (left zero by the call).  k > 128: keys (Q, N) u64,
// ghist (Q, 1024) and ghist2 (Q, 2, 2048) u32 zeros, cand (Q, cap) u64,
// ccount (Q,) int32 zeros, overflow (Q,) int32.
int knn_topk_launch(const void* q, const void* s, int s_bf16, void* out_s,
                    void* out_i, int Q, int N, int D, int k, int nrb,
                    void* part, void* ticket, void* keys, void* ghist,
                    void* ghist2, void* cand, void* ccount, void* overflow,
                    int cap, void* stream) {
  if (k < 1 || Q < 1 || N < 1 || D < 1 || (k > KMAX && cap < 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto os = static_cast<float*>(out_s);
  auto oi = static_cast<int*>(out_i);
  auto pp = static_cast<u64*>(part);
  auto tp = static_cast<int*>(ticket);
  auto kp = static_cast<u64*>(keys);
  auto hp = static_cast<unsigned*>(ghist);
  auto h2 = static_cast<unsigned*>(ghist2);
  auto cp = static_cast<u64*>(cand);
  auto cc = static_cast<int*>(ccount);
  auto of = static_cast<int*>(overflow);
  if (s_bf16) {
    if (D % 2) return (int)cudaErrorInvalidValue;
    auto sb = static_cast<const __nv_bfloat16*>(s);
    return (D * 2) % 16 == 0
               ? launch<__nv_bfloat16, 16>(qf, sb, Q, N, D, k, nrb, os, oi,
                                           pp, tp, kp, hp, h2, cp, cc, of,
                                           cap, st)
               : launch<__nv_bfloat16, 4>(qf, sb, Q, N, D, k, nrb, os, oi, pp,
                                          tp, kp, hp, h2, cp, cc, of, cap,
                                          st);
  }
  auto sf = static_cast<const float*>(s);
  return (D * 4) % 16 == 0
             ? launch<float, 16>(qf, sf, Q, N, D, k, nrb, os, oi, pp, tp, kp,
                                 hp, h2, cp, cc, of, cap, st)
             : launch<float, 4>(qf, sf, Q, N, D, k, nrb, os, oi, pp, tp, kp,
                                hp, h2, cp, cc, of, cap, st);
}

}  // extern "C"
