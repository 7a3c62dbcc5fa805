// Exact cosine top-k retrieval for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_topk/kernel.py:79
// `knn_topk_pallas` (`_knn_kernel` :54, `merge_topk` :23):
//   score(q, n) = q . s_n * rsqrt(|s_n|^2 + 1e-12), top-k over n,
//   scores f32 descending, ids int32, -inf / -1 in slots no row fills.
//
// What bounds it on an H100: the support set is read once per call
// (N x D x 4 bytes, 307 MB at N = 100k, D = 768 in f32: ~92 us at
// 3.35 TB/s) and the dot products cost 2 Q N D flops on the f32 CUDA cores
// (67 TFLOP/s: ~37 us at Q = 16, ~147 us at Q = 64).  So a serving batch of
// a few queries is bound by bytes, and the design is about reading the
// support set once with enough blocks in flight to fill all 132 SMs.
//
// Design.  On the TPU the N axis is a sequential grid dimension that
// carries a running top-k in VMEM.  Blocks on Hopper run in no order, so
// the work is split in two passes instead:
//   pass 1  grid (query tile of 16, chunk of 512 rows).  The block scores
//           its chunk against its queries (f32 FMAs from shared-memory
//           tiles, the row norm fused into the same loop), keeps the
//           16 x 512 score tile in shared memory, and each warp selects the
//           chunk's top-k of one query with k rounds of a warp argmax.
//           Query tiles are the fastest grid axis, so the blocks that read
//           the same chunk run together and the chunk is read from HBM once.
//   pass 2  merge: one warp per (query, 1024 candidates) selects the top-k
//           of its candidates; repeated until one list of k remains.
// Ragged Q and N edges are masked in the kernel; no padding is needed.
// Ties are broken towards the lower row id, like `lax.top_k`.
//
// k > 128: the warp selection keeps k candidates in registers and stops
// at 128, so pass 1 instead writes one 64-bit key per (query, support row)
// (order-preserving score bits, then ~id) and the shared per-query radix
// select of the IVF kernels (`select.cuh`, in rounds of 1,024 for a larger
// k) picks the top k, ties again to the lower id.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "../knn_ivf/select.cuh"

namespace {

constexpr int P1_THREADS = 256;
constexpr int BQ = 16;       // queries per pass-1 block
constexpr int TN = 256;      // support rows per sub-tile, one per thread
constexpr int CH = 512;      // support rows per pass-1 block
constexpr int TD = 32;       // feature columns per shared-memory step
constexpr int MERGE = 1024;  // candidates per warp in a merge pass
constexpr int MERGE_WARPS = 4;
constexpr int KMAX = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// round a query value through the support dtype, as the reference does
__device__ __forceinline__ float as_t(float x, float) { return x; }
__device__ __forceinline__ float as_t(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// total order used by every selection: higher score first, then lower id
// (ids compare unsigned, so -1 sorts last), then lower lane
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && (unsigned)ia < (unsigned)ib);
}

template <int PER>
__device__ __forceinline__ void lane_best(const float (&v)[PER], const int (&id)[PER],
                                          float& bv, int& bid, int& bj) {
  bv = -CUDART_INF_F;
  bid = -1;
  bj = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (better(v[j], id[j], bv, bid)) {
      bv = v[j];
      bid = id[j];
      bj = j;
    }
  }
}

// Top-k of the warp's 32 * PER candidates (lane holds candidates
// lane + 32 j), written sorted to out_s / out_i[0, k).  Each round a warp
// argmax picks the best remaining candidate; only the winning lane rescans.
template <int PER>
__device__ void warp_topk(float (&v)[PER], int (&id)[PER], int k,
                          float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  float bv;
  int bid, bj;
  lane_best(v, id, bv, bid, bj);
  for (int t = 0; t < k; ++t) {
    float wv = bv;
    int wid = bid, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oid = __shfl_xor_sync(0xffffffffu, wid, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (better(ov, oid, wv, wid) || (ov == wv && oid == wid && ol < wl)) {
        wv = ov;
        wid = oid;
        wl = ol;
      }
    }
    if (lane == 0) {
      const bool empty = !(wv > -CUDART_INF_F);
      out_s[t] = empty ? -CUDART_INF_F : wv;
      out_i[t] = empty ? -1 : wid;
    }
    if (lane == wl) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (j == bj) {
          v[j] = -CUDART_INF_F;
          id[j] = -1;
        }
      }
      lane_best(v, id, bv, bid, bj);
    }
  }
}

// KEYS: write the chunk's selection keys to keys (Q, N) instead of its
// top-k candidates
template <typename T, bool KEYS>
__global__ void __launch_bounds__(P1_THREADS)
knn_chunk_kernel(const float* __restrict__ q, const T* __restrict__ s,
                 float* __restrict__ cand_s, int* __restrict__ cand_i,
                 unsigned long long* __restrict__ keys,
                 int Q, int N, int D, int k, int nch) {
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;                   // [TN][TD + 1] support tile
  float* Qs = Ss + TN * (TD + 1);     // [TD][BQ] query tile, d-major
  float* Sc = Qs + TD * BQ;           // [BQ][CH] chunk scores
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int n0 = chunk * CH;

  for (int sub = 0; sub < CH / TN; ++sub) {
    const int r0 = n0 + sub * TN;
    float acc[BQ];
#pragma unroll
    for (int i = 0; i < BQ; ++i) acc[i] = 0.f;
    float nrm = 0.f;
    for (int d0 = 0; d0 < D; d0 += TD) {
      __syncthreads();
      const int d = d0 + lane;
      for (int r = warp; r < TN; r += P1_THREADS / 32) {
        const int row = r0 + r;
        Ss[r * (TD + 1) + lane] =
            (row < N && d < D) ? to_f(s[(size_t)row * D + d]) : 0.f;
      }
      for (int e = tid; e < TD * BQ; e += P1_THREADS) {
        const int qi = e / TD, dd = e % TD, qq = q0 + qi, dq = d0 + dd;
        Qs[dd * BQ + qi] =
            (qq < Q && dq < D) ? as_t(q[(size_t)qq * D + dq], T()) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < TD; ++dd) {
        const float sv = Ss[tid * (TD + 1) + dd];
        nrm = fmaf(sv, sv, nrm);
        const float4* qv = reinterpret_cast<const float4*>(Qs + dd * BQ);
#pragma unroll
        for (int i = 0; i < BQ / 4; ++i) {
          const float4 x = qv[i];
          acc[4 * i + 0] = fmaf(x.x, sv, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(x.y, sv, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(x.z, sv, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(x.w, sv, acc[4 * i + 3]);
        }
      }
    }
    const bool live = r0 + tid < N;
    const float inv = rsqrtf(nrm + 1e-12f);
#pragma unroll
    for (int i = 0; i < BQ; ++i)
      Sc[i * CH + sub * TN + tid] = live ? acc[i] * inv : -CUDART_INF_F;
  }
  __syncthreads();

  if (KEYS) {
    for (int e = tid; e < BQ * CH; e += P1_THREADS) {
      const int qi = e / CH, c = e % CH, qq = q0 + qi, n = n0 + c;
      if (qq < Q && n < N) {
        const float x = Sc[qi * CH + c];
        keys[(size_t)qq * N + n] = make_key(x, n, x == x);
      }
    }
    return;
  }
  for (int qi = warp; qi < BQ; qi += P1_THREADS / 32) {
    const int qq = q0 + qi;
    if (qq >= Q) break;                       // warp-uniform
    float v[CH / 32];
    int id[CH / 32];
#pragma unroll
    for (int j = 0; j < CH / 32; ++j) {
      const int c = lane + 32 * j;
      const float x = Sc[qi * CH + c];
      const bool ok = n0 + c < N && x == x;   // drops padding and NaN
      v[j] = ok ? x : -CUDART_INF_F;
      id[j] = ok ? n0 + c : -1;
    }
    const size_t base = ((size_t)qq * nch + chunk) * k;
    warp_topk<CH / 32>(v, id, k, cand_s + base, cand_i + base);
  }
}

// in: (Q, L) candidate lists -> out: (Q, nout, k), nout = ceil(L / MERGE)
__global__ void __launch_bounds__(32 * MERGE_WARPS)
knn_merge_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i,
                 int L, float* __restrict__ out_s, int* __restrict__ out_i,
                 int nout, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * MERGE_WARPS + warp;
  const int qq = blockIdx.y;
  if (c >= nout) return;                      // warp-uniform, no block sync
  float v[MERGE / 32];
  int id[MERGE / 32];
#pragma unroll
  for (int j = 0; j < MERGE / 32; ++j) {
    const int idx = c * MERGE + lane + 32 * j;
    float x = -CUDART_INF_F;
    int i = -1;
    if (idx < L) {
      x = in_s[(size_t)qq * L + idx];
      i = in_i[(size_t)qq * L + idx];
    }
    const bool ok = i >= 0 && x == x;
    v[j] = ok ? x : -CUDART_INF_F;
    id[j] = ok ? i : -1;
  }
  const size_t base = ((size_t)qq * nout + c) * k;
  warp_topk<MERGE / 32>(v, id, k, out_s + base, out_i + base);
}

template <typename T, bool KEYS>
cudaError_t chunk_pass(const float* q, const T* s, float* cand_s, int* cand_i,
                       unsigned long long* keys, int Q, int N, int D, int k,
                       cudaStream_t st) {
  static bool configured = false;
  const int smem = (TN * (TD + 1) + TD * BQ + BQ * CH) * (int)sizeof(float);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_chunk_kernel<T, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nch = (N + CH - 1) / CH;
  knn_chunk_kernel<T, KEYS><<<dim3((Q + BQ - 1) / BQ, nch), P1_THREADS, smem,
                              st>>>(q, s, cand_s, cand_i, keys, Q, N, D, k,
                                    nch);
  return cudaGetLastError();
}

template <typename T>
int launch(const float* q, const T* s, float* out_s, int* out_i,
           float* buf_s0, int* buf_i0, float* buf_s1, int* buf_i1,
           unsigned long long* keys, int Q, int N, int D, int k,
           cudaStream_t st) {
  if (k > KMAX) {
    cudaError_t e = chunk_pass<T, true>(q, s, nullptr, nullptr, keys, Q, N, D,
                                        k, st);
    if (e != cudaSuccess) return (int)e;
    return (int)select_topk(keys, Q, N, k, out_s, out_i, st);
  }
  const int nch = (N + CH - 1) / CH;
  float* dst_s = nch == 1 ? out_s : buf_s0;
  int* dst_i = nch == 1 ? out_i : buf_i0;
  cudaError_t e = chunk_pass<T, false>(q, s, dst_s, dst_i, nullptr, Q, N, D,
                                       k, st);
  if (e != cudaSuccess || nch == 1) return (int)e;
  int L = nch * k;
  const float* src_s = buf_s0;
  const int* src_i = buf_i0;
  bool to1 = true;
  while (true) {
    const int nout = (L + MERGE - 1) / MERGE;
    float* ds = nout == 1 ? out_s : (to1 ? buf_s1 : buf_s0);
    int* di = nout == 1 ? out_i : (to1 ? buf_i1 : buf_i0);
    knn_merge_kernel<<<dim3((nout + MERGE_WARPS - 1) / MERGE_WARPS, Q),
                       32 * MERGE_WARPS, 0, st>>>(src_s, src_i, L, ds, di,
                                                  nout, k);
    e = cudaGetLastError();
    if (e != cudaSuccess || nout == 1) return (int)e;
    src_s = ds;
    src_i = di;
    to1 = !to1;
    L = nout * k;
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32; s (N, D) f32 or bf16 (s_bf16 != 0); out (Q, k).
// k <= 128: buf0 holds (Q, ceil(N / 512), k) candidates, buf1 the first
// merge level.  k > 128: keys holds (Q, N) selection keys.
int knn_topk_launch(const void* q, const void* s, int s_bf16, void* out_s,
                    void* out_i, void* buf_s0, void* buf_i0, void* buf_s1,
                    void* buf_i1, void* keys, int Q, int N, int D, int k,
                    void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto os = static_cast<float*>(out_s);
  auto oi = static_cast<int*>(out_i);
  auto s0 = static_cast<float*>(buf_s0);
  auto i0 = static_cast<int*>(buf_i0);
  auto s1 = static_cast<float*>(buf_s1);
  auto i1 = static_cast<int*>(buf_i1);
  auto kp = static_cast<unsigned long long*>(keys);
  if (s_bf16)
    return launch(qf, static_cast<const __nv_bfloat16*>(s), os, oi, s0, i0, s1,
                  i1, kp, Q, N, D, k, st);
  return launch(qf, static_cast<const float*>(s), os, oi, s0, i0, s1, i1, kp,
                Q, N, D, k, st);
}

}  // extern "C"
