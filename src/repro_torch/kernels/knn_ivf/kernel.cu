// IVF approximate top-k over a cluster-major support set, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_ivf/kernel.py:65
// `ivf_topk_pallas` (`_ivf_kernel` :18): per query, over the rows of its
// own `nprobe` probed lists, score = (q . row) * inv, masked to ids >= 0,
// then top-k; scores f32 descending, ids int32, -inf / -1 in slots no
// valid row fills.
//
// What bounds it on an H100: the probed lists' raw rows, read once per
// distinct list (distinct lists x L x D x 4 bytes: at most 128 lists x 400
// x 768 x 4 = 157 MB for 16 queries at nprobe 8, 47 us at 3.35 TB/s); the
// dot products (2 Q P L D flops, 79 MFLOP) are far below the f32 rate.
// So it is bound by bytes, and the design reads rows with 16-byte loads
// from enough blocks to keep every SM's loads in flight.
//
// Design.  The TPU plans per-tile slot lists on the host, scalar-prefetches
// them, and carries a running top-k along the slot axis.  None of that
// carries over:
//   pass 1  grid (row chunk of 64, probe slot, query).  The block reads its
//           query's probe id from q_probe on the device itself, keeps the
//           query in shared memory, and each warp scores 8 rows of the
//           probed list (one row at a time across the warp's lanes, float4
//           loads, butterfly reduction), writing one 64-bit selection key
//           per candidate (select.cuh).
//   pass 2  one block per query selects the top-k of its nprobe x L keys
//           (in rounds of 1,024 for a larger k).
// Queries that probe the same list read it again; at serving batch sizes
// the repeats mostly hit the 50 MB L2.  Reading each list once for all
// queries that probe it (a list-major pass) is left to a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int ROWS = 64;     // list rows per pass-1 block, 8 per warp

__global__ void __launch_bounds__(SCAN_THREADS)
ivf_scan_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                const float* __restrict__ sup, const int* __restrict__ ids,
                const float* __restrict__ inv,
                unsigned long long* __restrict__ keys, int C, int L, int D,
                int P, int vec) {
  extern __shared__ __align__(16) float qs[];
  const int qi = blockIdx.z, p = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < D; d += SCAN_THREADS) qs[d] = q[(size_t)qi * D + d];
  __syncthreads();
  const int cid = q_probe[(size_t)qi * P + p];
  const bool live = cid >= 0 && cid < C;
  unsigned long long* out = keys + ((size_t)qi * P + p) * L;
  for (int r = warp; r < ROWS; r += SCAN_THREADS / 32) {
    const int l = blockIdx.x * ROWS + r;
    if (l >= L) break;                                  // warp-uniform
    if (!live) {
      if (lane == 0) out[l] = 0ull;
      continue;
    }
    const size_t row = (size_t)cid * L + l;
    float acc = 0.f;
    if (vec) {
      const float4* s4 = reinterpret_cast<const float4*>(sup + row * D);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int c = lane; c < D / 4; c += 32) {
        const float4 a = __ldg(s4 + c);
        const float4 b = q4[c];
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      const float* s = sup + row * D;
      for (int d = lane; d < D; d += 32) acc = fmaf(__ldg(s + d), qs[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int id = ids[row];
      out[l] = make_key(acc * inv[row], id, id >= 0);
    }
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32; q_probe (Q, P) i32; sup (C, L, D) f32; ids / inv (C, L);
// keys (Q, P * L) u64 scratch; out (Q, k).
int ivf_topk_launch(const void* q, const void* q_probe, const void* sup,
                    const void* ids, const void* inv, void* keys, void* out_s,
                    void* out_i, int Q, int P, int C, int L, int D, int k,
                    void* stream) {
  if (k < 1 || Q < 1 || P < 1 || L < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int smem = D * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ivf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(sup) % 16 == 0;
  auto kp = static_cast<unsigned long long*>(keys);
  ivf_scan_kernel<<<dim3((L + ROWS - 1) / ROWS, P, Q), SCAN_THREADS, smem,
                    st>>>(static_cast<const float*>(q),
                          static_cast<const int*>(q_probe),
                          static_cast<const float*>(sup),
                          static_cast<const int*>(ids),
                          static_cast<const float*>(inv), kp, C, L, D, P, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)select_topk(kp, Q, P * L, k, static_cast<float*>(out_s),
                          static_cast<int*>(out_i), st);
}

}  // extern "C"
