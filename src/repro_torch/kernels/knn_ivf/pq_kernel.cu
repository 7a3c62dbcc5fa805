// IVF-PQ asymmetric-distance (ADC) shortlist over packed code-major lists,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_ivf/pq_kernel.py:114
// `ivfpq_adc_pallas` (`_adc_kernel` :48): per query, LUT[j, c] =
// q_j . codebook[j, c] for each subspace j; per probed row
// score = (sum_j LUT[j, code_j] + q . anchor_c) * inv, masked to ids >= 0,
// then the top-kk shortlist; scores f32 descending, ids int32, -inf / -1
// in slots no valid row fills.
//
// What bounds it on an H100: at the serving shape (16 queries, nprobe 8,
// L 400, m 64, nbits 8) the codes are 16 x 8 x 400 x 64 bytes = 3.3 MB and
// the codebooks 0.8 MB, about 1 us of HBM time, and the gathers are a few
// million shared-memory reads.  So it is bound by latency and launches:
// three short dependent kernels and one serial selection per query.  The
// design keeps each step one pass with no host round trip; making it
// faster means fewer launches (a CUDA graph) and a parallel selection.
//
// Design.  The TPU builds the table with one matmul against a
// block-diagonal codebook expansion and scores codes through an m-hot
// matmul, because Mosaic has no dynamic VMEM gather.  Hopper gathers from
// shared memory directly:
//   lut     grid (subspace, query): one thread per codebook entry writes
//           LUT[q, j, c] to a (Q, m, 2^nbits) scratch.
//   scan    grid (probe slot, query).  The block reads its probe id from
//           q_probe on the device, copies its query's LUT into shared
//           memory (64 KB at m 64, nbits 8), reduces q . anchor, and each
//           thread scores list rows l, l + 256, ...: in code-major
//           (C, MB, L) storage neighbouring threads read neighbouring rows'
//           bytes of one subspace, so the code reads coalesce.  nbits 4
//           holds subspace 2b in the low nibble of byte b, 2b + 1 in the
//           high nibble.  One 64-bit selection key per candidate.
//   select  one block per query picks the top-kk (select.cuh).
// A table larger than LUT_MAX_BYTES does not fit beside the block's other
// shared memory; the launch refuses it (the wrapper raises first).
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int LUT_MAX_BYTES = 200 * 1024;

__global__ void adc_lut_kernel(const float* __restrict__ q,
                               const float* __restrict__ cb,
                               float* __restrict__ lut, int D, int m, int K) {
  const int j = blockIdx.x, qi = blockIdx.y;
  const int dsub = D / m;
  const float* qv = q + (size_t)qi * D + (size_t)j * dsub;
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    const float* e = cb + ((size_t)j * K + c) * dsub;
    float acc = 0.f;
    for (int d = 0; d < dsub; ++d) acc = fmaf(qv[d], e[d], acc);
    lut[((size_t)qi * m + j) * K + c] = acc;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
adc_scan_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                const unsigned char* __restrict__ codes,
                const int* __restrict__ ids, const float* __restrict__ inv,
                const float* __restrict__ anchors,
                const float* __restrict__ lut_g,
                unsigned long long* __restrict__ keys, int C, int MB, int L,
                int D, int P, int m, int nbits) {
  extern __shared__ __align__(16) float lut[];          // (m, K)
  __shared__ float red[SCAN_THREADS / 32];
  const int p = blockIdx.x, qi = blockIdx.y, tid = threadIdx.x;
  const int MK = m << nbits;
  const float* src = lut_g + (size_t)qi * MK;
  for (int e = tid; e < MK; e += SCAN_THREADS) lut[e] = src[e];
  const int cid = q_probe[(size_t)qi * P + p];
  const bool live = cid >= 0 && cid < C;

  float a = 0.f;
  if (live)
    for (int d = tid; d < D; d += SCAN_THREADS)
      a = fmaf(q[(size_t)qi * D + d], anchors[(size_t)cid * D + d], a);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  if ((tid & 31) == 0) red[tid >> 5] = a;
  __syncthreads();                       // also publishes the LUT
  float aq = 0.f;
#pragma unroll
  for (int w = 0; w < SCAN_THREADS / 32; ++w) aq += red[w];

  unsigned long long* out = keys + ((size_t)qi * P + p) * L;
  for (int l = tid; l < L; l += SCAN_THREADS) {
    if (!live) {
      out[l] = 0ull;
      continue;
    }
    const unsigned char* cl = codes + (size_t)cid * MB * L + l;
    float acc = 0.f;
    if (nbits == 8) {
      for (int j = 0; j < MB; ++j) acc += lut[(j << 8) + cl[(size_t)j * L]];
    } else {
      for (int b = 0; b < MB; ++b) {
        const int byte = cl[(size_t)b * L];
        acc += lut[(2 * b) * 16 + (byte & 0xF)];
        acc += lut[(2 * b + 1) * 16 + (byte >> 4)];
      }
    }
    const size_t row = (size_t)cid * L + l;
    const int id = ids[row];
    out[l] = make_key((acc + aq) * inv[row], id, id >= 0);
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32; q_probe (Q, P) i32; codes (C, MB, L) u8; ids / inv (C, L);
// anchors (C, D) f32; cb (m, 2^nbits, D / m) f32; lut (Q, m, 2^nbits) f32
// and keys (Q, P * L) u64 scratch; out (Q, k).
int ivfpq_adc_launch(const void* q, const void* q_probe, const void* codes,
                     const void* ids, const void* inv, const void* anchors,
                     const void* cb, void* lut, void* keys, void* out_s,
                     void* out_i, int Q, int P, int C, int MB, int L, int D,
                     int m, int nbits, int k, void* stream) {
  if (k < 1 || Q < 1 || P < 1 || L < 1 || m < 1 || D % m ||
      !(nbits == 8 ? MB == m : nbits == 4 && 2 * MB == m))
    return (int)cudaErrorInvalidValue;
  const int K = 1 << nbits;
  const int smem = m * K * (int)sizeof(float);
  if (smem > LUT_MAX_BYTES) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto qf = static_cast<const float*>(q);
  auto lp = static_cast<float*>(lut);
  auto kp = static_cast<unsigned long long*>(keys);
  adc_lut_kernel<<<dim3(m, Q), K < SCAN_THREADS ? K : SCAN_THREADS, 0, st>>>(
      qf, static_cast<const float*>(cb), lp, D, m, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adc_scan_kernel<<<dim3(P, Q), SCAN_THREADS, smem, st>>>(
      qf, static_cast<const int*>(q_probe),
      static_cast<const unsigned char*>(codes), static_cast<const int*>(ids),
      static_cast<const float*>(inv), static_cast<const float*>(anchors), lp,
      kp, C, MB, L, D, P, m, nbits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)select_topk(kp, Q, P * L, k, static_cast<float*>(out_s),
                          static_cast<int*>(out_i), st);
}

}  // extern "C"
