// Forward attention for Hopper (sm_90a): online softmax in f32, GQA,
// causal and sliding-window masks with dead key tiles skipped.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:90
// `flash_attention_pallas` (`_flash_kernel` :25).  Same function: scale
// 1/sqrt(hd), query head h reads KV head h * KV / H, causal mask
// qpos >= kpos, window mask qpos - kpos < window, output in q's dtype.
// Layout is the model's (B, S, heads, hd), contiguous, so no transposes.
//
// What bounds it on an H100: at the query encoder's shape (B = 1024
// texts, S = 64, H = KV = 12, hd = 64, f32, causal) the kernel moves
// q, k, v and o once (4 x 201 MB: ~240 us at 3.35 TB/s) against ~3.2
// GFLOP of f32 work (~48 us at 67 TFLOP/s): it is bound by bytes.  The
// design therefore reads each K/V tile from HBM once per 64 query rows
// and keeps scores, probabilities and the running accumulator on chip.
//
// Design.  The TPU grid (B, H, Sq/BQ, Sk/BK) carries m / l / acc in VMEM
// scratch across the sequential KV axis; here the KV loop runs inside the
// block.  One block = 64 query rows of one (b, h), 4 warps of 16 rows.
// Per KV tile of 32 keys (staged in shared memory as f32), lane j scores
// key j of the tile for the warp's current row, the warp reduces max and
// sum with shuffles, and lanes own hd/32 output columns of the row's
// accumulator, which lives in shared memory between tiles.  The KV range
// is cut to the tiles the causal / window masks leave alive.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 32;      // keys per tile, one per lane
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  return BQ * HD /*Qs*/ + BK * (HD + 1) /*Ks*/ + BK * HD /*Vs*/ + BQ * HD /*As*/ + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int DPL = (HD + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BQ][HD], pre-scaled
  float* Ks = Qs + BQ * HD;            // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* As = Vs + BK * HD;            // [BQ][HD] running accumulators
  float* Ms = As + BQ * HD;            // [BQ] running max
  float* Ls = Ms + BQ;                 // [BQ] running denominator
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KV / H;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    Qs[e] = qp < Sq ? to_f(q[(((size_t)b * Sq + qp) * H + h) * HD + d]) * scale : 0.f;
    As[e] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    Ms[r] = -CUDART_INF_F;
    Ls[r] = 0.f;
  }

  // key tiles the masks leave alive for rows [q0, q0 + BQ)
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  k_lo -= k_lo % BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD, d = e % HD, kp = k0 + j;
      const size_t src = (((size_t)b * Sk + kp) * KV + kvh) * HD + d;
      Ks[j * (HD + 1) + d] = kp < Sk ? to_f(k[src]) : 0.f;
      Vs[j * HD + d] = kp < Sk ? to_f(v[src]) : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < BQ / WARPS; ++rr) {
      const int r = warp * (BQ / WARPS) + rr, qp = q0 + r;
      if (qp >= Sq) break;                                  // warp-uniform
      const int kp = k0 + lane;
      float s = 0.f;
      const float* qrow = Qs + r * HD;
      const float* krow = Ks + lane * (HD + 1);
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], krow[d], s);
      const bool valid = kp < Sk && (!causal || kp <= qp) &&
                         (window <= 0 || qp - kp < window);
      s = valid ? s : -CUDART_INF_F;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = m_new == -CUDART_INF_F ? 0.f : expf(s - m_new);
      const float alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
      const float psum = warp_sum(p);
      float acc[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        acc[c] = d < HD ? As[r * HD + d] * alpha : 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) acc[c] = fmaf(pj, Vs[j * HD + d], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) As[r * HD + d] = acc[c];
      }
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = Ls[r];
    store(&o[(((size_t)b * Sq + qp) * H + h) * HD + d], l > 0.f ? As[e] / l : 0.f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KV, int causal, int window, float scale,
           cudaStream_t st) {
  static bool configured = false;
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int KV, int causal, int window,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k / v (B, Sk, KV, hd), o (B, Sq, H, hd), contiguous,
// f32 (bf16 == 0) or bf16; hd in {64, 80, 128}; window 0 = none.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int bf16, int B, int Sq, int Sk, int H, int KV,
                           int hd, int causal, int window, float scale,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
  return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
}

}  // extern "C"
