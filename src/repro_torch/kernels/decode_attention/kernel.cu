// One-token decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:63
// `decode_attention_pallas` (`_decode_kernel` :21).  Same function: all
// G = H / KV query heads of one KV head attend over the slot's cache with
// scale 1/sqrt(hd) and an online softmax in f32.  Cache slot s is valid
// when s <= pos, or, for a ring-buffer (sliding-window) cache of S slots,
// when pos - ((pos - s) mod S) >= 0 with a floor modulo.  A slot with no
// valid key outputs 0.  Unlike the TPU kernel, which takes one scalar
// position, this one takes the (B,) position vector the serving engine
// decodes with: every slot of a continuous batch sits at its own position.
//
// What bounds it on an H100: bytes.  Each step reads the valid part of the
// cache once (B x min(pos + 1, S) x KV x hd x 2 x 2 bytes in bf16, ~8 MB
// for 4 slots x 512 positions x 8 KV heads x hd 128) and does only
// 4 flops per cached element, far below the card's ~295 flops per byte.
// The design reads each K/V row once for all G query heads that share it
// (the GQA saving the TPU kernel makes too) and reads no slot past the
// valid prefix.
//
// Design.  One block per (KV head, slot), one warp per query head.  Tiles
// of 32 cache rows are staged in shared memory as f32; lane j scores row j
// of the tile for the warp's head, the warp reduces max and sum with
// shuffles, and each lane keeps hd/32 accumulator columns in registers.
// In both modes the valid slots form the prefix [0, min(pos + 1, S)), so
// tiles past it are never loaded; the per-slot mask is still the formula
// above.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int BK = 32;       // cache rows per tile, one per lane
constexpr int GMAX = 16;     // query heads per KV head (warps per block)

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
constexpr int smem_floats(int G) { return BK * (HD + 1) + BK * HD + G * HD; }

template <typename T, int HD>
__global__ void __launch_bounds__(32 * GMAX)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                        const T* __restrict__ cv, const int* __restrict__ pos,
                        T* __restrict__ o, int S, int KV, int G, int ring,
                        float scale) {
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Qs = Vs + BK * HD;            // [G][HD], pre-scaled
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int nthr = blockDim.x;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = KV * G;
  const int p = pos[b];

  for (int e = tid; e < G * HD; e += nthr) {
    const int gg = e / HD, d = e % HD;
    Qs[e] = to_f(q[((size_t)b * H + kvh * G + gg) * HD + d]) * scale;
  }
  float m = -CUDART_INF_F, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  const int n_live = max(0, min(p + 1, S));
  for (int k0 = 0; k0 < n_live; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * HD; e += nthr) {
      const int j = e / HD, d = e % HD, s = k0 + j;
      const size_t src = (((size_t)b * S + s) * KV + kvh) * HD + d;
      Ks[j * (HD + 1) + d] = s < S ? to_f(ck[src]) : 0.f;
      Vs[j * HD + d] = s < S ? to_f(cv[src]) : 0.f;
    }
    __syncthreads();
    const int s = k0 + lane;
    float sc = 0.f;
    const float* qrow = Qs + g * HD;
    const float* krow = Ks + lane * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) sc = fmaf(qrow[d], krow[d], sc);
    bool valid;
    if (ring) {
      int r = (p - s) % S;             // C++ % truncates: make it a floor mod
      if (r < 0) r += S;
      valid = s < S && p - r >= 0;
    } else {
      valid = s < S && s <= p;
    }
    sc = valid ? sc : -CUDART_INF_F;
    const float m_new = fmaxf(m, warp_max(sc));
    const float pr = m_new == -CUDART_INF_F ? 0.f : expf(sc - m_new);
    const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_new);
    l = l * alpha + warp_sum(pr);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) acc[c] = fmaf(pj, Vs[j * HD + d], acc[c]);
      }
    }
    m = m_new;
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < HD)
      store(&o[((size_t)b * H + kvh * G + g) * HD + d], l > 0.f ? acc[c] / l : 0.f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const int* pos,
           void* o, int B, int S, int KV, int G, int ring, float scale,
           cudaStream_t st) {
  const int smem = smem_floats<HD>(G) * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_floats<HD>(GMAX) * 4);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  decode_attention_kernel<T, HD><<<dim3(KV, B), 32 * G, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), pos, static_cast<T*>(o), S, KV, G, ring,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* ck, const void* cv,
                const int* pos, void* o, int B, int S, int KV, int G, int ring,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, ck, cv, pos, o, B, S, KV, G, ring, scale, st);
    case 80: return launch<T, 80>(q, ck, cv, pos, o, B, S, KV, G, ring, scale, st);
    case 128: return launch<T, 128>(q, ck, cv, pos, o, B, S, KV, G, ring, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, hd) with H = KV * G; cache_k / cache_v (B, S, KV, hd); pos (B,)
// int32; o (B, H, hd).  f32 (bf16 == 0) or bf16; hd in {64, 80, 128}.
int decode_attention_launch(const void* q, const void* ck, const void* cv,
                            const void* pos, void* o, int bf16, int B, int S,
                            int KV, int G, int hd, int ring, float scale,
                            void* stream) {
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const int*>(pos);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, ck, cv, pp, o, B, S, KV, G, ring, scale, st);
  return dispatch_hd<float>(hd, q, ck, cv, pp, o, B, S, KV, G, ring, scale, st);
}

}  // extern "C"
