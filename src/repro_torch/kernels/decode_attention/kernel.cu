// One-token decode attention over a KV cache for Hopper (sm_90a),
// split over the cache ("flash-decoding").
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
// What bounds it on an H100: bytes, and at serving sizes latency.  A step
// reads the valid part of the cache once (B x min(pos + 1, S) x KV x hd x
// 2 x 2 bytes in bf16: 3.8 MB for 4 slots at positions 100, 511, 7 and
// 300, 8 KV heads, hd 128, 1.1 us at 3.35 TB/s) and does 4 flops per cached
// element, far below the card's ~295 flops per byte.  So few bytes spread
// over few blocks: the time is DRAM latency times the number of dependent
// load rounds, plus the launches.  The TPU kernel walks block_k = 512 rows
// a grid step in order, which on Hopper leaves one block per (KV head,
// slot), 32 blocks for 132 SMs at that shape, each walking its rows in
// dependent rounds.
//
// Design.  Two kernels, launched back to back by one wrapper call.
//   split   grid (n_split, KV, B), 128 threads.  Block (j, kvh, b) owns
//           cache rows [j SPLIT, (j + 1) SPLIT) of one KV head for all G
//           query heads, so each K/V row is read once for the group.  A
//           span past the slot's valid prefix [0, min(pos + 1, S)) (in
//           both modes the valid slots form that prefix) writes an empty
//           partial (m = -inf, l = 0) and exits.  A live block issues every
//           16-byte cp.async of its span's K rows, then of its V rows
//           (neighbouring lanes on neighbouring 16 bytes of one row; K and
//           V kept in their stored dtype in shared memory, K rows padded by
//           16 bytes so the per-row reads below are free of bank
//           conflicts), so all of a block's loads are in flight at once;
//           it scores while V is still landing.  Scores: thread = (row,
//           head), f32 dot products from 16-byte shared reads against the
//           pre-scaled f32 query (a broadcast); the mask is the formula
//           above, applied by select, never by multiply.  One warp per head
//           takes the span's max m and sum l; P.V: thread = (head, 4
//           columns), over the span's live rows.  The partial (m, l,
//           unnormalised acc[hd]) goes to f32 scratch.
//   combine grid (H, B), one thread per column: merges the n_split
//           partials of each (b, h) in split order with the log-sum-exp
//           rule, skipping empty ones (select, never multiply), and writes
//           o in q's dtype, 0 where every split was empty.
// Deterministic: no atomics, every sum in a fixed order.
//
// ptxas -v (sm_90a): split 32-47 registers, combine 32, no spills; dynamic
// shared memory SPLIT (2 hd esz + 16) + 16 hd 4 + 16 SPLIT 4 bytes, 45 KB
// at bf16, hd 128.  Head dims 64, 80, 112 and 128 (a row is a whole
// number of 16-byte chunks and of 4-column chunks at each).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "../attention_common.cuh"

namespace {

constexpr int NT = 128;        // threads of a split block
constexpr int GMAX = 16;       // query heads per KV head
// cache rows a split block owns: spans of 128 timed within the spread of
// 64 at the serving shapes on the H100, and 64 gives twice the blocks
constexpr int SPLIT = 64;

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

// shared-memory layout of a split block, in bytes
template <typename T, int HD>
struct Smem {
  static constexpr int ROW = HD * (int)sizeof(T);   // one cached row
  static constexpr int KROW = ROW + 16;             // padded K row
  static constexpr int K = 0;
  static constexpr int V = K + SPLIT * KROW;
  static constexpr int Q = V + SPLIT * ROW;         // [GMAX][HD] f32
  static constexpr int P = Q + GMAX * HD * 4;       // [GMAX][SPLIT] f32
  static constexpr int BYTES = P + GMAX * SPLIT * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ pos,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int KV, int G, int ring, float scale) {
  using L = Smem<T, HD>;
  constexpr int CH = L::ROW / 16;                   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, H = KV * G;
  const int p = pos[b];
  const int n_live = max(0, min(p + 1, S));
  const int s0 = split * SPLIT;
  // partial (b, h, split): acc at ((b H + h) n_split + split) HD, m and l
  // at 2 ((b H + h) n_split + split)
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  if (s0 >= n_live) {
    for (int g = tid; g < G; g += NT) {
      const size_t o = ((head0 + g) * n_split + split) * 2;
      part_ml[o] = -CUDART_INF_F;
      part_ml[o + 1] = 0.f;
    }
    return;
  }
  const int rows = min(SPLIT, n_live - s0);

  // every load of the span in flight: K rows, then V rows
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(ck);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(cv);
  for (int e = tid; e < rows * CH; e += NT) {
    const int r = e / CH, c = e - r * CH;
    const size_t src = ((((size_t)b * S + s0 + r) * KV + kvh) * HD) * sizeof(T) + c * 16;
    cp_async16(smem + L::K + r * L::KROW + c * 16, kbase + src);
  }
  cp_async_commit();
  for (int e = tid; e < rows * CH; e += NT) {
    const int r = e / CH, c = e - r * CH;
    const size_t src = ((((size_t)b * S + s0 + r) * KV + kvh) * HD) * sizeof(T) + c * 16;
    cp_async16(smem + L::V + r * L::ROW + c * 16, vbase + src);
  }
  cp_async_commit();

  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  for (int e = tid; e < G * HD; e += NT)
    Qs[e] = to_f(q[head0 * HD + e]) * scale;
  cp_async_wait<1>();                                // K has landed
  __syncthreads();

  // scores: thread = (row r, heads g = g0, g0 + NT / SPLIT, ...)
  constexpr int GSTEP = NT / SPLIT > 0 ? NT / SPLIT : 1;
  for (int item = tid; item < SPLIT * GSTEP; item += NT) {
    const int r = item % SPLIT;
    const int s = s0 + r;
    bool valid = r < rows;
    if (ring) {
      int rr = (p - s) % S;                          // C++ % truncates:
      if (rr < 0) rr += S;                           // make it a floor mod
      valid = valid && p - rr >= 0;
    } else {
      valid = valid && s <= p;
    }
    for (int g = item / SPLIT; g < G; g += GSTEP) {
      float sc = -CUDART_INF_F;
      if (valid) {
        const unsigned char* krow = smem + L::K + r * L::KROW;
        const float* qrow = Qs + g * HD;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float kx[Vec16<T>::N];
          Vec16<T>::load(krow + c * 16, kx);
#pragma unroll
          for (int i = 0; i < Vec16<T>::N; i += 4) {
            float qx[4];
            load4(qrow + c * Vec16<T>::N + i, qx);
            acc = fmaf(qx[0], kx[i], acc);
            acc = fmaf(qx[1], kx[i + 1], acc);
            acc = fmaf(qx[2], kx[i + 2], acc);
            acc = fmaf(qx[3], kx[i + 3], acc);
          }
        }
        sc = acc;
      }
      Ps[g * SPLIT + r] = sc;
    }
  }
  __syncthreads();

  // softmax over the span: one warp per head; row s0 is valid, so m is finite
  for (int g = warp; g < G; g += NT / 32) {
    float mx = -CUDART_INF_F;
    for (int r = lane; r < SPLIT; r += 32) mx = fmaxf(mx, Ps[g * SPLIT + r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < SPLIT; r += 32) {
      const float sc = Ps[g * SPLIT + r];
      const float pr = sc == -CUDART_INF_F ? 0.f : expf(sc - mx);
      Ps[g * SPLIT + r] = pr;
      sum += pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const size_t o = ((head0 + g) * n_split + split) * 2;
      part_ml[o] = mx;
      part_ml[o + 1] = sum;
    }
  }
  cp_async_wait<0>();                                // V has landed
  __syncthreads();

  // P.V: thread = (head g, columns 4 c .. 4 c + 3), over the live rows
  constexpr int C4 = HD / 4;
  const T* Vs = reinterpret_cast<const T*>(smem + L::V);
  for (int item = tid; item < G * C4; item += NT) {
    const int g = item / C4, c = item - g * C4;
    const float* prow = Ps + g * SPLIT;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      float vx[4];
      load4(Vs + r * HD + 4 * c, vx);
      const float pr = prow[r];
      a0 = fmaf(pr, vx[0], a0);
      a1 = fmaf(pr, vx[1], a1);
      a2 = fmaf(pr, vx[2], a2);
      a3 = fmaf(pr, vx[3], a3);
    }
    float4* dst = reinterpret_cast<float4*>(
        part_acc + ((head0 + g) * n_split + split) * HD + 4 * c);
    *dst = make_float4(a0, a1, a2, a3);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const size_t bh = (size_t)b * H + h;
  const float* ml = part_ml + bh * n_split * 2;
  float mx = -CUDART_INF_F;
  for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, ml[2 * j]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float acc = 0.f, l = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float m = ml[2 * j];
      if (m == -CUDART_INF_F) continue;              // empty split
      const float w = expf(m - mx);
      l = fmaf(w, ml[2 * j + 1], l);
      acc = fmaf(w, part_acc[(bh * n_split + j) * HD + d], acc);
    }
    store(&o[bh * HD + d], l > 0.f ? acc / l : 0.f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const int* pos,
           void* o, float* part, int B, int S, int KV, int G, int ring,
           float scale, cudaStream_t st) {
  constexpr int smem = Smem<T, HD>::BYTES;
  // the attribute is per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int n_split = (S + SPLIT - 1) / SPLIT, H = KV * G;
  float* part_acc = part;
  float* part_ml = part + (size_t)B * H * n_split * HD;
  decode_split_kernel<T, HD><<<dim3(n_split, KV, B), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), pos, part_acc, part_ml, S, KV, G, ring,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T, HD><<<dim3(H, B), HD < 128 ? HD : 128, 0, st>>>(
      part_acc, part_ml, static_cast<T*>(o), n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* ck, const void* cv,
                const int* pos, void* o, float* part, int B, int S, int KV,
                int G, int ring, float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, ck, cv, pos, o, part, B, S, KV, G, ring, scale, st);
    case 80: return launch<T, 80>(q, ck, cv, pos, o, part, B, S, KV, G, ring, scale, st);
    case 112: return launch<T, 112>(q, ck, cv, pos, o, part, B, S, KV, G, ring, scale, st);
    case 128: return launch<T, 128>(q, ck, cv, pos, o, part, B, S, KV, G, ring, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, hd) with H = KV * G; cache_k / cache_v (B, S, KV, hd), 16-byte
// aligned; pos (B,) int32; o (B, H, hd).  f32 (bf16 == 0) or bf16; hd in
// {64, 80, 112, 128}; part f32 scratch of B H n_split (hd + 2) floats,
// n_split = ceil(S / 64).
int decode_attention_launch(const void* q, const void* ck, const void* cv,
                            const void* pos, void* o, void* part, int bf16,
                            int B, int S, int KV, int G, int hd, int ring,
                            float scale, void* stream) {
  if (G < 1 || G > GMAX || B < 1 || S < 1 || KV < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const int*>(pos);
  auto pt = static_cast<float*>(part);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, ck, cv, pp, o, pt, B, S, KV, G, ring, scale, st);
  return dispatch_hd<float>(hd, q, ck, cv, pp, o, pt, B, S, KV, G, ring, scale, st);
}

}  // extern "C"
