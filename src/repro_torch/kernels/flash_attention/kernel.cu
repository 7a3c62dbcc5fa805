// Forward attention for Hopper (sm_90a): online softmax in f32, GQA,
// causal and sliding-window masks, with dead key tiles and dead 16 x 16
// sub-blocks of a tile skipped.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:90
// `flash_attention_pallas` (`_flash_kernel` :25).  Same function: scale
// 1/sqrt(hd), query head h reads KV head h * KV / H, causal mask
// qpos >= kpos, window mask qpos - kpos < window, output in q's dtype.
// Layout is the model's (B, S, heads, hd), contiguous, so no transposes.
//
// What bounds it on an H100: at the query encoder's shape (B = 1024
// texts, S = 64, H = KV = 12, hd = 64, f32, causal) the kernel moves q, k,
// v and o once (4 x 201 MB: 0.240 ms at 3.35 TB/s) against 6.5 GFLOP of
// f32 work, counted as 4 B H hd per live (query, key) pair (2,080 pairs a
// head: 0.098 ms at 67 TFLOP/s): bytes bound it.  The f32 tolerance
// (2e-5 against the f32 plain version) keeps the work on the FMA units,
// not TF32 tensor cores, where shared-memory reads, the softmax and the
// masks take issue slots beside the FMAs; so the design's aims are many
// FMAs per shared-memory read and loads in flight while blocks compute.
//
// Design.  The TPU grid (B, H, Sq/BQ, Sk/BK) carries m / l / acc in VMEM
// scratch across the sequential KV axis; here the KV loop runs inside the
// block.  One block = 64 query rows of one (b, h), 256 threads.  Q and
// each 64-key K/V tile arrive by 16-byte cp.async copies (rows padded by
// 16 bytes in shared memory, stored dtype kept, converted at use), K/V
// double-buffered across tiles where Sk > 64, so the next tile's loads fly
// while this one computes.  Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4
// register micro-tile of the 64 x 64 score block, rows ty + 16 a and keys
// tx + 16 b: each 16-byte read of a Q row and of a K row feeds 4 x 4 x
// (4 or 8) FMAs, and the K rows a quarter-warp reads start 16 bytes apart
// in the bank space, so the reads are free of conflicts.  The (a, b) entry
// of every thread's micro-tile lies in the same 16 x 16 sub-block, so a
// sub-block wholly above the causal diagonal (the diagonal tile) or wholly
// outside a window whose width is a multiple of 64 (the window's first
// tile) is skipped by every thread at compile time.  Row max and sum are
// half-warp shuffles (a row's 16 threads are one half-warp); P goes to
// shared memory only for the same half-warp to read back, and P.V runs
// over the same rows with 4-column chunks per thread, the accumulator in
// registers across all key tiles.  Masks select, never multiply.  For the
// backward (bwd_kernel.cu) the block also writes each row's log-sum-exp
// and, for bf16, the output in f32 before its rounding.
//
// ptxas -v (sm_90a): f32 hd 64 80 registers (capped for three blocks an
// SM; the rolled loops below keep it free of spills), the other seven
// instantiations 123-128 (at most two blocks an SM), no spills.  Dynamic
// shared memory 71 KB at f32 hd 64 with one key tile (Q, P, K, V), 105 KB
// double-buffered; 185 KB at f32 hd 128, 163 KB at f32 hd 112 (hd 112 =
// 7 x 16: a 448-byte row is 28 16-byte chunks, 28 4-column chunks, so the
// second chunk of a thread's columns is live for tx < 12).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_common.cuh"

namespace {

constexpr int PLD = BK + 16; // P row stride, floats (two half-warps: banks apart)

enum Mode { FULL = 0, LOWER = 1, UPPER = 2 };

// sub-block (a, b) of a tile may hold a live pair
template <int MODE>
__device__ __forceinline__ constexpr bool sub_live(int a, int b) {
  return MODE == FULL || (MODE == LOWER ? b <= a : b >= a);
}

template <typename T, int HD>
struct Layout : TileRows<T, HD> {
  using R = TileRows<T, HD>;
  static constexpr int Q = 0;
  static constexpr int P = BQ * R::LD;               // [BQ][PLD] f32
  static constexpr int KV0 = P + BQ * PLD * 4;       // nbuf x (K, V)
  static int bytes(int nbuf) { return KV0 + nbuf * 2 * R::TILE; }
};

// One 64 x 64 tile: scores, online softmax update, P.V into acc.
template <typename T, int HD, int MODE>
__device__ __forceinline__ void tile_step(
    const unsigned char* Qs, const unsigned char* Ks, const T* Vs, float* Ps,
    int ty, int tx, int q0, int k0, int Sq, int Sk, int causal, int window,
    float scale2, float (&m)[4], float (&l)[4],
    float (&acc)[4][Layout<T, HD>::NC][4]) {
  using L = Layout<T, HD>;
  constexpr int VE = L::VE;
  float s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 1
  for (int c = 0; c < L::CH; ++c) {
    float kx[4][VE];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      Vec16<T>::load(Ks + (tx + 16 * bb) * L::LD + c * 16, kx[bb]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float qx[VE];
      Vec16<T>::load(Qs + (ty + 16 * a) * L::LD + c * 16, qx);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (!sub_live<MODE>(a, bb)) continue;
#pragma unroll
        for (int e = 0; e < VE; ++e) s[a][bb] = fmaf(qx[e], kx[bb][e], s[a][bb]);
      }
    }
  }


  // mask (select), online softmax in the log2 domain
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int j = k0 + tx + 16 * bb;
      const bool ok = sub_live<MODE>(a, bb) && i < Sq && j < Sk &&
                      (!causal || j <= i) && (window <= 0 || i - j < window);
      s[a][bb] = ok ? s[a][bb] * scale2 : -CUDART_INF_F;
      mx = fmaxf(mx, s[a][bb]);
    }
    mx = half_warp_max<16>(mx);
    const float m_new = fmaxf(m[a], mx);
    const float alpha = m[a] == -CUDART_INF_F ? 0.f : exp2f(m[a] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const float pr = s[a][bb] == -CUDART_INF_F ? 0.f : exp2f(s[a][bb] - m_new);
      Ps[(ty + 16 * a) * PLD + tx + 16 * bb] = pr;
      sum += pr;
    }
    l[a] = l[a] * alpha + half_warp_sum<16>(sum);
    m[a] = m_new;
#pragma unroll
    for (int n = 0; n < L::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] *= alpha;
  }
  __syncwarp();     // the rows of P this half-warp wrote, read back below

  // P.V: rows ty + 16 a, columns 4 (tx + 16 n) .. + 3
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
#pragma unroll 1
    for (int j4 = 0; j4 < 16; j4 += 4) {
      const int j = 16 * jb + j4;
      float pv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (sub_live<MODE>(a, jb)) load4(Ps + (ty + 16 * a) * PLD + j, pv[a]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < L::NC; ++n) {
          const int cc = tx + 16 * n;
          if (cc >= L::C4) continue;
          float vx[4];
          load4(Vs + (size_t)(j + jj) * (L::LD / (int)sizeof(T)) + 4 * cc, vx);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            if (!sub_live<MODE>(a, jb)) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[a][n][e] = fmaf(pv[a][jj], vx[e], acc[a][n][e]);
          }
        }
      }
    }
  }
  __syncwarp();     // P is rewritten by the next tile
}

template <typename T, int HD>
constexpr int min_blocks() { return HD == 64 && sizeof(T) == 4 ? 3 : 2; }

template <typename T, int HD>
__global__ void __launch_bounds__(NT, (min_blocks<T, HD>()))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ o32, int Sq,
                 int Sk, int H, int KV, int causal, int window,
                 float scale2) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KV / H;
  unsigned char* Qs = smem + L::Q;
  float* Ps = reinterpret_cast<float*>(smem + L::P);

  // key tiles the masks leave alive for rows [q0, q0 + BQ)
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  k_lo -= k_lo % BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  float m[4], l[4], acc[4][L::NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < L::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  }

  load_tile<T, HD>(Qs, q, b, q0, Sq, H, h, tid);
  if (ntiles > 0) {
    unsigned char* kv = smem + L::KV0;
    load_tile<T, HD>(kv, k, b, k_lo, Sk, KV, kvh, tid);
    load_tile<T, HD>(kv + L::TILE, v, b, k_lo, Sk, KV, kvh, tid);
  }
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * BK;
    if (t + 1 < ntiles) {        // nbuf == 2 whenever Sk > BK
      unsigned char* kv = smem + L::KV0 + ((t + 1) % 2) * 2 * L::TILE;
      load_tile<T, HD>(kv, k, b, k0 + BK, Sk, KV, kvh, tid);
      load_tile<T, HD>(kv + L::TILE, v, b, k0 + BK, Sk, KV, kvh, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* Ks = smem + L::KV0 + (t % 2) * 2 * L::TILE;
    const T* Vs = reinterpret_cast<const T*>(Ks + L::TILE);
    if (causal && k0 == q0)
      tile_step<T, HD, LOWER>(Qs, Ks, Vs, Ps, ty, tx, q0, k0, Sq, Sk,
                              causal, window, scale2, m, l, acc);
    else if (window > 0 && window % BK == 0 && q0 - k0 == window)
      tile_step<T, HD, UPPER>(Qs, Ks, Vs, Ps, ty, tx, q0, k0, Sq, Sk,
                              causal, window, scale2, m, l, acc);
    else
      tile_step<T, HD, FULL>(Qs, Ks, Vs, Ps, ty, tx, q0, k0, Sq, Sk,
                             causal, window, scale2, m, l, acc);
    __syncthreads();             // the buffer is refilled two tiles on
  }
  cp_async_wait<0>();            // no copy may outlive the block

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
    // natural-log log-sum-exp of the row's scaled scores; +inf for a row
    // with no live key, so the backward's recomputed P is 0 there
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + i] =
          l[a] > 0.f ? (m[a] + log2f(l[a])) * LN2 : CUDART_INF_F;
    const size_t row = (((size_t)b * Sq + i) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < L::NC; ++n) {
      const int cc = tx + 16 * n;
      if (cc >= L::C4) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[a][n][e] * inv;
      store4(o + row + 4 * cc, x);
      if (o32 != nullptr) store4(o32 + row + 4 * cc, x);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* o32, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t st) {
  using L = Layout<T, HD>;
  // the attribute is per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(2));
  if (e != cudaSuccess) return (int)e;
  // one K/V buffer where one tile covers every key, two to overlap tiles
  const int nbuf = Sk > BK ? 2 : 1;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, L::bytes(nbuf), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, o32, Sq, Sk, H,
      KV, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, float* o32, int B, int Sq, int Sk, int H, int KV,
                int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 112: return launch<T, 112>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k / v (B, Sk, KV, hd), o (B, Sq, H, hd), contiguous and
// 16-byte aligned, f32 (bf16 == 0) or bf16; hd in {64, 80, 112, 128};
// window 0 = none.  For the backward (bwd_kernel.cu), when not null: lse
// receives each row's natural-log log-sum-exp, f32 (B, H, Sq), and o32 the
// output in f32 (B, Sq, H, hd), before its rounding to bf16.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           void* lse, void* o32, int bf16, int B, int Sq,
                           int Sk, int H, int KV, int hd, int causal,
                           int window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<float*>(lse);
  auto o4 = static_cast<float*>(o32);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, ls, o4, B, Sq, Sk, H, KV, causal, window, scale, st);
  return dispatch_hd<float>(hd, q, k, v, o, ls, o4, B, Sq, Sk, H, KV, causal, window, scale, st);
}

}  // extern "C"
