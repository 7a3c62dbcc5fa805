// Backward of the forward attention kernel (kernel.cu) for Hopper (sm_90a):
// dQ, dK and dV of causal, windowed or full GQA attention, f32 or bf16
// inputs, f32 accumulation.
//
// The gradient of src/repro/kernels/flash_attention/kernel.py:90
// `flash_attention_pallas`.  The reference has no Pallas backward: its
// trainer differentiates the jnp `attend_ref` (src/repro/models/
// attention.py:66), so the function here is that gradient.  With scale
// c = 1/sqrt(hd), S = c Q K^T under the masks, P = softmax(S) row-wise,
// O = P V and the incoming dO:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D) with D = rowsum(dO o O),
//   dQ = c dS K,  dK = c dS^T Q,
// dK and dV summed over the G = H / KV query heads of a KV head.  P is
// never stored: the forward writes each row's log-sum-exp (natural log,
// f32, (B, H, Sq)) and P = exp(S - lse) is recomputed tile by tile.
//
// Design: three kernels, launched back to back by one wrapper call, with
// no atomics, so a training step is bitwise repeatable.
//   delta  one warp a (b, row, head): D = rowsum(dO o O) in f32, from the
//          forward's f32 O: D from a bf16-rounded O biases every dS of its
//          row, and moved bf16 dK up to 1.8x bf16's own rounding from the
//          f32 gradient on the H100 (the reference's trainer
//          differentiates through the f32 output).
//   dq     grid (Sq / 64, H, B), 256 threads: a block owns 64 query rows of
//          one head, loads Q and dO once, and walks the key tiles the
//          masks leave alive (those of the forward), recomputing S and dP
//          for the 64 x 64 tile, dS into shared memory, dQ += dS K in
//          registers.  The last query tiles (the most key tiles under a
//          causal mask) start first.
//   dkdv   grid (Sk / 64, KV, B), 256 threads: a block owns 64 keys of one
//          KV head, loads K and V once, and walks the live query tiles of
//          each of the G heads, P and dS into shared memory, dV += P^T dO
//          and dK += dS^T Q in registers.
// Tiles, thread grid and loads are the forward's (flash_common.cuh): 64 x
// 64 score tiles, thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 a and
// columns tx + 16 b of a score tile and 4-column chunks tx + 16 n of an
// output row; FMAs on f32 registers, masks select, never multiply.  The
// loads are not overlapped with compute (one buffer each): a simple,
// right kernel first.
//
// What bounds it on an H100: the products, 2 hd flops each a live (query,
// key) pair and head for S, dP, dV, dK and dQ (10 B H hd a pair; S and dP
// are computed twice, once by each of dq and dkdv), against the bytes of
// q, k, v, o, dO and lse read and dq, dk, dv written once.  At danube's
// training shape (B 2, S 4,096, H 32, KV 8, hd 80, bf16, causal) that is
// 4.3e11 flops against 0.13 GB: operations bound it, by far.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_common.cuh"

namespace {

constexpr int PLD = BK + 16;   // P / dS row stride, floats

template <typename T, int HD>
struct BwdLayout : TileRows<T, HD> {
  using R = TileRows<T, HD>;
  static constexpr int A = 0;                     // Q (dq) or K (dkdv)
  static constexpr int B = R::TILE;               // dO (dq) or V (dkdv)
  static constexpr int C = 2 * R::TILE;           // K (dq) or Q (dkdv)
  static constexpr int D = 3 * R::TILE;           // V (dq) or dO (dkdv)
  static constexpr int P = 4 * R::TILE;           // [64][PLD] f32: P (dkdv)
  static constexpr int DS = P + 64 * PLD * 4;     // [64][PLD] f32: dS
  static constexpr int ROWS = DS + 64 * PLD * 4;  // lse2[64], D[64] f32
  static constexpr int BYTES = ROWS + 2 * 64 * 4;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int Sq, int H, long rows) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* orow = o + r * HD;
  const T* grow = dO + r * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s = fmaf(to_f(orow[d]), to_f(grow[d]), s);
  s = warp_sum(s);
  // row r of (B, Sq, H) -> (B, H, Sq)
  const int h = (int)(r % H);
  const long bi = r / H;
  const int i = (int)(bi % Sq);
  const long b = bi / Sq;
  if (lane == 0) delta[(b * H + h) * Sq + i] = s;
}

// s[a][bb] = rows ty + 16 a of X (tile at X) . rows tx + 16 bb of Y
template <typename T, int HD>
__device__ __forceinline__ void dots(const unsigned char* X,
                                     const unsigned char* Y, int ty, int tx,
                                     float (&s)[4][4]) {
  using L = TileRows<T, HD>;
  constexpr int VE = L::VE;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 1
  for (int c = 0; c < L::CH; ++c) {
    float yx[4][VE];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      Vec16<T>::load(Y + (tx + 16 * bb) * L::LD + c * 16, yx[bb]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float xx[VE];
      Vec16<T>::load(X + (ty + 16 * a) * L::LD + c * 16, xx);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int e = 0; e < VE; ++e) s[a][bb] = fmaf(xx[e], yx[bb][e], s[a][bb]);
    }
  }
}

__device__ __forceinline__ bool live(int i, int j, int Sq, int Sk, int causal,
                                     int window) {
  return i < Sq && j < Sk && (!causal || j <= i) &&
         (window <= 0 || i - j < window);
}

// the 64 query rows' lse (as log2) and D into shared memory
__device__ __forceinline__ void load_rows(float* rows, const float* lse,
                                          const float* delta, size_t bh,
                                          int q0, int Sq, int tid) {
  if (tid < 64) {
    const int i = q0 + tid;
    rows[tid] = i < Sq ? lse[bh * Sq + i] * LOG2E : CUDART_INF_F;
    rows[64 + tid] = i < Sq ? delta[bh * Sq + i] : 0.f;
  }
}

// P (into s) and dS of one 64 x 64 tile: p = exp2(s scale2 - lse2) where
// live, ds = p (dp - D)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* rows, int ty, int tx,
                                      int q0, int k0, int Sq, int Sk,
                                      int causal, int window, float scale2) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l2 = rows[r], D = rows[64 + r];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const bool ok = live(q0 + r, k0 + tx + 16 * bb, Sq, Sk, causal, window);
      const float p = ok ? exp2f(s[a][bb] * scale2 - l2) : 0.f;
      s[a][bb] = p;
      dp[a][bb] = p * (dp[a][bb] - D);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int causal, int window,
                    float scale2, float scale) {
  using L = BwdLayout<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y,
            b = blockIdx.z;
  const int kvh = h * KV / H;
  const size_t bh = (size_t)b * H + h;
  unsigned char *Qs = smem + L::A, *dOs = smem + L::B;
  unsigned char *Ks = smem + L::C, *Vs = smem + L::D;
  float* dSs = reinterpret_cast<float*>(smem + L::DS);
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  k_lo -= k_lo % BK;

  float acc[4][L::NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < L::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  load_tile<T, HD>(Qs, q, b, q0, Sq, H, h, tid);
  load_tile<T, HD>(dOs, dO, b, q0, Sq, H, h, tid);
  cp_async_commit();
  load_rows(rows, lse, delta, bh, q0, Sq, tid);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    load_tile<T, HD>(Ks, k, b, k0, Sk, KV, kvh, tid);
    load_tile<T, HD>(Vs, v, b, k0, Sk, KV, kvh, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<T, HD>(Qs, Ks, ty, tx, s);
    dots<T, HD>(dOs, Vs, ty, tx, dp);
    probs(s, dp, rows, ty, tx, q0, k0, Sq, Sk, causal, window, scale2);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        dSs[(ty + 16 * a) * PLD + tx + 16 * bb] = dp[a][bb];
    __syncthreads();
    // dQ rows ty + 16 a += dS[row] . K, columns 4 (tx + 16 n) .. + 3
    const T* Kt = reinterpret_cast<const T*>(Ks);
#pragma unroll 1
    for (int j = 0; j < BK; j += 4) {
      float ds[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) load4(dSs + (ty + 16 * a) * PLD + j, ds[a]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < L::NC; ++n) {
          const int cc = tx + 16 * n;
          if (cc >= L::C4) continue;
          float kx[4];
          load4(Kt + (size_t)(j + jj) * (L::LD / (int)sizeof(T)) + 4 * cc, kx);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[a][n][e] = fmaf(ds[a][jj], kx[e], acc[a][n][e]);
        }
      }
    }
    __syncthreads();             // K, V and dS are rewritten next tile
  }
  cp_async_wait<0>();            // no copy may outlive the block (no key tile)

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    T* row = dq + (((size_t)b * Sq + i) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < L::NC; ++n) {
      const int cc = tx + 16 * n;
      if (cc >= L::C4) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[a][n][e] * scale;
      store4(row + 4 * cc, x);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      int causal, int window, float scale2, float scale) {
  using L = BwdLayout<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  unsigned char *Ks = smem + L::A, *Vs = smem + L::B;
  unsigned char *Qs = smem + L::C, *dOs = smem + L::D;
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* dSs = reinterpret_cast<float*>(smem + L::DS);
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);

  // query rows the masks leave alive for keys [k0, k0 + BK)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;

  // rows ty + 16 a of this key tile, columns 4 (tx + 16 n) .. + 3
  float gk[4][L::NC][4], gv[4][L::NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < L::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[a][n][e] = gv[a][n][e] = 0.f;

  load_tile<T, HD>(Ks, k, b, k0, Sk, KV, kvh, tid);
  load_tile<T, HD>(Vs, v, b, k0, Sk, KV, kvh, tid);
  cp_async_commit();
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = (size_t)b * H + h;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      load_tile<T, HD>(Qs, q, b, q0, Sq, H, h, tid);
      load_tile<T, HD>(dOs, dO, b, q0, Sq, H, h, tid);
      load_rows(rows, lse, delta, bh, q0, Sq, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[4][4], dp[4][4];
      dots<T, HD>(Qs, Ks, ty, tx, s);
      dots<T, HD>(dOs, Vs, ty, tx, dp);
      probs(s, dp, rows, ty, tx, q0, k0, Sq, Sk, causal, window, scale2);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          Ps[(ty + 16 * a) * PLD + tx + 16 * bb] = s[a][bb];
          dSs[(ty + 16 * a) * PLD + tx + 16 * bb] = dp[a][bb];
        }
      __syncthreads();
      // key rows ty + 16 a: dV += P[i][key] dO[i], dK += dS[i][key] Q[i]
      const T* Qt = reinterpret_cast<const T*>(Qs);
      const T* Gt = reinterpret_cast<const T*>(dOs);
      constexpr int LDE = L::LD / (int)sizeof(T);
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = Ps[i * PLD + ty + 16 * a];
          dsv[a] = dSs[i * PLD + ty + 16 * a];
        }
#pragma unroll
        for (int n = 0; n < L::NC; ++n) {
          const int cc = tx + 16 * n;
          if (cc >= L::C4) continue;
          float gx[4], qx[4];
          load4(Gt + (size_t)i * LDE + 4 * cc, gx);
          load4(Qt + (size_t)i * LDE + 4 * cc, qx);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              gv[a][n][e] = fmaf(pv[a], gx[e], gv[a][n][e]);
              gk[a][n][e] = fmaf(dsv[a], qx[e], gk[a][n][e]);
            }
        }
      }
      __syncthreads();           // Q, dO, P and dS are rewritten next tile
    }
  }
  cp_async_wait<0>();            // no copy may outlive the block

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Sk) continue;
    const size_t off = (((size_t)b * Sk + j) * KV + kvh) * HD;
#pragma unroll
    for (int n = 0; n < L::NC; ++n) {
      const int cc = tx + 16 * n;
      if (cc >= L::C4) continue;
      float xk[4], xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xk[e] = gk[a][n][e] * scale;
        xv[e] = gv[a][n][e];
      }
      store4(dk + off + 4 * cc, xk);
      store4(dv + off + 4 * cc, xv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const float* o,
           const float* lse, const void* dO, void* dq, void* dk, void* dv,
           float* delta, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t st) {
  using L = BwdLayout<T, HD>;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(dO);
  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows * 32 + 255) / 256), 256, 0,
                                  st>>>(o, tg, delta,
                                        Sq, H, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the attribute is per device, so it is set on every launch
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const float scale2 = scale * LOG2E;
  flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BQ - 1) / BQ, H, B), NT, L::BYTES,
                               st>>>(tq, tk, tv, tg, lse, delta,
                                     static_cast<T*>(dq), Sq, Sk, H, KV,
                                     causal, window, scale2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((Sk + BK - 1) / BK, KV, B), NT,
                                 L::BYTES, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, causal, window, scale2, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const float* o, const float* lse, const void* dO, void* dq,
                void* dk, void* dv, float* delta, int B, int Sq, int Sk,
                int H, int KV, int causal, int window, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 112: return launch<T, 112>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, Sq, Sk, H, KV, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q / dO / dq (B, Sq, H, hd), k / v / dk / dv (B, Sk, KV, hd), contiguous
// and 16-byte aligned, f32 (bf16 == 0) or bf16; o (B, Sq, H, hd) and lse
// (B, H, Sq) f32 from the forward (o before its rounding to bf16); delta f32 scratch of B H Sq floats; hd in {64, 80,
// 112, 128}; window 0 = none.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* lse, const void* dO,
                               void* dq, void* dk, void* dv, void* delta,
                               int bf16, int B, int Sq, int Sk, int H, int KV,
                               int hd, int causal, int window, float scale,
                               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<const float*>(lse);
  auto of = static_cast<const float*>(o);
  auto dl = static_cast<float*>(delta);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, of, ls, dO, dq, dk, dv, dl, B, Sq, Sk, H, KV, causal, window, scale, st);
  return dispatch_hd<float>(hd, q, k, v, of, ls, dO, dq, dk, dv, dl, B, Sq, Sk, H, KV, causal, window, scale, st);
}

}  // extern "C"
