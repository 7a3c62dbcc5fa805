// Backward of the forward attention kernel (kernel.cu) for Hopper (sm_90a):
// dQ, dK and dV of causal, windowed or full GQA attention, f32 or bf16
// inputs, products on the tensor cores, f32 accumulation.
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
// f32, (B, H, Sq)) and P = exp2(S log2(e) - lse log2(e)) is recomputed in
// f32 tile by tile, masks selecting, never multiplying.
//
// Launches, back to back on the caller's stream, no atomics (a second call
// gives the same bits):
//   delta  one warp a (b, row, head): D = rowsum(dO o O) in f32, from the
//          forward's f32 O: D from a bf16-rounded O biases every dS of its
//          row, and moved bf16 dK up to 1.8x bf16's own rounding from the
//          f32 gradient on the H100.
//   bwd    one launch of two kinds of 4-warp blocks, so that a small
//          problem runs both side by side and a large one fills the tail
//          of the long blocks with short ones:
//     dkdv (the first ceil(Sk / 64) KV splits B blocks, key tile slowest,
//          so the first key tiles, the longest under a causal mask, start
//          first): a block owns 64 keys of one KV head, a warp 16 of them;
//          K and V stay in shared memory while the live 64-row tiles of Q
//          and dO (with their rows' lse and D) of each query head of the
//          block stream through a two-stage cp.async ring (item i + 1's
//          copies in flight while item i is multiplied).  A warp forms
//          S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, then
//          dV += P^T dO and dK += dS^T Q.  Where ceil(Sk / 64) KV B is
//          under two blocks an SM, the wrapper splits the G query heads of
//          a KV head over `splits` blocks (heads [s G / splits, (s + 1) G
//          / splits) in block s), each writing its f32 dK / dV partial.
//     dq   (the rest, the last query tiles, with the most key tiles under
//          a causal mask, first): a block owns 64 query rows of one head,
//          a warp 16; Q and dO stay while the live key tiles of K and V
//          stream through the ring; S = Q K^T, dP = dO V^T, P and dS in
//          registers, dQ += dS K.
//   sum    (splits > 1 only) adds the partials in split order and writes dK
//          and dV.
//
// Products (the bf16 primitives in flash_mma.cuh, shared with the forward's
// bf16 kernel).  The five products are warp-level `mma.sync` tiles whose
// accumulator layout (C fragment of m16n8: rows g, g + 8, columns 2t, 2t + 1
// of each 8-column tile, g = lane / 4, t = lane % 4) is the layout the
// softmax recompute works in.  S, dP, S^T and dP^T multiply two tiles that
// both keep hd contiguous ("NT"); dQ, dV and dK multiply the warp's own
// P / dS accumulators (the A operand, straight from registers) by a tile
// read across its rows (the B operand).
//   bf16  m16n8k16 bf16 with f32 accumulators.  A and B come from the
//         padded tiles with `ldmatrix` (`.trans` for the B operand read
//         across rows; rows 16 bytes apart in the padding hit other banks,
//         so the eight rows of each 8 x 8 matrix read 32 distinct banks).
//         P and dS enter their products as two bf16 terms, hi = bf16(x)
//         and lo = bf16(x - hi), so each product is exact to ~2^-17 of x:
//         one bf16 rounding of P and dS (FlashAttention-2's) put the
//         gradient at 1.2-1.9x the bf16 limit (2^-8 |ref| + 2e-5, which
//         leaves bf16's own output rounding almost no room) in a plain
//         emulation of that rounding at S 130-2,048, G 4-12
//         (tests/test_torch_flash_bwd.py); the split keeps it at the f32
//         design's ratio.  Q, K, V and dO are bf16 already, so S and dP
//         are exact products summed in f32.
//   f32   m16n8k8 TF32 in three passes (big x small + small x big + big x
//         big, ../tf32_mma.cuh, as the SSD kernels do), which keeps about
//         2^-21 of each product.  The tf32 A layout is not the C
//         layout, so P and dS go through a per-warp f32 scratch tile.
//   Both: dQ, dV and dK add each k-step's product (16 rows in bf16, 8 in
//   f32) into the running sum as a fresh f32 sum with a rounded add.  The
//   tensor cores truncate the sums they form, and a relative bias of 1e-4
//   on dK / dV already crossed the bf16 limit at S 1,000, G 12 in the same
//   kind of emulation.
// mma.sync rather than wgmma: it keeps P and dS in the accumulator
// registers without a trip through shared memory and lets one B fragment
// feed both terms of the split; wgmma (64-row warpgroup tiles, descriptors
// over swizzled shared memory) is the route to SDPA's time and later work.
//
// MLA (DeepSeek-V2): q and k of 192 dims, v and dO of 128, bf16 only, at H
// = KV (one split): `flash_bwd_kernel<bf16, 192, 128>`, the same blocks with
// S^T / S over the 192 columns, dP^T / dP over 128, dV of 128 columns and
// dK / dQ of 192.  A dkdv warp holds 96 + 64 f32 accumulators of dK and dV
// beside S^T and dP^T's 64, so its K / V tiles stay resident but the ring
// streams one stage (BwdSmem), 87,040 B, two blocks an SM.
//
// What bounds it on an H100: operations.  Per live (query, key) pair and
// query head, S and dP in both passes and dQ, dV, dK, 2 hd flops each
// (14 B H hd a pair), plus the split's second terms of dQ, dV, dK (6 more):
// at danube's training shape (B 2, S 4,096, H 32, KV 8, hd 80, bf16,
// causal) ~8.6e11 flops against 0.13 GB of q, k, v, o, dO, lse read and dq,
// dk, dv written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "../tf32_mma.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int NW = 4;            // warps a block, 16 rows each
constexpr int NTH = 32 * NW;     // threads a block
constexpr int STAGES = 2;        // ring of streamed tiles
constexpr int SP = BK + 4;       // f32 scratch row stride, floats (4 mod 32)
static_assert(NTH == 2 * 64, "one thread a row's lse or D copy");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- mma

// acc += (a b) of one k-step in three TF32 passes, in a fresh f32 sum
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, ab, bs);
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bb);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += d[r];
}

// Warp products over the padded tiles of TileRows<T, HD>:
//   nt(acc, X, Y): acc (16 x 64) = rows [0, 16) of X . rows [0, 64) of Y,
//     both over their HD columns (X, Y tile pointers, X at the warp's row)
//   pa(out, p, Z, scr): out (16 x HD) += p (16 x 64, C fragments) . rows
//     [0, 64) of Z, in fresh sums a 16-row (bf16) or 8-row (f32) step
template <typename T, int HD>
struct Mma;

template <int HD>
struct Mma<__nv_bfloat16, HD> {
  using L = TileRows<__nv_bfloat16, HD>;
  static constexpr int SCRATCH = 0;   // bytes of f32 scratch a warp

  __device__ static void nt(float (&acc)[8][4], const unsigned char* X,
                            const unsigned char* Y) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, lr = lane & 7;
    zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      uint32_t a[4];
      ldsm4(a, X + (lr + 8 * (mi & 1)) * L::LD + (k0 + 8 * (mi >> 1)) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, Y + (16 * np + lr + 8 * (mi >> 1)) * L::LD +
                     (k0 + 8 * (mi & 1)) * 2);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ static void pa(float (&out)[HD / 8][4], const float (&p)[8][4],
                            const unsigned char* Z, float*) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the C fragments of columns 16 j .. 16 j + 15 are the A fragment of
      // the k-step over Z's rows 16 j .. 16 j + 15
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * j][0], p[2 * j][1], hi[0], lo[0]);
      split_bf16(p[2 * j][2], p[2 * j][3], hi[1], lo[1]);
      split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm4t(b, Z + (16 * j + lr + 8 * (mi & 1)) * L::LD +
                      (16 * np + 8 * (mi >> 1)) * 2);
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d0, lo, b[0], b[1]);
        mma_bf16(d0, hi, b[0], b[1]);
        mma_bf16(d1, lo, b[2], b[3]);
        mma_bf16(d1, hi, b[2], b[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          out[2 * np][r] += d0[r];
          out[2 * np + 1][r] += d1[r];
        }
      }
    }
  }
};

template <int HD>
struct Mma<float, HD> {
  using L = TileRows<float, HD>;
  static constexpr int P = L::LD / 4;          // tile row stride, floats
  static constexpr int SCRATCH = 16 * SP * 4;

  __device__ static void nt(float (&acc)[8][4], const unsigned char* Xb,
                            const unsigned char* Yb) {
    const float* X = reinterpret_cast<const float*>(Xb);
    const float* Y = reinterpret_cast<const float*>(Yb);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    zero(acc);
#pragma unroll 1
    for (int k0 = 0; k0 < HD; k0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(X[g * P + k0 + t], ab[0], as[0]);
      split_tf32(X[(g + 8) * P + k0 + t], ab[1], as[1]);
      split_tf32(X[g * P + k0 + t + 4], ab[2], as[2]);
      split_tf32(X[(g + 8) * P + k0 + t + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bb[2], bs[2];
        split_tf32(Y[(8 * n + g) * P + k0 + t], bb[0], bs[0]);
        split_tf32(Y[(8 * n + g) * P + k0 + t + 4], bb[1], bs[1]);
        mma3(acc[n], ab, as, bb, bs);
      }
    }
  }

  __device__ static void pa(float (&out)[HD / 8][4], const float (&p)[8][4],
                            const unsigned char* Zb, float* scr) {
    const float* Z = reinterpret_cast<const float*>(Zb);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    __syncwarp();                // the last product's reads of scr are done
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        scr[(g + 8 * (r >> 1)) * SP + 8 * n + 2 * t + (r & 1)] = p[n][r];
    __syncwarp();
#pragma unroll 1
    for (int k0 = 0; k0 < BK; k0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(scr[g * SP + k0 + t], ab[0], as[0]);
      split_tf32(scr[(g + 8) * SP + k0 + t], ab[1], as[1]);
      split_tf32(scr[g * SP + k0 + t + 4], ab[2], as[2]);
      split_tf32(scr[(g + 8) * SP + k0 + t + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bb[2], bs[2];
        split_tf32(Z[(k0 + t) * P + 8 * n + g], bb[0], bs[0]);
        split_tf32(Z[(k0 + t + 4) * P + 8 * n + g], bb[1], bs[1]);
        mma3(out[n], ab, as, bb, bs);
      }
    }
  }
};

// ---------------------------------------------------------------- kernels

// Shared memory of the dq and dkdv blocks at query / key head dim DK and
// value head dim DV: two fixed tiles (Q of DK, dO of DV or K of DK, V of
// DV), ST x two streamed tiles (K, V or Q, dO), ST x the streamed query
// rows' lse and D (dkdv), the warps' f32 scratch (f32 only).  ST: stages of
// the ring, two where DK = DV; MLA's pair (192, 128) streams one, since a
// block of two (130,048 B) would leave one block an SM, four warps, and one
// (87,040 B) lets two share it.
template <typename T, int DK, int DV>
struct BwdSmem {
  using R = TileRows<T, DK>;
  using RV = TileRows<T, DV>;
  static constexpr int ST = DK == DV ? STAGES : 1;
  static constexpr int PAIR = R::TILE + RV::TILE;
  static constexpr int RING = PAIR;
  static constexpr int ROWS = RING + ST * PAIR;
  static constexpr int SCR = ROWS + ST * 2 * 64 * 4;
  static constexpr int BYTES = SCR + NW * Mma<T, DK>::SCRATCH;
  __device__ static unsigned char* stage(unsigned char* smem, int s) {
    return smem + RING + s * PAIR;
  }
};

// every pair of query tile [q0, q0 + 64) and key tile [k0, k0 + 64) is live
__device__ __forceinline__ bool all_live(int q0, int k0, int Sq, int Sk,
                                         int causal, int window) {
  return q0 + BQ <= Sq && k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0) &&
         (window <= 0 || q0 + BQ - 1 - k0 < window);
}

template <typename T, int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int Sq, int H, long rows) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* orow = o + r * DV;
  const T* grow = dO + r * DV;
  float s = 0.f;
  for (int d = lane; d < DV; d += 32) s = fmaf(orow[d], to_f(grow[d]), s);
  s = warp_sum(s);
  // row r of (B, Sq, H) -> (B, H, Sq)
  const int h = (int)(r % H);
  const long bi = r / H;
  const int i = (int)(bi % Sq);
  const long b = bi / Sq;
  if (lane == 0) delta[(b * H + h) * Sq + i] = s;
}

// dQ of query rows [q0, q0 + 64) of head h, batch b
template <typename T, int DK, int DV>
__device__ __forceinline__ void dq_block(
    unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int h, int b, int q0, int Sq, int Sk, int H, int KV,
    int causal, int window, float scale2, float scale) {
  using L = BwdSmem<T, DK, DV>;
  using R = typename L::R;
  using RV = typename L::RV;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = h / (H / KV);
  const size_t bh = (size_t)b * H + h;
  unsigned char *Qs = smem, *dOs = smem + R::TILE;
  float* scr = reinterpret_cast<float*>(smem + L::SCR) + w * 16 * SP;

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  k_lo -= k_lo % BK;
  const int n = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // this thread's rows q0 + 16 w + g and + 8: lse as log2, and D
  float l2[2], dd[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + 16 * w + g + 8 * e;
    l2[e] = i < Sq ? lse[bh * Sq + i] * LOG2E : 0.f;
    dd[e] = i < Sq ? delta[bh * Sq + i] : 0.f;
  }

  float acc[DK / 8][4];
  zero(acc);

  auto issue = [&](int it, int st) {
    unsigned char* S = L::stage(smem, st);
    const int k0 = k_lo + it * BK;
    load_tile<T, DK, NTH>(S, k, b, k0, Sk, KV, kvh, tid);
    load_tile<T, DV, NTH>(S + R::TILE, v, b, k0, Sk, KV, kvh, tid);
  };
  load_tile<T, DK, NTH>(Qs, q, b, q0, Sq, H, h, tid);
  load_tile<T, DV, NTH>(dOs, dO, b, q0, Sq, H, h, tid);
  if (n > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    if constexpr (L::ST > 1) {
      if (it + 1 < n) issue(it + 1, (it + 1) % L::ST);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = k_lo + it * BK;
    const unsigned char* Ks = L::stage(smem, it % L::ST);
    const unsigned char* Vs = Ks + R::TILE;
    float s[8][4], dp[8][4];
    Mma<T, DK>::nt(s, Qs + 16 * w * R::LD, Ks);
    Mma<T, DV>::nt(dp, dOs + 16 * w * RV::LD, Vs);
    const bool full = all_live(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + 16 * w + g + 8 * (r >> 1);
        const int j = k0 + 8 * c + 2 * t + (r & 1);
        const bool ok = full || live(i, j, Sq, Sk, causal, window);
        const float p = ok ? exp2f(s[c][r] * scale2 - l2[r >> 1]) : 0.f;
        dp[c][r] = p * (dp[c][r] - dd[r >> 1]);
      }
    Mma<T, DK>::pa(acc, dp, Ks, scr);   // dQ += dS K
    __syncthreads();               // this stage is refilled next tile
    if constexpr (L::ST == 1) {
      if (it + 1 < n) issue(it + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();              // no copy may outlive the block

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + 16 * w + g + 8 * e;
    if (i >= Sq) continue;
    T* row = dq + (((size_t)b * Sq + i) * H + h) * DK;
#pragma unroll
    for (int c = 0; c < DK / 8; ++c)
      store2(row + 8 * c + 2 * t, acc[c][2 * e] * scale,
             acc[c][2 * e + 1] * scale);
  }
}

// dK and dV of keys [k0, k0 + 64) of KV head kvh, batch b, over the query
// heads of split `split`
template <typename T, int DK, int DV>
__device__ __forceinline__ void dkdv_block(
    unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
    int kvh, int split, int b, int k0, int B, int Sq, int Sk, int H, int KV,
    int splits, int causal, int window, float scale2, float scale) {
  using L = BwdSmem<T, DK, DV>;
  using R = typename L::R;
  using RV = typename L::RV;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / KV;
  const int h_lo = kvh * G + split * G / splits;
  const int h_hi = kvh * G + (split + 1) * G / splits;
  unsigned char *Ks = smem, *Vs = smem + R::TILE;
  float* scr = reinterpret_cast<float*>(smem + L::SCR) + w * 16 * SP;

  // query tiles the masks leave alive for keys [k0, k0 + BK)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n = nq * (h_hi - h_lo);

  float ak[DK / 8][4], av[DV / 8][4];
  zero(ak);
  zero(av);

  // item it: query tile q_lo + (it % nq) 64 of head h_lo + it / nq, with
  // its rows' lse (thread < 64) and D (the others)
  auto issue = [&](int it, int st) {
    unsigned char* S = L::stage(smem, st);
    const int h = h_lo + it / nq, q0 = q_lo + (it % nq) * BQ;
    load_tile<T, DK, NTH>(S, q, b, q0, Sq, H, h, tid);
    load_tile<T, DV, NTH>(S + R::TILE, dO, b, q0, Sq, H, h, tid);
    const int i = q0 + (tid & 63);
    const float* src = (tid < 64 ? lse : delta) +
                       ((size_t)b * H + h) * Sq + min(i, Sq - 1);
    cp_async4(reinterpret_cast<float*>(smem + L::ROWS) + st * 128 + tid, src,
              i < Sq ? 4 : 0);
  };
  load_tile<T, DK, NTH>(Ks, k, b, k0, Sk, KV, kvh, tid);
  load_tile<T, DV, NTH>(Vs, v, b, k0, Sk, KV, kvh, tid);
  if (n > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    if constexpr (L::ST > 1) {
      if (it + 1 < n) issue(it + 1, (it + 1) % L::ST);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it % L::ST;
    const int q0 = q_lo + (it % nq) * BQ;
    const unsigned char* Qs = L::stage(smem, st);
    const unsigned char* dOs = Qs + R::TILE;
    const float* rows = reinterpret_cast<const float*>(smem + L::ROWS) +
                        st * 128;
    float s[8][4], dp[8][4];
    Mma<T, DK>::nt(s, Ks + 16 * w * R::LD, Qs);     // S^T: 16 keys x 64 queries
    Mma<T, DV>::nt(dp, Vs + 16 * w * RV::LD, dOs);  // dP^T
    const bool full = all_live(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k0 + 16 * w + g + 8 * (r >> 1);
        const int col = 8 * c + 2 * t + (r & 1);
        const bool ok = full || live(q0 + col, j, Sq, Sk, causal, window);
        const float p =
            ok ? exp2f(s[c][r] * scale2 - rows[col] * LOG2E) : 0.f;
        s[c][r] = p;
        dp[c][r] = p * (dp[c][r] - rows[64 + col]);
      }
    Mma<T, DV>::pa(av, s, dOs, scr);   // dV += P^T dO
    Mma<T, DK>::pa(ak, dp, Qs, scr);   // dK += dS^T Q
    __syncthreads();               // this stage is refilled next item
    if constexpr (L::ST == 1) {
      if (it + 1 < n) issue(it + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();              // no copy may outlive the block

  if constexpr (DK == DV) {
    constexpr int HD = DK;
    const size_t nel = (size_t)B * Sk * KV * HD;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = k0 + 16 * w + g + 8 * e;
      if (j >= Sk) continue;
      const size_t off = (((size_t)b * Sk + j) * KV + kvh) * HD + 2 * t;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        if (splits == 1) {
          store2(dk + off + 8 * c, ak[c][2 * e] * scale, ak[c][2 * e + 1] * scale);
          store2(dv + off + 8 * c, av[c][2 * e], av[c][2 * e + 1]);
        } else {
          float* pk = part + 2 * split * nel + off + 8 * c;
          store2(pk, ak[c][2 * e], ak[c][2 * e + 1]);
          store2(pk + nel, av[c][2 * e], av[c][2 * e + 1]);
        }
      }
    }
  } else {       // one split (the wrapper's rule at H = KV)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = k0 + 16 * w + g + 8 * e;
      if (j >= Sk) continue;
      const size_t row = ((size_t)b * Sk + j) * KV + kvh;
#pragma unroll
      for (int c = 0; c < DK / 8; ++c)
        store2(dk + row * DK + 2 * t + 8 * c, ak[c][2 * e] * scale,
               ak[c][2 * e + 1] * scale);
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        store2(dv + row * DV + 2 * t + 8 * c, av[c][2 * e], av[c][2 * e + 1]);
    }
  }
}

// One launch of both passes, so a small problem runs them side by side:
// blocks [0, nk KV splits B) are dkdv blocks, key tile slowest (the first
// key tiles, the longest under a causal mask, first), the rest dq blocks,
// query tile slowest (the last query tiles first).
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NTH)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ part, int B, int Sq, int Sk, int H,
                 int KV, int splits, int causal, int window, float scale2,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_kt = KV * splits * B, nk = (Sk + BK - 1) / BK;
  const int blk = blockIdx.x;
  if (blk < per_kt * nk) {
    const int r = blk % per_kt, ks = r % (KV * splits);
    dkdv_block<T, DK, DV>(smem, q, k, v, dO, lse, delta, dk, dv, part,
                      ks / splits, ks % splits, r / (KV * splits),
                      blk / per_kt * BK, B, Sq, Sk, H, KV, splits, causal,
                      window, scale2, scale);
  } else {
    const int i = blk - per_kt * nk, nq = (Sq + BQ - 1) / BQ;
    const int r = i % (H * B);
    dq_block<T, DK, DV>(smem, q, k, v, dO, lse, delta, dq, r % H, r / H,
                    (nq - 1 - i / (H * B)) * BQ, Sq, Sk, H, KV, causal,
                    window, scale2, scale);
  }
}

// dK = scale x the sum of the splits' partials, dV their sum, in split order
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                     T* __restrict__ dv, size_t nel, int splits, float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nel;
       i += (size_t)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += part[2 * s * nel + i];
      sv += part[(2 * s + 1) * nel + i];
    }
    store(dk + i, sk * scale);
    store(dv + i, sv);
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const float* o,
           const float* lse, const void* dO, void* dq, void* dk, void* dv,
           float* delta, float* part, int B, int Sq, int Sk, int H, int KV,
           int causal, int window, int splits, float scale, cudaStream_t st) {
  using L = BwdSmem<T, DK, DV>;
  if (DK != DV && splits != 1) return (int)cudaErrorInvalidValue;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(dO);
  T *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<T, DV><<<(unsigned)((rows * 32 + 255) / 256), 256, 0,
                                  st>>>(o, tg, delta, Sq, H, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the attribute is per device, so it is set on every launch
  e = cudaFuncSetAttribute(flash_bwd_kernel<T, DK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)KV * splits * B * ((Sk + BK - 1) / BK) +
                      (long)H * B * ((Sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_bwd_kernel<T, DK, DV><<<(unsigned)blocks, NTH, L::BYTES, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), tdk, tdv, part, B, Sq,
      Sk, H, KV, splits, causal, window, scale * LOG2E, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t nel = (size_t)B * Sk * KV * DK, nb = (nel + 255) / 256;
  flash_bwd_sum_kernel<T><<<(unsigned)(nb < 4096 ? nb : 4096), 256, 0, st>>>(
      part, tdk, tdv, nel, splits, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, int vd, const void* q, const void* k, const void* v,
                const float* o, const float* lse, const void* dO, void* dq,
                void* dk, void* dv, float* delta, float* part, int B, int Sq,
                int Sk, int H, int KV, int causal, int window, int splits,
                float scale, cudaStream_t st) {
  // MLA's pair (DeepSeek-V2: q / k 192, v 128), bf16
  if (vd != hd) {
    if constexpr (sizeof(T) == 2) {
      if (hd == 192 && vd == 128)
        return launch<T, 192, 128>(q, k, v, o, lse, dO, dq, dk, dv, delta, part, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 64: return launch<T, 64, 64>(q, k, v, o, lse, dO, dq, dk, dv, delta, part, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
    case 80: return launch<T, 80, 80>(q, k, v, o, lse, dO, dq, dk, dv, delta, part, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
    case 112: return launch<T, 112, 112>(q, k, v, o, lse, dO, dq, dk, dv, delta, part, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
    case 128: return launch<T, 128, 128>(q, k, v, o, lse, dO, dq, dk, dv, delta, part, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q / dq (B, Sq, H, hd), k / dk (B, Sk, KV, hd), v / dv (B, Sk, KV, vd),
// dO (B, Sq, H, vd), contiguous and 16-byte aligned, f32 (bf16 == 0) or
// bf16; o (B, Sq, H, vd) and lse (B, H, Sq) f32 from the forward (o before
// its rounding to bf16); delta f32 scratch of B H Sq floats; splits in [1,
// H / KV] blocks a KV head's query heads are split over, and for splits > 1
// part f32 scratch of splits x 2 x B Sk KV hd floats; hd = vd in {64, 80,
// 112, 128}, or (hd, vd) = (192, 128) in bf16 with one split; window 0 =
// none; scale multiplies q k^T.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* lse, const void* dO,
                               void* dq, void* dk, void* dv, void* delta,
                               void* part, int bf16, int B, int Sq, int Sk,
                               int H, int KV, int hd, int vd, int causal,
                               int window, int splits, float scale,
                               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV || splits < 1 ||
      splits > H / KV || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<const float*>(lse);
  auto of = static_cast<const float*>(o);
  auto dl = static_cast<float*>(delta);
  auto pt = static_cast<float*>(part);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, vd, q, k, v, of, ls, dO, dq, dk, dv, dl, pt, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
  return dispatch_hd<float>(hd, vd, q, k, v, of, ls, dO, dq, dk, dv, dl, pt, B, Sq, Sk, H, KV, causal, window, splits, scale, st);
}

}  // extern "C"
