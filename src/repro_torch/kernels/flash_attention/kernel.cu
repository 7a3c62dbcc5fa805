// Forward attention for Hopper (sm_90a): online softmax in f32, GQA,
// causal and sliding-window masks, dead key tiles skipped; two kernels,
// chosen by the inputs' dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:90
// `flash_attention_pallas` (`_flash_kernel` :25).  Same function: scale
// 1/sqrt(hd), query head h reads KV head h * KV / H, causal mask
// qpos >= kpos, window mask qpos - kpos < window, output in q's dtype.
// Layout is the model's (B, S, heads, hd), contiguous, so no transposes.
// For the backward (bwd_kernel.cu) both also write each row's log-sum-exp
// and, for bf16, the output in f32 before its rounding.
//
// f32 (`flash_fwd_kernel<float, HD>`, the query encoder's).  What bounds
// it on an H100: at the encoder's shape (B = 1024 texts, S = 64, H = KV =
// 12, hd = 64, causal) the kernel moves q, k, v and o once (4 x 201 MB:
// 0.240 ms at 3.35 TB/s) against 6.5 GFLOP of f32 work, counted as 4 B H
// hd per live (query, key) pair (2,080 pairs a head: 0.098 ms at 67
// TFLOP/s): bytes bound it.  The f32 tolerance (2e-5 against the f32 plain
// version) keeps the work on the FMA units, not TF32 tensor cores, where
// shared-memory reads, the softmax and the masks take issue slots beside
// the FMAs; so the design's aims are many FMAs per shared-memory read and
// loads in flight while blocks compute.
//
// Its design.  The TPU grid (B, H, Sq/BQ, Sk/BK) carries m / l / acc in
// VMEM scratch across the sequential KV axis; here the KV loop runs inside
// the block.  One block = 64 query rows of one (b, h), 256 threads.  Q and
// each 64-key K/V tile arrive by 16-byte cp.async copies (rows padded by
// 16 bytes in shared memory), K/V double-buffered across tiles where Sk >
// 64, so the next tile's loads fly while this one computes.  Thread (ty,
// tx) of a 16 x 16 grid owns a 4 x 4 register micro-tile of the 64 x 64
// score block, rows ty + 16 a and keys tx + 16 b: each 16-byte read of a Q
// row and of a K row feeds 4 x 4 x 4 FMAs, and the K rows a quarter-warp
// reads start 16 bytes apart in the bank space, so the reads are free of
// conflicts.  The (a, b) entry of every thread's micro-tile lies in the
// same 16 x 16 sub-block, so a sub-block wholly above the causal diagonal
// (the diagonal tile) or wholly outside a window whose width is a multiple
// of 64 (the window's first tile) is skipped by every thread at compile
// time.  Row max and sum are half-warp shuffles (a row's 16 threads are
// one half-warp); P goes to shared memory only for the same half-warp to
// read back, and P.V runs over the same rows with 4-column chunks per
// thread, the accumulator in registers across all key tiles.  Masks
// select, never multiply.
//
// ptxas -v (sm_90a): hd 64 80 registers (capped for three blocks an SM;
// the rolled loops below keep it free of spills), hd 80 / 112 / 128 128
// (at most two blocks an SM), no spills.  Dynamic shared memory 71
// KB at hd 64 with one key tile (Q, P, K, V), 105 KB double-buffered; 185
// KB at hd 128, 163 KB at hd 112 (hd 112 = 7 x 16: a 448-byte row is 28
// 16-byte chunks, 28 4-column chunks, so the second chunk of a thread's
// columns is live for tx < 12).
//
// bf16 (`flash_fwd_kernel_tc<HD>`: training, prefill and the cross
// attention).  What bounds it: operations.  At danube's training shape (B
// 2, S 4,096, H 32, KV 8, hd 80, causal) a call is 1.72e11 flops (4 hd a
// live pair and head: 0.174 ms at 989 TFLOP/s) against 0.10 GB of q, k, v,
// o and lse (0.031 ms), so the products belong on the tensor cores, as in
// FlashAttention-2, built from the backward's parts (flash_mma.cuh).  A
// block of 4 warps owns 128 query rows of one (b, h) up to hd 80, a warp
// two 16-row m-tiles (each K and V fragment feeds both), and 64 rows above
// hd 80, a warp one m-tile (two tiles' outputs and scores do not fit in
// the registers).  The live 64-key tiles of K and V stream through a
// two-stage cp.async ring (tile t + 1's copies in flight while tile t is
// multiplied, one barrier a tile); Q's A fragments stay in registers up to
// hd 80.  A warp forms S = Q K^T (m16n8k16 bf16, f32 accumulators: exact
// products of the bf16 inputs summed in f32) and runs the online softmax
// in the C fragment layout, in the log2 domain: row max by quad shuffles,
// each thread's partial row sum rescaled with the row and summed over the
// quad once at the end; masks select (-inf), never multiply, and only a
// warp's tiles that are not wholly live (the diagonal, the window's edge,
// ragged ends) test them, while a tile wholly above a warp's rows is
// skipped.  P never leaves the registers: its C fragments are the A
// fragments of P.V, where P enters as two bf16 terms, hi = bf16(p) and lo
// = bf16(p - hi), so each product keeps p to ~2^-17, as the f32 P of the
// FMA design did (one bf16 rounding of P, FlashAttention-2's, would give
// another result); one `ldmatrix.trans` B fragment of V feeds both terms,
// and each 8-column block of the output sums a tile's products in a fresh
// f32 sum, added to the rescaled output by one fma (the tensor cores
// truncate the sums they form).  Grid: one block a (query tile, b, h),
// query tile slowest and the last tiles (the most key tiles under a causal
// mask) first, so the long blocks start first and short ones fill the
// tail.  mma.sync rather than wgmma: it keeps P in registers and lets one
// B fragment feed both terms (bwd_kernel.cu's note); wgmma and TMA are
// later work.
//
// ptxas -v (sm_90a, bf16): two blocks an SM; hd 64 / 80 255 registers with
// 24 / 36 B of spill stores (Q's fragments, two m-tiles' outputs and S:
// without Q in registers 0 / 144 B and slower), hd 112 / 128 under 255, no
// spills.  Dynamic shared memory (Q, two stages of K and V) 55,296 /
// 67,584 B at hd 64 / 80 (128 rows of Q), 76,800 / 87,040 at hd 112 / 128.
//
// MLA (DeepSeek-V2): q and k of 192 dims (128 without RoPE, 64 with), v of
// 128, one kernel `flash_fwd_kernel_tc<192, 128>`: S over twelve 16-column
// k-steps, P.V and the output over 128 columns, one m-tile a warp as at hd
// 128; 111,616 B of shared memory (Q 64 rows of 400 B, two stages of K
// 25,600 and V 17,408), so two blocks an SM still fit.  Its scale is the
// caller's (YaRN's mscale^2 / sqrt(192)), as every instantiation's is.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_mma.cuh"

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

// ---------------------------------------------------------------- bf16

constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_STAGES = 2;            // ring of K / V tiles

// The kernel's shape at query / key head dim DK and value head dim DV (DV
// = DK but for MLA's pair, 192 / 128).  MT 16-row m-tiles a warp: two up
// to dk 80 (each K and V fragment feeds both, half the shared-memory reads
// and the cp.async traffic a product), one above, where two tiles' output
// fragments and S do not fit in registers.  QREG: Q's A fragments held in
// registers across the key tiles (dk <= 80; above, read anew a tile).
// Shared memory: Q (ROWS rows of DK), then TC_STAGES x (K of DK, V of DV).
template <int DK, int DV>
struct Tc {
  using R = TileRows<__nv_bfloat16, DK>;
  using RV = TileRows<__nv_bfloat16, DV>;
  static constexpr int MT = DK <= 80 ? 2 : 1;
  static constexpr bool QREG = DK <= 80;
  static constexpr int ROWS = 16 * TC_WARPS * MT;
  static constexpr int QB = ROWS * R::LD;
  static constexpr int STAGE = R::TILE + RV::TILE;
  static constexpr int BYTES = QB + TC_STAGES * STAGE;
  __device__ static unsigned char* stage(unsigned char* smem, int s) {
    return smem + QB + s * STAGE;
  }
};

// every pair of a warp's query rows [i0, i0 + ROWS) and key tile [k0, k0 +
// 64) is live
template <int ROWS>
__device__ __forceinline__ bool rows_live(int i0, int k0, int Sq, int Sk,
                                          int causal, int window) {
  return i0 + ROWS <= Sq && k0 + BK <= Sk && (!causal || k0 + BK - 1 <= i0) &&
         (window <= 0 || i0 + ROWS - 1 - k0 < window);
}

// 2^x; a subnormal result flushes to 0 (p below 2^-126 of the row's max)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DK, int DV>
__global__ void __launch_bounds__(TC_NT, 2)
flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    float* __restrict__ o32, int B, int Sq, int Sk, int H,
                    int KV, int causal, int window, float scale2) {
  using T = __nv_bfloat16;
  using S = Tc<DK, DV>;
  using R = typename S::R;
  using RV = typename S::RV;
  constexpr int MT = S::MT, BQT = S::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, lr = lane & 7;
  // query tile slowest, the last (longest under a causal mask) first
  const int nq = (Sq + BQT - 1) / BQT, bh = blockIdx.x % (H * B);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (H * B))) * BQT;
  const int h = bh % H, b = bh / H, kvh = h * KV / H;
  const int wq0 = q0 + 16 * MT * w;      // the warp's first row

  // key tiles the masks leave alive for rows [q0, q0 + BQT)
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQT);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  k_lo -= k_lo % BK;
  const int n = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  auto issue = [&](int it) {
    if (it < n) {
      unsigned char* st = S::stage(smem, it % TC_STAGES);
      load_tile<T, DK, TC_NT>(st, k, b, k_lo + it * BK, Sk, KV, kvh, tid);
      load_tile<T, DV, TC_NT>(st + R::TILE, v, b, k_lo + it * BK, Sk, KV,
                              kvh, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < BQT / 64; ++r)
    load_tile<T, DK, TC_NT>(smem + r * R::TILE, q, b, q0 + 64 * r, Sq, H, h,
                            tid);
  issue(0);

  // rows wq0 + 16 mt + g (e = 0) and + 8 (e = 1): running max (log2
  // domain, scaled), this thread's part of the running sum, output C
  // fragments
  float m[MT][2], l[MT][2], acc[MT][DV / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
    zero(acc[mt]);
  }
  // the A fragment of the warp's m-tile mt of Q at k-step kk
  const unsigned char* Qw = smem + 16 * MT * w * R::LD;
  auto q_frag = [&](uint32_t (&a)[4], int mt, int kk) {
    ldsm4(a, Qw + (16 * mt + lr + 8 * (mi & 1)) * R::LD +
                 (16 * kk + 8 * (mi >> 1)) * 2);
  };
  uint32_t qa[S::QREG ? MT : 1][DK / 16][4];

  for (int it = 0; it < n; ++it) {
    cp_async_wait<0>();
    __syncthreads();             // tile it landed; tile it - 1's reads done
    issue(it + 1);               // into the stage tile it - 1 held
    if constexpr (S::QREG) {
      if (it == 0)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) q_frag(qa[mt][kk], mt, kk);
    }
    const int k0 = k_lo + it * BK;
    // a tile wholly above the causal diagonal for this warp's rows
    if (causal && k0 > wq0 + 16 * MT - 1) continue;
    const unsigned char* Ks = S::stage(smem, it % TC_STAGES);
    const unsigned char* Vs = Ks + R::TILE;

    // S = Q K^T: one K fragment of each 16-key, 16-column step feeds the
    // warp's MT m-tiles
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero(s[mt]);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (S::QREG) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[mt][x] = qa[mt][kk][x];
        } else {
          q_frag(a[mt], mt, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm4(bb, Ks + (16 * np + lr + 8 * (mi >> 1)) * R::LD +
                      (16 * kk + 8 * (mi & 1)) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bb[0], bb[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
    if (!rows_live<16 * MT>(wq0, k0, Sq, Sk, causal, window)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (!live(wq0 + 16 * mt + g + 8 * (r >> 1),
                      k0 + 8 * c + 2 * t + (r & 1), Sq, Sk, causal, window))
              s[mt][c][r] = -CUDART_INF_F;
    }

    // online softmax: P = 2^(S c log2(e) - m) in place of S
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          mx = fmaxf(mx, fmaxf(s[mt][c][2 * e], s[mt][c][2 * e + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][e], mx * scale2);
        // a row with no live key yet keeps m = -inf: its p and alpha are 0
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[mt][e] = ex2(m[mt][e] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int r = 2 * e; r < 2 * e + 2; ++r) {
            s[mt][c][r] = ex2(fmaf(s[mt][c][r], scale2, -m_use));
            sum += s[mt][c][r];
          }
        l[mt][e] = l[mt][e] * alpha[mt][e] + sum;
        m[mt][e] = m_new;
      }

    // O = alpha O + P V: P's C fragments are the A fragments of the four
    // 16-key steps, as hi + lo; one V fragment feeds both terms of every
    // m-tile; each 8-column block sums the tile's products in a fresh f32
    // sum, then one rounded fma into O (the tensor cores truncate the sums
    // they form, so a running O is not their accumulator)
    uint32_t ph[MT][4][4], pl[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_bf16(s[mt][2 * j][0], s[mt][2 * j][1], ph[mt][j][0], pl[mt][j][0]);
        split_bf16(s[mt][2 * j][2], s[mt][2 * j][3], ph[mt][j][1], pl[mt][j][1]);
        split_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1], ph[mt][j][2], pl[mt][j][2]);
        split_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3], ph[mt][j][3], pl[mt][j][3]);
      }
#pragma unroll
    for (int np = 0; np < DV / 16; ++np) {
      float d[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero(d[mt]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[4];
        ldsm4t(bb, Vs + (16 * j + lr + 8 * (mi & 1)) * RV::LD +
                       (16 * np + 8 * (mi >> 1)) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(d[mt][0], pl[mt][j], bb[0], bb[1]);
          mma_bf16(d[mt][0], ph[mt][j], bb[0], bb[1]);
          mma_bf16(d[mt][1], pl[mt][j], bb[2], bb[3]);
          mma_bf16(d[mt][1], ph[mt][j], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[mt][2 * np][r] =
              fmaf(acc[mt][2 * np][r], alpha[mt][r >> 1], d[mt][0][r]);
          acc[mt][2 * np + 1][r] =
              fmaf(acc[mt][2 * np + 1][r], alpha[mt][r >> 1], d[mt][1][r]);
        }
    }
  }
  cp_async_wait<0>();            // no copy may outlive the block

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float ls = l[mt][e];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      const int i = wq0 + 16 * mt + g + 8 * e;
      if (i >= Sq) continue;
      const float inv = ls > 0.f ? 1.f / ls : 0.f;
      // natural-log log-sum-exp of the row's scaled scores; +inf for a row
      // with no live key, so the backward's recomputed P is 0 there
      if (lse != nullptr && t == 0)
        lse[((size_t)b * H + h) * Sq + i] =
            ls > 0.f ? (m[mt][e] + log2f(ls)) * LN2 : CUDART_INF_F;
      const size_t row = (((size_t)b * Sq + i) * H + h) * DV + 2 * t;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const float x = acc[mt][c][2 * e] * inv;
        const float y = acc[mt][c][2 * e + 1] * inv;
        store2(o + row + 8 * c, x, y);
        if (o32 != nullptr) store2(o32 + row + 8 * c, x, y);
      }
    }
}

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, float* o32, int B, int Sq, int Sk, int H, int KV,
              int causal, int window, float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr int bytes = Tc<DK, DV>::BYTES;
  // the attribute is per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  constexpr int rows = Tc<DK, DV>::ROWS;
  const long blocks = (long)((Sq + rows - 1) / rows) * H * B;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel_tc<DK, DV><<<(unsigned)blocks, TC_NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, o32, B, Sq, Sk, H,
      KV, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// f32 inputs to the FMA kernel, bf16 to the tensor-core one
template <typename T, int HD>
int launch_for(const void* q, const void* k, const void* v, void* o,
               float* lse, float* o32, int B, int Sq, int Sk, int H, int KV,
               int causal, int window, float scale, cudaStream_t st) {
  if constexpr (sizeof(T) == 4)
    return launch<T, HD>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
  else
    return launch_tc<HD, HD>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
}

template <typename T>
int dispatch_hd(int hd, int dv, const void* q, const void* k, const void* v,
                void* o, float* lse, float* o32, int B, int Sq, int Sk, int H,
                int KV, int causal, int window, float scale, cudaStream_t st) {
  // MLA's pair (DeepSeek-V2: q / k 192 = 128 + 64 RoPE dims, v 128), bf16
  if (dv != hd) {
    if constexpr (sizeof(T) == 2) {
      if (hd == 192 && dv == 128)
        return launch_tc<192, 128>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 64: return launch_for<T, 64>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 80: return launch_for<T, 80>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 112: return launch_for<T, 112>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    case 128: return launch_for<T, 128>(q, k, v, o, lse, o32, B, Sq, Sk, H, KV, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, dv), o (B, Sq, H, dv),
// contiguous and 16-byte aligned, f32 (bf16 == 0) or bf16; hd = dv in {64,
// 80, 112, 128}, or (hd, dv) = (192, 128) in bf16; window 0 = none; scale
// multiplies q k^T.  For the backward (bwd_kernel.cu), when not null: lse
// receives each row's natural-log log-sum-exp, f32 (B, H, Sq), and o32 the
// output in f32 (B, Sq, H, dv), before its rounding to bf16.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           void* lse, void* o32, int bf16, int B, int Sq,
                           int Sk, int H, int KV, int hd, int dv, int causal,
                           int window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<float*>(lse);
  auto o4 = static_cast<float*>(o32);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, dv, q, k, v, o, ls, o4, B, Sq, Sk, H, KV, causal, window, scale, st);
  return dispatch_hd<float>(hd, dv, q, k, v, o, ls, o4, B, Sq, Sk, H, KV, causal, window, scale, st);
}

}  // extern "C"
