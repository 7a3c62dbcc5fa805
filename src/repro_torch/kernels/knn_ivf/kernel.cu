// IVF approximate top-k over a cluster-major support set, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_ivf/kernel.py:65
// `ivf_topk_pallas` (`_ivf_kernel` :18): per query, over the rows of its
// own `nprobe` probed lists, score = (q . row) * inv, masked to ids >= 0,
// then top-k; scores f32 descending, ids int32 (ties to the lower row id),
// -inf / -1 in slots no valid row fills.
//
// What bounds it on an H100: the probed lists' raw rows, read once per
// distinct list (at 16 queries, nprobe 8 and lists of 400 x 768 f32, 62
// distinct lists of a fitted index are 76 MB: 23 us at 3.35 TB/s); the dot
// products (2 Q P L D flops, 79 MFLOP) are far below the f32 rate.  So it
// is bound by bytes, and the design reads each probed list once per query
// tile, with copies in flight on every SM.
//
// Design (one launch for k <= 2,048).  The TPU plans per-tile slot lists on
// the host (`plan_tile_probes`, src/repro/kernels/knn_ivf/ops.py:832),
// scalar-prefetches them, and carries a running top-k along the slot axis.
// Here:
//   grid    one scan block a (row chunk of 64, probe slot, query), chunk
//           fastest, then the selector blocks.  Queries form tiles of 16.
//           Each scan block reads its tile's probe ids; it owns its list
//           when no earlier (query, slot) of the tile probes it, and scores
//           its row chunk for every query of the tile that probes the list
//           (at that query's first slot on it).  Blocks that do not own their
//           list leave at once, so each probed list is read from HBM once
//           per tile and call, and the grid spreads over the card at any Q.
//           A slot whose list id is out of range writes masked keys; a
//           query's second slot on one list scores it again for itself.
//   scan    the chunk's rows stream through a ring of shared-memory stages
//           of 256 bytes of each of 64 rows (and the stage's f32 slices of
//           the probing queries), filled by 16-byte `cp.async` (4-byte where
//           D is not a multiple of 4) that zero-fill past L and D; the next
//           stages are in flight while the FMAs run on the current one.  Each
//           warp takes 32 bytes of every row of a stage; a lane keeps 2 rows
//           (lane, lane + 32) x NQ queries of partial sums (NQ the probing
//           queries rounded up to 1, 2, 4, 8 or 16), so the FMAs follow the
//           queries that probe the list.  Three blocks an SM; on an H100,
//           two blocks an SM with a deeper ring, 32-row chunks, and
//           persistent blocks taking chunks from a counter were slower.  The eight warps' partial sums are added through
//           shared memory in a fixed order (warps 0-3 written, 4-7 added, the
//           four sums added in order), so a row's score has the same bits
//           whichever block computes it; then `* inv` and `make_key`.
//   hand-over
//           each scan block writes its keys into the (Q, P L) scratch at
//           each probing query's slot positions, fences, and adds one to
//           each served query's ticket; a query's keys are complete when its
//           ticket counts P x ceil(L / 64) entries.
//   select  selector blocks after the scan blocks in the same grid
//           (min(Q, half the blocks the card holds at once), so scan blocks
//           always find room): selector s waits for the tickets of queries
//           s, s + selectors, ... in turn, copies each one's keys into
//           shared memory through L2, selects (`block_topk`, select.cuh:
//           radix select with 11-, 11- and 10-bit digits that stops as soon
//           as the digit's bin holds the keys still needed, survivors placed
//           by rank or sorted by the block) and resets the ticket for the
//           next call.  Keys are unique (~id in the low bits), so the result
//           does not depend on the order in which blocks finish.  Letting
//           the block whose add completes a query select it was slower on
//           an H100 where queries share lists: the last owner of a list
//           that all of a tile's queries probe then selects all of them in
//           turn (16 queries on one probe set: 0.123 ms, the parent design
//           0.067).
// Above k = 2,048 the same scan writes its keys without the hand-over, and
// ceil(k / 1,024) rounds of `select_topk_kernel` select.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "select.cuh"

namespace {

// CUDA kernels this library has launched (`ivf_topk_device_launches`)
unsigned long long g_launches = 0;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QT = 16;               // queries a tile
constexpr int TN = 64;               // list rows a block
constexpr int RPT = TN / 32;         // rows a lane: lane, lane + 32, ...
constexpr int ROW_BYTES = 256;       // bytes of each row a ring stage
constexpr int TD = ROW_BYTES / 4;    // f32 values of a row a stage
constexpr int WARP_VALS = TD / WARPS;  // a warp's values of a row a stage
constexpr int PITCH = ROW_BYTES + 16;  // the 16-byte reads of 8 neighbouring
                                       // rows hit 32 different banks
constexpr int STAGES = 3;
constexpr int STAGE = TN * PITCH + QT * TD * 4;
constexpr int RING = STAGES * STAGE;
constexpr int RED_PITCH = QT + 1;
// the warps' partial sums, added in two rounds of 4 warps: (4, TN, QT + 1)
// in the ring's place once the ring is drained
constexpr int RED = 4 * TN * RED_PITCH * 4;
// dynamic shared memory of a block: the ring, and room for the selection
// (three blocks an SM)
constexpr int SMEM = RING > 72 * 1024 ? RING : 72 * 1024;
constexpr int FK_MAX = SEL_BLOCK_KMAX;   // k of the one-launch path
static_assert(THREADS == SEL_THREADS, "a selector selects with all threads");
static_assert(RED <= RING && sel_smem(FK_MAX) <= SMEM, "shared memory");

// The chunk's keys for the nq (<= NQ) queries sq[] at slots ss[] of list
// cid, rows [l0, l0 + TN).
template <int VEC, int NQ>
__device__ void scan_chunk(const float* __restrict__ q,
                           const float* __restrict__ sup,
                           const int* __restrict__ ids,
                           const float* __restrict__ inv,
                           u64* __restrict__ keys, int cid, int l0, int L,
                           int D, long long n, const int* sq, const int* ss,
                           int nq, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_bytes = (long long)D * 4;
  const int steps = (int)((row_bytes + ROW_BYTES - 1) / ROW_BYTES);
  const unsigned char* list =
      reinterpret_cast<const unsigned char*>(sup + (long long)cid * L * D);
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(q);

  auto issue = [&](int g) {
    if (g < steps) {
      unsigned char* st = smem + (g % STAGES) * STAGE;
      const long long c0 = (long long)g * ROW_BYTES;
      constexpr int CPR = ROW_BYTES / VEC;                   // copies a row
      for (int e = tid; e < TN * CPR; e += THREADS) {
        const int r = e / CPR, c = e % CPR;
        const long long byte = c0 + (long long)c * VEC;
        const bool ok = l0 + r < L && byte < row_bytes;
        const unsigned char* src =
            ok ? list + (long long)(l0 + r) * row_bytes + byte : list;
        if (VEC == 16)
          cp_async16_zfill(st + r * PITCH + c * VEC, src, ok);
        else
          cp_async4_zfill(st + r * PITCH + c * VEC, src, ok);
      }
      for (int e = tid; e < NQ * CPR; e += THREADS) {
        const int j = e / CPR, c = e % CPR;
        const long long byte = c0 + (long long)c * VEC;
        const bool ok = j < nq && byte < row_bytes;
        const unsigned char* src =
            ok ? qb + (long long)sq[j] * row_bytes + byte : qb;
        unsigned char* dst = st + TN * PITCH + j * ROW_BYTES + c * VEC;
        if (VEC == 16)
          cp_async16_zfill(dst, src, ok);
        else
          cp_async4_zfill(dst, src, ok);
      }
    }
    cp_async_commit();
  };

  for (int g = 0; g < STAGES - 1; ++g) issue(g);
  float acc[RPT][NQ];
#pragma unroll
  for (int h = 0; h < RPT; ++h)
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[h][j] = 0.f;

  for (int g = 0; g < steps; ++g) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot of step g + STAGES - 1 was read in step g - 1, which every
    // thread has finished at the barrier above
    issue(g + STAGES - 1);
    const unsigned char* st =
        smem + (g % STAGES) * STAGE + warp * WARP_VALS * 4;
    const float* qs = reinterpret_cast<const float*>(
                          smem + (g % STAGES) * STAGE + TN * PITCH) +
                      warp * WARP_VALS;
#pragma unroll
    for (int c = 0; c < WARP_VALS / 4; ++c) {
      float4 a[RPT];
#pragma unroll
      for (int h = 0; h < RPT; ++h)
        a[h] = reinterpret_cast<const float4*>(st + (lane + 32 * h) * PITCH)[c];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 x = reinterpret_cast<const float4*>(qs + j * TD)[c];
#pragma unroll
        for (int h = 0; h < RPT; ++h) {
          acc[h][j] = fmaf(x.x, a[h].x, acc[h][j]);
          acc[h][j] = fmaf(x.y, a[h].y, acc[h][j]);
          acc[h][j] = fmaf(x.z, a[h].z, acc[h][j]);
          acc[h][j] = fmaf(x.w, a[h].w, acc[h][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is drained

  // the warps' partial sums: warps 0-3 written, warps 4-7 added to them
  float* red = reinterpret_cast<float*>(smem);
  const int slot = warp & 3;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    if ((warp >> 2) == round) {
#pragma unroll
      for (int h = 0; h < RPT; ++h) {
        float* dst = red + (slot * TN + lane + 32 * h) * RED_PITCH;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          dst[j] = round ? dst[j] + acc[h][j] : acc[h][j];
      }
    }
    __syncthreads();
  }
  // the four sums in order, * inv, one key per (query, row)
  for (int e = tid; e < TN * nq; e += THREADS) {
    const int r = e % TN, j = e / TN, l = l0 + r;
    if (l >= L) continue;
    float dot = red[r * RED_PITCH + j];
#pragma unroll
    for (int w = 1; w < 4; ++w) dot += red[(w * TN + r) * RED_PITCH + j];
    const long long row = (long long)cid * L + l;
    const int id = ids[row];
    keys[(long long)sq[j] * n + (long long)ss[j] * L + l] =
        make_key(dot * inv[row], id, id >= 0);
  }
}

// Waits of a selector for a ticket before it calls the run failed: the
// scan blocks never wait, so a ticket that stays short means a fault, and
// the launch traps rather than hanging the card
constexpr long long SPIN_LIMIT = 1ll << 24;   // x 256 ns: about 4 s

// A scan block: item it of (row chunk, probe slot, query), chunk fastest.
// Its role in the query tile, its scan, and (select != 0) one ticket for
// each query it wrote keys for.
template <int VEC>
__device__ void scan_item(long long it, int nchunks,
                          const float* __restrict__ q,
                          const int* __restrict__ q_probe,
                          const float* __restrict__ sup,
                          const int* __restrict__ ids,
                          const float* __restrict__ inv, u64* __restrict__ keys,
                          int* __restrict__ ticket, int Q, int C, int L, int D,
                          int P, int select, unsigned char* smem) {
  __shared__ int first[QT];             // a tile query's first slot on cid
  __shared__ int sq[QT], ss[QT];        // the served (query, slot) pairs
  __shared__ int s_nq;
  const int tid = threadIdx.x;
  const int chunk = (int)(it % nchunks), p = (int)(it / nchunks % P);
  const int qi = (int)(it / ((long long)nchunks * P));
  const int q0 = qi - qi % QT, nt = min(QT, Q - q0), me = qi - q0;
  const int cid = q_probe[(long long)qi * P + p];
  const bool live = cid >= 0 && cid < C;
  const long long n = (long long)P * L;           // keys a query
  const int l0 = chunk * TN;

  if (tid < QT) first[tid] = INT_MAX;
  __syncthreads();
  if (live)
    for (int e = tid; e < nt * P; e += THREADS)
      if (q_probe[(long long)q0 * P + e] == cid)
        atomicMin(&first[e / P], e % P);
  __syncthreads();
  if (tid == 0) {
    int nq = 0;
    if (!live || first[me] < p) {
      // no list, or this query's second slot on it: this slot alone
      sq[0] = qi;
      ss[0] = p;
      nq = 1;
    } else {
      bool owner = true;
      for (int j = 0; j < me; ++j) owner &= first[j] == INT_MAX;
      for (int j = 0; owner && j < nt; ++j)
        if (first[j] != INT_MAX) {
          sq[nq] = q0 + j;
          ss[nq] = first[j];
          ++nq;
        }
    }
    s_nq = nq;
  }
  __syncthreads();
  const int nq = s_nq;
  if (nq == 0) return;          // an earlier (query, slot) reads this list

  if (!live) {
    u64* out = keys + (long long)qi * n + (long long)p * L;
    for (int r = tid; r < TN; r += THREADS)
      if (l0 + r < L) out[l0 + r] = 0ull;
  } else if (nq == 1) {
    scan_chunk<VEC, 1>(q, sup, ids, inv, keys, cid, l0, L, D, n, sq, ss, nq,
                       smem);
  } else if (nq == 2) {
    scan_chunk<VEC, 2>(q, sup, ids, inv, keys, cid, l0, L, D, n, sq, ss, nq,
                       smem);
  } else if (nq <= 4) {
    scan_chunk<VEC, 4>(q, sup, ids, inv, keys, cid, l0, L, D, n, sq, ss, nq,
                       smem);
  } else if (nq <= 8) {
    scan_chunk<VEC, 8>(q, sup, ids, inv, keys, cid, l0, L, D, n, sq, ss, nq,
                       smem);
  } else {
    scan_chunk<VEC, 16>(q, sup, ids, inv, keys, cid, l0, L, D, n, sq, ss,
                        nq, smem);
  }
  if (!select) return;
  // the hand-over: the keys are visible before the tickets count them
  __threadfence();
  __syncthreads();
  if (tid < nq) atomicAdd(&ticket[sq[tid]], 1);
}

// A selector block: queries s, s + nsel, ... in turn, each once its ticket
// counts all P x chunks entries of its keys; the keys come into shared
// memory where they fit (through L2), else each pass reads them from L2.
// Each query's ticket is reset for the next call.
__device__ void select_queries(int s, int nsel, const u64* __restrict__ keys,
                               int* __restrict__ ticket,
                               float* __restrict__ out_s,
                               int* __restrict__ out_i, int Q, int P,
                               int nchunks, int L, int k,
                               unsigned char* smem) {
  const int tid = threadIdx.x;
  const long long n = (long long)P * L;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  u64* sel = reinterpret_cast<u64*>(smem + SEL_NB * 4);
  u64* kbuf = reinterpret_cast<u64*>(smem + sel_smem(k));
  const bool fit = n * 8 <= SMEM - sel_smem(k);
  for (int qq = s; qq < Q; qq += nsel) {
    if (tid == 0) {
      const volatile int* t = ticket + qq;
      for (long long w = 0; *t != P * nchunks; ++w) {
        if (w == SPIN_LIMIT) __trap();
        __nanosleep(256);
      }
    }
    __syncthreads();
    __threadfence();
    const u64* row = keys + (long long)qq * n;
    float* os = out_s + (long long)qq * k;
    int* oi = out_i + (long long)qq * k;
    if (fit) {
      if (n % 2 == 0) {                 // 16-byte rows: copies through L2
        for (int i = 2 * tid; i < n; i += 2 * THREADS)
          cp_async16_zfill(kbuf + i, row + i, true);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        for (int i = tid; i < n; i += THREADS) kbuf[i] = __ldcg(row + i);
      }
      __syncthreads();
      block_topk([&](int i) { return kbuf[i]; }, (int)n, k, ~0ull, hist, sel,
                 os, oi);
    } else {
      block_topk([&](int i) { return __ldcg(row + i); }, (int)n, k, ~0ull,
                 hist, sel, os, oi);
    }
    if (tid == 0) ticket[qq] = 0;       // ready for the next call
  }
}

// Blocks [0, items) scan; with select != 0 (k <= FK_MAX) blocks
// [items, items + nsel) select.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 3)
ivf_tile_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                const float* __restrict__ sup, const int* __restrict__ ids,
                const float* __restrict__ inv, u64* __restrict__ keys,
                int* __restrict__ ticket, float* __restrict__ out_s,
                int* __restrict__ out_i, int Q, int C, int L, int D, int P,
                int k, int select, long long items, int nsel) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunks = (L + TN - 1) / TN;
  if ((long long)blockIdx.x < items)
    scan_item<VEC>(blockIdx.x, nchunks, q, q_probe, sup, ids, inv, keys,
                   ticket, Q, C, L, D, P, select, smem);
  else
    select_queries((int)(blockIdx.x - items), nsel, keys, ticket, out_s,
                   out_i, Q, P, nchunks, L, k, smem);
}

template <int VEC>
cudaError_t launch(const float* q, const int* q_probe, const float* sup,
                   const int* ids, const float* inv, u64* keys, int* ticket,
                   float* out_s, int* out_i, int Q, int P, int C, int L,
                   int D, int k, cudaStream_t st) {
  auto fn = ivf_tile_kernel<VEC>;
  // the attribute is per device, so it is set on every launch
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
  if (e != cudaSuccess) return e;
  const long long items = (long long)((L + TN - 1) / TN) * P * Q;
  const int select = k <= FK_MAX;
  int nsel = 0;
  if (select) {
    // at most half the blocks the card holds at once wait as selectors, so
    // scan blocks always find room and every ticket completes
    int dev = 0, sms = 0, bps = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &bps, fn, THREADS, SMEM)) != cudaSuccess)
      return e;
    if (bps < 1) return cudaErrorInvalidConfiguration;
    nsel = min(Q, max(1, bps * sms / 2));
  }
  fn<<<(unsigned)(items + nsel), THREADS, SMEM, st>>>(
      q, q_probe, sup, ids, inv, keys, ticket, out_s, out_i, Q, C, L, D, P, k,
      select, items, nsel);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++g_launches;
  if (select) return cudaSuccess;
  e = select_topk(keys, Q, P * L, k, out_s, out_i, st);
  g_launches += e == cudaSuccess ? (k + SEL_KMAX - 1) / SEL_KMAX : 0;
  return e;
}

}  // namespace

extern "C" {

// CUDA kernels launched by this library since it was loaded
unsigned long long ivf_topk_device_launches() { return g_launches; }

// q (Q, D) f32; q_probe (Q, P) i32; sup (C, L, D) f32; ids / inv (C, L);
// keys (Q, P * L) u64 scratch; ticket (Q,) int32 holding zeros (left zero
// by the call; unused above k = 2,048); out (Q, k).
int ivf_topk_launch(const void* q, const void* q_probe, const void* sup,
                    const void* ids, const void* inv, void* keys, void* ticket,
                    void* out_s, void* out_i, int Q, int P, int C, int L,
                    int D, int k, void* stream) {
  if (k < 1 || Q < 1 || P < 1 || L < 1 || D < 1 ||
      (long long)P * L > INT_MAX ||
      (long long)((L + TN - 1) / TN) * P * Q + Q > INT_MAX)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const bool v16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(sup) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  auto args = [&](auto fn) {
    return (int)fn(static_cast<const float*>(q),
                   static_cast<const int*>(q_probe),
                   static_cast<const float*>(sup),
                   static_cast<const int*>(ids),
                   static_cast<const float*>(inv), static_cast<u64*>(keys),
                   static_cast<int*>(ticket), static_cast<float*>(out_s),
                   static_cast<int*>(out_i), Q, P, C, L, D, k, st);
  };
  return v16 ? args(launch<16>) : args(launch<4>);
}

}  // extern "C"
