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
//           fastest, then the selector blocks.  Queries form tiles of QT,
//           a template parameter instantiated at 8, 16 (the default), 32
//           and 64: the reference's `block_q` candidates, which the
//           autotuner (`autotune.py`) picks from by time.
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
//           up to 16 of the probing queries; a list that more than 16 of a
//           tile's queries probe is scanned in further passes of 16, its
//           rows read again through L2, so each QT keeps QT 16's registers
//           and shared memory), filled by 16-byte `cp.async` (4-byte where
//           D is not a multiple of 4) that zero-fill past L and D; the next
//           stages are in flight while the FMAs run on the current one.  Each
//           warp takes 32 bytes of every row of a stage; a lane keeps 2 rows
//           (lane, lane + 32) x NQ queries of partial sums (NQ the probing
//           queries rounded up to 1, 2, 4, 8 or 16), so the FMAs follow the
//           queries that probe the list.  Three blocks an SM at QT 8 and
//           16 (there, on an H100, two blocks an SM with a deeper ring,
//           32-row chunks, and persistent blocks taking chunks from a
//           counter were slower); two at QT 32 and 64 (`ivf_tile_kernel`).
//           The eight warps' partial sums are added through
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
//
// Delta sub-lists (a streaming index's tier: rows once, in append order,
// grouped by centroid as rows perm[off[c] .. off[c + 1]); the reference
// pads them to (C, Lc, D), `_fused_dyn_ivf_topk_impl`,
// src/repro/kernels/knn_ivf/ops.py:1176).  Each probed slot p of a query
// also scores its centroid's sub-list.  Its chunks of 64 rows are further
// items of the same grid, (delta chunk, probe slot, query) after the base
// items, with ceil(dmax / 64) chunks a slot (dmax the largest sub-list):
// the same ownership per tile, the same ring of `cp.async` stages (rows
// gathered through perm) and the same fixed-order sums, so a row's score
// has the same bits whichever block computes it.  A chunk past its
// sub-list's end (an empty sub-list, a short one) is no item: its block
// leaves at once.  Keys go to the same scratch row at P L + p dmax + l, id
// n_base + row, so base rows win ties; a query's ticket target counts its
// slots' real delta chunks, and its selector masks the positions past each
// sub-list's end (k > 2,048: those chunks' blocks write zero keys instead,
// since the selection rounds read every key).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "select.cuh"

namespace {

// CUDA kernels this library has launched (`ivf_topk_device_launches`)
unsigned long long g_launches = 0;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NQ_MAX = 16;           // queries a pass over a chunk scores
constexpr int TN = 64;               // list rows a block
constexpr int RPT = TN / 32;         // rows a lane: lane, lane + 32, ...
constexpr int ROW_BYTES = 256;       // bytes of each row a ring stage
constexpr int TD = ROW_BYTES / 4;    // f32 values of a row a stage
constexpr int WARP_VALS = TD / WARPS;  // a warp's values of a row a stage
constexpr int PITCH = ROW_BYTES + 16;  // the 16-byte reads of 8 neighbouring
                                       // rows hit 32 different banks
constexpr int STAGES = 3;
constexpr int STAGE = TN * PITCH + NQ_MAX * TD * 4;
constexpr int RING = STAGES * STAGE;
constexpr int RED_PITCH = NQ_MAX + 1;
// the warps' partial sums, added in two rounds of 4 warps: (4, TN, NQ_MAX + 1)
// in the ring's place once the ring is drained
constexpr int RED = 4 * TN * RED_PITCH * 4;
// dynamic shared memory of a block: the ring, and room for the selection
// (three blocks an SM)
constexpr int SMEM = RING > 72 * 1024 ? RING : 72 * 1024;
constexpr int FK_MAX = SEL_BLOCK_KMAX;   // k of the one-launch path
static_assert(THREADS == SEL_THREADS, "a selector selects with all threads");
static_assert(RED <= RING && sel_smem(FK_MAX) <= SMEM, "shared memory");

// One list as a scan reads it: row r (< len) is rows + row(r) * D, with
// its id and inverse norm.  A base list: rows in place, ids / inv of the
// list.  A delta sub-list: rows gathered through map (perm + off[c]), id
// id_base + row, inv indexed by row.
struct ListRef {
  const float* rows;
  const int* map;          // nullptr: row(r) = r
  const int* ids;          // base lists: ids of the list's rows
  const float* inv;
  int id_base;
  int len;
  __device__ __forceinline__ long long row(int r) const {
    return map ? (long long)__ldg(map + r) : (long long)r;
  }
  __device__ __forceinline__ int id(int r) const {
    return map ? id_base + __ldg(map + r) : ids[r];
  }
};

// The chunk's keys for the nq (<= NQ) queries sq[] at slots ss[] of list
// lr, rows [l0, l0 + TN): key of (query j, row l) at keys[sq[j] n + koff +
// ss[j] stride + l].
template <int VEC, int NQ>
__device__ void scan_chunk(const float* __restrict__ q, ListRef lr,
                           u64* __restrict__ keys, int l0, int D, long long n,
                           long long koff, int stride, const int* sq,
                           const int* ss, int nq, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_bytes = (long long)D * 4;
  const int steps = (int)((row_bytes + ROW_BYTES - 1) / ROW_BYTES);
  const unsigned char* list = reinterpret_cast<const unsigned char*>(lr.rows);
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(q);
  const int L = lr.len;

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
            ok ? list + lr.row(l0 + r) * row_bytes + byte : list;
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
  // the four sums in order, * inv, one key per (query, row); a delta
  // sub-list's positions past its end up to the slot's width get empty keys
  for (int e = tid; e < TN * nq; e += THREADS) {
    const int r = e % TN, j = e / TN, l = l0 + r;
    if (l >= stride) continue;
    u64 key = 0ull;
    if (l < L) {
      float dot = red[r * RED_PITCH + j];
#pragma unroll
      for (int w = 1; w < 4; ++w) dot += red[(w * TN + r) * RED_PITCH + j];
      const int id = lr.id(l);
      key = make_key(dot * lr.inv[lr.row(l)], id, id >= 0);
    }
    keys[(long long)sq[j] * n + koff + (long long)ss[j] * stride + l] = key;
  }
}

// The delta tier of one call (dmax == 0: none)
struct Delta {
  const float* rows;
  const float* inv;
  const int* off;           // (C + 1,)
  const int* perm;
  int n_base;
  int dmax;                 // rows of the largest sub-list
  __device__ __forceinline__ int len(int cid, int C) const {
    return cid >= 0 && cid < C ? off[cid + 1] - off[cid] : 0;
  }
};

// One pass over a chunk for the nq (<= NQ_MAX) queries sq[] at slots ss[]:
// the partial sums of NQ, the served count rounded up to 1, 2, 4, 8 or 16
template <int VEC>
__device__ __forceinline__ void scan_pass(const float* __restrict__ q, ListRef lr,
                          u64* __restrict__ keys, int l0, int D, long long n,
                          long long koff, int stride, const int* sq,
                          const int* ss, int nq, unsigned char* smem) {
  if (nq == 1)
    scan_chunk<VEC, 1>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq, smem);
  else if (nq == 2)
    scan_chunk<VEC, 2>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq, smem);
  else if (nq <= 4)
    scan_chunk<VEC, 4>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq, smem);
  else if (nq <= 8)
    scan_chunk<VEC, 8>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq, smem);
  else
    scan_chunk<VEC, 16>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq,
                        smem);
}

// Waits of a selector for a ticket before it calls the run failed: the
// scan blocks never wait, so a ticket that stays short means a fault, and
// the launch traps rather than hanging the card
constexpr long long SPIN_LIMIT = 1ll << 24;   // x 256 ns: about 4 s

// A scan block: item it of (row chunk, probe slot, query), chunk fastest,
// over the base lists, then (it >= base_items) the same over the delta
// sub-lists with ceil(dmax / TN) chunks a slot.  Its role in the query
// tile of QT queries, its scan (passes of up to NQ_MAX queries), and
// (select != 0) one ticket for each query it wrote keys for.
template <int VEC, int QT>
__device__ void scan_item(long long it, long long base_items, int nchunks,
                          const float* __restrict__ q,
                          const int* __restrict__ q_probe,
                          const float* __restrict__ sup,
                          const int* __restrict__ ids,
                          const float* __restrict__ inv, Delta dl,
                          u64* __restrict__ keys, int* __restrict__ ticket,
                          int Q, int C, int L, int D, int P, int select,
                          unsigned char* smem) {
  __shared__ int first[QT];             // a tile query's first slot on cid
  __shared__ int sq[QT], ss[QT];        // the served (query, slot) pairs
  __shared__ int s_nq;
  const int tid = threadIdx.x;
  const bool delta = it >= base_items;
  if (delta) it -= base_items;
  const int nch = delta ? (dl.dmax + TN - 1) / TN : nchunks;
  const int chunk = (int)(it % nch), p = (int)(it / nch % P);
  const int qi = (int)(it / ((long long)nch * P));
  const int q0 = qi - qi % QT, nt = min(QT, Q - q0), me = qi - q0;
  const int cid = q_probe[(long long)qi * P + p];
  const bool live = cid >= 0 && cid < C;
  const long long n = (long long)P * (L + dl.dmax);   // keys a query
  const int l0 = chunk * TN;
  const int len = delta ? dl.len(cid, C) : L;
  // a delta chunk past its sub-list's end is no item, unless the selection
  // rounds (select == 0) read its positions: then its block writes zeros
  const bool empty = delta && l0 >= len;
  if (empty && select) return;

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
  const long long koff = delta ? (long long)P * L : 0;
  const int stride = delta ? dl.dmax : L;

  if (!live || empty) {
    // delta slots reach here only for the selection rounds (select == 0)
    for (int e = tid; e < TN * nq; e += THREADS) {
      const int r = e % TN, j = e / TN;
      if (l0 + r < stride)
        keys[(long long)sq[j] * n + koff + (long long)ss[j] * stride + l0 +
             r] = 0ull;
    }
    if (delta) return;
  } else {
    ListRef lr;
    if (delta) {
      lr = ListRef{dl.rows, dl.perm + dl.off[cid], nullptr, dl.inv,
                   dl.n_base, len};
    } else {
      lr = ListRef{sup + (long long)cid * L * D, nullptr,
                   ids + (long long)cid * L, inv + (long long)cid * L, 0, L};
    }
    if constexpr (QT <= NQ_MAX) {
      // one pass scores every query the tile serves
      scan_pass<VEC>(q, lr, keys, l0, D, n, koff, stride, sq, ss, nq, smem);
    } else {
      for (int g0 = 0; g0 < nq; g0 += NQ_MAX) {
        // the next pass's first copies overwrite the sums this one reads
        if (g0) __syncthreads();
        scan_pass<VEC>(q, lr, keys, l0, D, n, koff, stride, sq + g0,
                       ss + g0, min(NQ_MAX, nq - g0), smem);
      }
    }
  }
  if (!select) return;
  // the hand-over: the keys are visible before the tickets count them
  __threadfence();
  __syncthreads();
  if (tid < nq) atomicAdd(&ticket[sq[tid]], 1);
}

// A selector block: queries s, s + nsel, ... in turn, each once its ticket
// counts all its entries (P x chunks of the base lists, and the delta
// chunks of its probed sub-lists); the keys come into shared memory where
// they fit (through L2), else each pass reads them from L2.  Positions past
// a probed sub-list's end were written by no block and read as empty keys.
// Each query's ticket is reset for the next call.
__device__ void select_queries(int s, int nsel, const u64* __restrict__ keys,
                               int* __restrict__ ticket,
                               const int* __restrict__ q_probe, Delta dl,
                               float* __restrict__ out_s,
                               int* __restrict__ out_i, int Q, int C, int P,
                               int nchunks, int L, int k,
                               unsigned char* smem) {
  __shared__ int s_target;
  const int tid = threadIdx.x;
  const long long base_n = (long long)P * L;
  const long long n = base_n + (long long)P * dl.dmax;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  u64* sel = reinterpret_cast<u64*>(smem + SEL_NB * 4);
  u64* kbuf = reinterpret_cast<u64*>(smem + sel_smem(k));
  const bool fit = n * 8 <= SMEM - sel_smem(k);
  for (int qq = s; qq < Q; qq += nsel) {
    const int* pr = q_probe + (long long)qq * P;
    // whether key i (>= base_n) lies inside its slot's sub-list
    auto in_delta = [&](long long i) {
      const int e = (int)(i - base_n);
      return e % dl.dmax < dl.len(__ldg(pr + e / dl.dmax), C);
    };
    if (tid == 0) {
      int target = P * nchunks;
      for (int p = 0; p < P && dl.dmax; ++p)
        target += (dl.len(pr[p], C) + TN - 1) / TN;
      const volatile int* t = ticket + qq;
      for (long long w = 0; *t != target; ++w) {
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
      for (long long i = base_n + tid; i < n; i += THREADS)
        if (!in_delta(i)) kbuf[i] = 0ull;
      __syncthreads();
      block_topk([&](int i) { return kbuf[i]; }, (int)n, k, ~0ull, hist, sel,
                 os, oi);
    } else {
      block_topk(
          [&](int i) {
            return i < base_n || in_delta(i) ? __ldcg(row + i) : 0ull;
          },
          (int)n, k, ~0ull, hist, sel, os, oi);
    }
    if (tid == 0) ticket[qq] = 0;       // ready for the next call
  }
}

// Blocks [0, items) scan (the base items, then the delta items); with
// select != 0 (k <= FK_MAX) blocks [items, items + nsel) select.
// Tiles above 16 queries keep a pass's state live across passes: 80
// registers (three blocks an SM) spilled it; 128 (two blocks an SM) were
// as fast or faster on an H100 in every case of `launch/ab.py retrieval`
template <int VEC, int QT>
__global__ void __launch_bounds__(THREADS, QT > NQ_MAX ? 2 : 3)
ivf_tile_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                const float* __restrict__ sup, const int* __restrict__ ids,
                const float* __restrict__ inv, Delta dl,
                u64* __restrict__ keys, int* __restrict__ ticket,
                float* __restrict__ out_s, int* __restrict__ out_i, int Q,
                int C, int L, int D, int P, int k, int select,
                long long base_items, long long items, int nsel) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunks = (L + TN - 1) / TN;
  if ((long long)blockIdx.x < items)
    scan_item<VEC, QT>(blockIdx.x, base_items, nchunks, q, q_probe, sup, ids,
                       inv, dl, keys, ticket, Q, C, L, D, P, select, smem);
  else
    select_queries((int)(blockIdx.x - items), nsel, keys, ticket, q_probe,
                   dl, out_s, out_i, Q, C, P, nchunks, L, k, smem);
}

template <int VEC, int QT>
cudaError_t launch(const float* q, const int* q_probe, const float* sup,
                   const int* ids, const float* inv, Delta dl, u64* keys,
                   int* ticket, float* out_s, int* out_i, int Q, int P, int C,
                   int L, int D, int k, cudaStream_t st) {
  static_assert(QT <= THREADS, "a tile's tickets are added by one thread each");
  auto fn = ivf_tile_kernel<VEC, QT>;
  // the attribute is per device, so it is set on every launch
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
  if (e != cudaSuccess) return e;
  const long long base_items = (long long)((L + TN - 1) / TN) * P * Q;
  const long long items =
      base_items + (long long)((dl.dmax + TN - 1) / TN) * P * Q;
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
      q, q_probe, sup, ids, inv, dl, keys, ticket, out_s, out_i, Q, C, L, D,
      P, k, select, base_items, items, nsel);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++g_launches;
  if (select) return cudaSuccess;
  e = select_topk(keys, Q, P * (L + dl.dmax), k, out_s, out_i, st);
  g_launches += e == cudaSuccess ? (k + SEL_KMAX - 1) / SEL_KMAX : 0;
  return e;
}

}  // namespace

extern "C" {

// CUDA kernels launched by this library since it was loaded
unsigned long long ivf_topk_device_launches() { return g_launches; }

// dynamic shared memory of a block, bytes (the same at every query tile)
int ivf_topk_dynamic_smem() { return SMEM; }

// q (Q, D) f32; q_probe (Q, P) i32; sup (C, L, D) f32; ids / inv (C, L);
// the delta tier (dmax > 0): drows (nd, D) f32 and dinv (nd,) in append
// order, doff (C + 1,) and dperm (nd,) i32 grouping them by centroid, ids
// n_base + row; keys (Q, P * (L + dmax)) u64 scratch; ticket (Q,) int32
// holding zeros (left zero by the call; unused above k = 2,048); out
// (Q, k); qt the query tile (8, 16, 32 or 64; any other value is refused).
int ivf_topk_launch(const void* q, const void* q_probe, const void* sup,
                    const void* ids, const void* inv, const void* drows,
                    const void* dinv, const void* doff, const void* dperm,
                    void* keys, void* ticket, void* out_s, void* out_i, int Q,
                    int P, int C, int L, int D, int k, int n_base, int dmax,
                    int qt, void* stream) {
  const long long chunks = (L + TN - 1) / TN + (dmax + TN - 1) / TN;
  if (k < 1 || Q < 1 || P < 1 || L < 1 || D < 1 || dmax < 0 ||
      (dmax > 0 && (!drows || !dinv || !doff || !dperm)) ||
      (long long)P * (L + dmax) > INT_MAX ||
      chunks * P * Q + Q > INT_MAX ||
      (qt != 8 && qt != 16 && qt != 32 && qt != 64))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const bool v16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(sup) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(drows) % 16 == 0;
  const Delta dl{static_cast<const float*>(drows),
                 static_cast<const float*>(dinv),
                 static_cast<const int*>(doff),
                 static_cast<const int*>(dperm), n_base, dmax};
  auto args = [&](auto fn) {
    return (int)fn(static_cast<const float*>(q),
                   static_cast<const int*>(q_probe),
                   static_cast<const float*>(sup),
                   static_cast<const int*>(ids),
                   static_cast<const float*>(inv), dl, static_cast<u64*>(keys),
                   static_cast<int*>(ticket), static_cast<float*>(out_s),
                   static_cast<int*>(out_i), Q, P, C, L, D, k, st);
  };
  switch (qt) {
    case 8: return v16 ? args(launch<16, 8>) : args(launch<4, 8>);
    case 16: return v16 ? args(launch<16, 16>) : args(launch<4, 16>);
    case 32: return v16 ? args(launch<16, 32>) : args(launch<4, 32>);
    default: return v16 ? args(launch<16, 64>) : args(launch<4, 64>);
  }
}

}  // extern "C"
