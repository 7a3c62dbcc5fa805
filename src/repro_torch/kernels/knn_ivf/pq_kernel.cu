// IVF-PQ asymmetric-distance (ADC) shortlist over packed code-major lists,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/knn_ivf/pq_kernel.py:114
// `ivfpq_adc_pallas` (`_adc_kernel` :48): per query, LUT[j, c] =
// q_j . codebook[j, c] for each subspace j; per probed row
// score = (sum_j LUT[j, code_j] + q . anchor_c) * inv, masked to ids >= 0,
// then the top-kk shortlist; scores f32 descending, ids int32 (ties to the
// lower row id), -inf / -1 in slots no valid row fills.
//
// What bounds it on an H100: at the serving shape (16 queries, nprobe 8,
// L 400, m 64, nbits 8) the codes are 16 x 8 x 400 x 64 bytes = 3.3 MB and
// the codebooks 0.8 MB, about 1 us of HBM time, and the gathers are a few
// million shared-memory reads.  So it is bound by latency and launches:
// the byte bound is below the cost of one launch, and "faster" means one
// launch with every intermediate on chip.
//
// The TPU builds the table with one matmul against a block-diagonal
// codebook expansion and scores codes through an m-hot matmul, because
// Mosaic has no dynamic VMEM gather.  Hopper gathers from shared memory
// directly.  Two paths, chosen by shape (the wrapper's `fused_fits`):
//
// Fused (one launch; kk <= 2,048 and a block's lists' codes and the
// query's P x L keys fit in shared memory, which covers the serving shape):
//   grid    a cluster of 8 blocks per query (`cudaLaunchKernelEx` with a
//           cluster dimension; `cudaOccupancyMaxActiveClusters` must report
//           at least one resident cluster, or the launch is refused).  Block
//           rank r takes the probes p = r (mod 8).  Two blocks fit an SM, so
//           16 queries run in one wave.
//   codes   each probed list's MB x L bytes come into shared memory through
//           `cp.async` while the table is built.
//   table   block r computes subspaces [r m / 8, (r + 1) m / 8) of its
//           query's table straight from q and the codebooks and stores each
//           entry into all eight blocks' tables (DSMEM stores), so the
//           cluster reads the codebooks from L2 once, not eight times.  No
//           table in device memory, no table launch.
//   score   one thread per list row gathers from the shared table; each
//           block's 64-bit keys (`select.cuh`) go into the leader block's
//           shared memory (DSMEM stores, in place of its codes).
//   select  the leader selects the top kk of the query's keys in its shared
//           memory (`block_topk`, select.cuh: 11-, 11- and 10-bit digits
//           over the score's 32 bits, then over the id bits, stopping once
//           the digit's bin holds just the keys still needed; the survivors
//           sorted in registers, warp shuffles and shared memory).
//           Summing the eight blocks' histograms by DSMEM loads on every
//           pass was slower on an H100 than the whole select on one block
//           (the loads' round trips): the cluster shares data by stores
//           only.
//
// Three launches (any other shape: nprobe near the number of lists, or
// kk > 2,048):
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
//   select  one block per query picks the top-kk (`select_topk`,
//           select.cuh).
// A table larger than LUT_MAX_BYTES does not fit beside the block's other
// shared memory; the launch refuses it (the wrapper raises first).
//
// Delta sub-lists (a streaming index's tier, `_fused_dyn_ivfpq_topk_impl`,
// src/repro/kernels/knn_ivf/ops.py:1231): the rows' residual codes against
// their own centroid's anchor, with the base codebooks, stored code-major
// (MB, >= nd) in append order and grouped by centroid as rows
// perm[off[c] .. off[c + 1]).  The slot that probes list c also scores c's
// sub-list with the same table and the same anchor dot; its keys sit at
// P L + p dmax + l of the query's keys (dmax the largest sub-list), id
// n_base + row, zero past the sub-list's end, so base rows win ties.  On
// the fused path the block that scans a probed list scores its sub-list
// too, reading the codes through L2 (a sub-list may be longer than a
// block's shared memory), and stores the keys straight into the leader's
// (DSMEM); the leader selects over P (L + dmax) keys.  On the three
// launches the scan block of slot p does the same into the keys in device
// memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "select.cuh"
#include "../topk_common.cuh"

namespace cg = cooperative_groups;

namespace {

// CUDA kernels this library has launched (`ivfpq_adc_device_launches`)
unsigned long long g_launches = 0;

constexpr int SCAN_THREADS = 256;
constexpr int LUT_MAX_BYTES = 200 * 1024;
constexpr int CL = 8;               // blocks a query (a cluster)
constexpr int FT = 256;             // threads a fused block
static_assert(FT == SEL_THREADS, "the leader selects with the whole block");
constexpr int FK_MAX = 2048;        // kk of the fused path
constexpr int FUSED_SMEM_MAX = 226 * 1024;   // beside the static shared memory

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

// The delta tier of one call (dmax == 0: none): codes (MB, stride) u8
// code-major, inv (nd,), off (C + 1,), perm (nd,)
struct Delta {
  const unsigned char* codes;
  const float* inv;
  const int* off;
  const int* perm;
  int n_base;
  int dmax;
  long long stride;
};

// ADC score of code column `col` (bytes col, col + stride, ...) against the
// table: the same loop, in the same order, as a base row's
template <int NBITS>
__device__ __forceinline__ float adc_sum(const float* lut,
                                         const unsigned char* cl,
                                         long long stride, int MB) {
  float acc = 0.f;
  if (NBITS == 8) {
#pragma unroll 8
    for (int b = 0; b < MB; ++b) acc += lut[(b << 8) + cl[b * stride]];
  } else {
#pragma unroll 4
    for (int b = 0; b < MB; ++b) {
      const int byte = cl[b * stride];
      acc += lut[(2 * b) * 16 + (byte & 0xF)];
      acc += lut[(2 * b + 1) * 16 + (byte >> 4)];
    }
  }
  return acc;
}

// Key of row l (< dmax) of slot cid's delta sub-list: 0 past its end or for
// a probe id out of range
template <int NBITS>
__device__ __forceinline__ u64 delta_key(const float* lut, Delta dl, int cid,
                                         int C, int l, float aq, int MB) {
  if (cid < 0 || cid >= C) return 0ull;
  const int o = dl.off[cid];
  if (l >= dl.off[cid + 1] - o) return 0ull;
  const int row = __ldg(dl.perm + o + l);
  const float acc = adc_sum<NBITS>(lut, dl.codes + row, dl.stride, MB);
  return make_key((acc + aq) * dl.inv[row], dl.n_base + row, true);
}

__global__ void __launch_bounds__(SCAN_THREADS)
adc_scan_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                const unsigned char* __restrict__ codes,
                const int* __restrict__ ids, const float* __restrict__ inv,
                const float* __restrict__ anchors,
                const float* __restrict__ lut_g, Delta dl,
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

  const size_t n = (size_t)P * (L + dl.dmax);
  unsigned long long* out = keys + (size_t)qi * n + (size_t)p * L;
  for (int l = tid; l < L; l += SCAN_THREADS) {
    if (!live) {
      out[l] = 0ull;
      continue;
    }
    const unsigned char* cl = codes + (size_t)cid * MB * L + l;
    const float acc = nbits == 8 ? adc_sum<8>(lut, cl, L, MB)
                                 : adc_sum<4>(lut, cl, L, MB);
    const size_t row = (size_t)cid * L + l;
    const int id = ids[row];
    out[l] = make_key((acc + aq) * inv[row], id, id >= 0);
  }
  // this slot's delta sub-list, padded with zero keys to dmax
  unsigned long long* dout =
      keys + (size_t)qi * n + (size_t)P * L + (size_t)p * dl.dmax;
  for (int l = tid; l < dl.dmax; l += SCAN_THREADS)
    dout[l] = nbits == 8 ? delta_key<8>(lut, dl, cid, C, l, aq, MB)
                         : delta_key<4>(lut, dl, cid, C, l, aq, MB);
}


__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of a fused block, in three regions: the table (which
// the leader reuses for its selection's histogram and sort buffer once every
// row is scored), this block's lists' codes (which the leader reuses for all
// P x (L + dmax) keys of its query), and this block's keys with its anchor
// dots.
struct FusedSmem {
  int lut, codes, keys, total;
  __host__ __device__ FusedSmem(int m, int nbits, int MB, int L, int P,
                                int kk, int dmax) {
    const int PB = (P + CL - 1) / CL;
    lut = align16(imax(m * (1 << nbits) * 4, sel_smem(kk)));
    codes = align16(imax(PB * align16(MB * L), P * (L + dmax) * 8));
    keys = align16(PB * L * 8 + PB * 4);
    total = lut + codes + keys;
  }
};

__host__ __device__ inline int fused_smem(int m, int nbits, int MB, int L,
                                          int P, int kk, int dmax) {
  return FusedSmem(m, nbits, MB, L, P, kk, dmax).total;
}

template <int NBITS>
__global__ void __launch_bounds__(FT, 2)
adc_fused_kernel(const float* __restrict__ q, const int* __restrict__ q_probe,
                 const unsigned char* __restrict__ codes,
                 const int* __restrict__ ids, const float* __restrict__ inv,
                 const float* __restrict__ anchors,
                 const float* __restrict__ cb, Delta dl,
                 float* __restrict__ out_s, int* __restrict__ out_i, int C,
                 int MB, int L, int D, int P, int m, int kk) {
  constexpr int K = 1 << NBITS;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int qi = blockIdx.y, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int PB = (P + CL - 1) / CL;
  const int CB = align16(MB * L);
  const FusedSmem lay(m, NBITS, MB, L, P, kk, dl.dmax);
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                   // (m, K)
  unsigned char* cs = smem + lay.lut;                            // PB x CB
  u64* keys = reinterpret_cast<u64*>(cs + lay.codes);            // PB x L
  float* aq = reinterpret_cast<float*>(keys + PB * L);           // PB
  // the leader's reuse, once every block has scored its rows
  u64* all = reinterpret_cast<u64*>(cs);                         // P x L
  unsigned* hist = reinterpret_cast<unsigned*>(smem);            // SEL_NB
  u64* sorted = reinterpret_cast<u64*>(smem + SEL_NB * 4);       // sel_width
  __shared__ float red[FT / 32];

  // codes of this block's probed lists, in flight while the table is built
  const bool v16 = (MB * L) % 16 == 0;
  for (int j = 0; j < PB; ++j) {
    const int p = r + CL * j;
    const int cid = p < P ? q_probe[(long long)qi * P + p] : -1;
    if (cid < 0 || cid >= C) continue;
    const unsigned char* src = codes + (long long)cid * MB * L;
    unsigned char* dst = cs + j * CB;
    if (v16) {
      for (int e = tid * 16; e < MB * L; e += FT * 16)
        cp_async16_zfill(dst + e, src + e, true);
    } else {
      for (int e = tid * 4; e < MB * L; e += FT * 4)
        cp_async4_zfill(dst + e, src + e, true);
    }
  }
  cp_async_commit();
  // a block may store into another's shared memory only once every block
  // of the cluster has started: arrive now, wait before the first store,
  // so the code copies and the anchor dots run meanwhile
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // q . anchor of each probed list, reduced as adc_scan_kernel does
  for (int j = 0; j < PB; ++j) {
    const int p = r + CL * j;
    const int cid = p < P ? q_probe[(long long)qi * P + p] : -1;
    float a = 0.f;
    if (cid >= 0 && cid < C)
      for (int d = tid; d < D; d += FT)
        a = fmaf(q[(long long)qi * D + d], anchors[(long long)cid * D + d], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) red[warp] = a;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < FT / 32; ++w) t += red[w];
      aq[j] = t;
    }
    __syncthreads();
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // this block's slice of the table, in adc_lut_kernel's arithmetic, stored
  // into every block of the cluster (DSMEM stores, no round trip)
  const int dsub = D / m;
  const int msl = (m + CL - 1) / CL;
  const int j0 = min(m, r * msl), j1 = min(m, j0 + msl);
  float* peer_lut[CL];
#pragma unroll
  for (int rr = 0; rr < CL; ++rr) peer_lut[rr] = cluster.map_shared_rank(lut, rr);
  // four entries a thread at a time, so their codebook loads are in
  // flight together
  constexpr int EB = 4;
  const int n_ent = (j1 - j0) * K;
  for (int e0 = tid; e0 < n_ent; e0 += FT * EB) {
    const float* qv[EB];
    const float* ev[EB];
    float acc[EB];
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int e = min(e0 + u * FT, n_ent - 1);
      const int j = j0 + e / K, c = e % K;
      qv[u] = q + (long long)qi * D + (long long)j * dsub;
      ev[u] = cb + ((long long)j * K + c) * dsub;
      acc[u] = 0.f;
    }
    if (dsub % 4 == 0) {                  // 16-byte loads, same FMA order
      for (int d = 0; d < dsub; d += 4) {
#pragma unroll
        for (int u = 0; u < EB; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(qv[u] + d);
          const float4 y = *reinterpret_cast<const float4*>(ev[u] + d);
          acc[u] = fmaf(x.x, y.x, acc[u]);
          acc[u] = fmaf(x.y, y.y, acc[u]);
          acc[u] = fmaf(x.z, y.z, acc[u]);
          acc[u] = fmaf(x.w, y.w, acc[u]);
        }
      }
    } else {
      for (int d = 0; d < dsub; ++d) {
#pragma unroll
        for (int u = 0; u < EB; ++u)
          acc[u] = fmaf(qv[u][d], ev[u][d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int e = e0 + u * FT;
      if (e >= n_ent) break;
      const int at = (j0 + e / K) * K + e % K;
#pragma unroll
      for (int rr = 0; rr < CL; ++rr) peer_lut[rr][at] = acc[u];
    }
  }
  cp_async_wait<0>();
  cluster.sync();                         // every table is whole

  // one thread per list row; keys kept in this block's shared memory
  for (int j = 0; j < PB; ++j) {
    const int p = r + CL * j;
    const int cid = p < P ? q_probe[(long long)qi * P + p] : -1;
    const bool live = cid >= 0 && cid < C;
    const unsigned char* cl = cs + j * CB;
    for (int l = tid; l < L; l += FT) {
      u64 key = 0ull;
      if (live) {
        const float acc = adc_sum<NBITS>(lut, cl + l, L, MB);
        const long long row = (long long)cid * L + l;
        const int id = ids[row];
        key = make_key((acc + aq[j]) * inv[row], id, id >= 0);
      }
      keys[j * L + l] = key;
    }
  }
  cluster.sync();                         // the leader's codes are free
  {
    u64* dst = cluster.map_shared_rank(all, 0);
    for (int j = 0; j < PB; ++j) {
      const int p = r + CL * j;
      if (p >= P) break;
      for (int l = tid; l < L; l += FT) dst[p * L + l] = keys[j * L + l];
      // the slot's delta sub-list, scored into the leader's keys directly
      const int cid = q_probe[(long long)qi * P + p];
      for (int l = tid; l < dl.dmax; l += FT)
        dst[P * L + p * dl.dmax + l] =
            delta_key<NBITS>(lut, dl, cid, C, l, aq[j], MB);
    }
  }
  cluster.sync();                         // the leader holds every key
  if (r != 0) return;

  // the leader: the top kk of the query's P x (L + dmax) keys
  block_topk([&](int e) { return all[e]; }, P * (L + dl.dmax), kk, ~0ull,
             hist, sorted, out_s + (long long)qi * kk,
             out_i + (long long)qi * kk);
}

// The fused launch's configuration; clusters receives how many clusters of
// 8 can be resident at once (0: the shape cannot run fused on this device).
template <int NBITS>
cudaError_t fused_config(int Q, int smem, cudaStream_t st,
                         cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                         int* clusters) {
  auto fn = adc_fused_kernel<NBITS>;
  *clusters = 0;
  if (smem > FUSED_SMEM_MAX) return cudaSuccess;
  // the attribute is per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL, Q > 0 ? Q : 1);
  cfg->blockDim = dim3(FT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)fn, cfg);
}

template <int NBITS>
int fused_launch(const float* q, const int* q_probe, const unsigned char* codes,
                 const int* ids, const float* inv, const float* anchors,
                 const float* cb, Delta dl, float* out_s, int* out_i, int Q,
                 int P, int C, int MB, int L, int D, int m, int kk,
                 cudaStream_t st) {
  const int smem = fused_smem(m, NBITS, MB, L, P, kk, dl.dmax);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t e = fused_config<NBITS>(Q, smem, st, &cfg, &attr, &clusters);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, adc_fused_kernel<NBITS>, q, q_probe, codes,
                         ids, inv, anchors, cb, dl, out_s, out_i, C, MB, L, D,
                         P, m, kk);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  g_launches += e == cudaSuccess;
  return (int)e;
}

}  // namespace

extern "C" {

// CUDA kernels launched by this library since it was loaded
unsigned long long ivfpq_adc_device_launches() { return g_launches; }

// Shared memory a fused block of this shape takes, and how many clusters of
// 8 such blocks the device can hold at once (0: it cannot run fused).
int ivfpq_adc_fused_plan(int m, int nbits, int MB, int L, int P, int kk,
                         int dmax, int* smem, int* clusters) {
  if (m < 1 || L < 1 || P < 1 || kk < 1 || dmax < 0 ||
      !(nbits == 4 || nbits == 8))
    return (int)cudaErrorInvalidValue;
  *smem = fused_smem(m, nbits, MB, L, P, kk, dmax);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return nbits == 8
             ? (int)fused_config<8>(1, *smem, nullptr, &cfg, &attr, clusters)
             : (int)fused_config<4>(1, *smem, nullptr, &cfg, &attr, clusters);
}

// q (Q, D) f32; q_probe (Q, P) i32; codes (C, MB, L) u8; ids / inv (C, L);
// anchors (C, D) f32; cb (m, 2^nbits, D / m) f32; the delta tier (dmax >
// 0): dcodes (MB, dstride) u8 code-major and dinv (nd,) in append order,
// doff (C + 1,) and dperm (nd,) i32 grouping them by centroid, ids n_base +
// row; out (Q, k).  fused != 0: one launch (k <= 2,048, (MB L) % 4 == 0,
// the block's shared memory within the limit; lut and keys unused).
// Otherwise lut (Q, m, 2^nbits) f32 and keys (Q, P * (L + dmax)) u64
// scratch for the three launches.
int ivfpq_adc_launch(const void* q, const void* q_probe, const void* codes,
                     const void* ids, const void* inv, const void* anchors,
                     const void* cb, const void* dcodes, const void* dinv,
                     const void* doff, const void* dperm, void* lut,
                     void* keys, void* out_s, void* out_i, int Q, int P, int C,
                     int MB, int L, int D, int m, int nbits, int k, int fused,
                     int n_base, int dmax, int dstride, void* stream) {
  if (k < 1 || Q < 1 || P < 1 || L < 1 || m < 1 || D % m || dmax < 0 ||
      (dmax > 0 && (!dcodes || !dinv || !doff || !dperm || dstride < 1)) ||
      (long long)P * (L + dmax) > INT_MAX ||
      !(nbits == 8 ? MB == m : nbits == 4 && 2 * MB == m))
    return (int)cudaErrorInvalidValue;
  const Delta dl{static_cast<const unsigned char*>(dcodes),
                 static_cast<const float*>(dinv),
                 static_cast<const int*>(doff),
                 static_cast<const int*>(dperm), n_base, dmax, dstride};
  const int K = 1 << nbits;
  const int smem = m * K * (int)sizeof(float);
  if (smem > LUT_MAX_BYTES) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  if (fused) {
    if (k > FK_MAX || (MB * L) % 4) return (int)cudaErrorInvalidValue;
    auto args = [&](auto launch) {
      return launch(qf, static_cast<const int*>(q_probe),
                    static_cast<const unsigned char*>(codes),
                    static_cast<const int*>(ids),
                    static_cast<const float*>(inv),
                    static_cast<const float*>(anchors),
                    static_cast<const float*>(cb), dl,
                    static_cast<float*>(out_s), static_cast<int*>(out_i), Q,
                    P, C, MB, L, D, m, k, st);
    };
    return nbits == 8 ? args(fused_launch<8>) : args(fused_launch<4>);
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto lp = static_cast<float*>(lut);
  auto kp = static_cast<unsigned long long*>(keys);
  adc_lut_kernel<<<dim3(m, Q), K < SCAN_THREADS ? K : SCAN_THREADS, 0, st>>>(
      qf, static_cast<const float*>(cb), lp, D, m, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++g_launches;
  adc_scan_kernel<<<dim3(P, Q), SCAN_THREADS, smem, st>>>(
      qf, static_cast<const int*>(q_probe),
      static_cast<const unsigned char*>(codes), static_cast<const int*>(ids),
      static_cast<const float*>(inv), static_cast<const float*>(anchors), lp,
      dl, kp, C, MB, L, D, P, m, nbits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++g_launches;
  g_launches += (k + SEL_KMAX - 1) / SEL_KMAX;
  return (int)select_topk(kp, Q, P * (L + dmax), k,
                          static_cast<float*>(out_s),
                          static_cast<int*>(out_i), st);
}

}  // extern "C"
