// AdamW's global-norm clip and its update over every leaf of a model, as
// two multi-tensor passes for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX trainer (`repro.training.optimizer`)
// leaves AdamW to XLA, which fuses its elementwise chain.  The port's
// `_foreach` chain (`training/optimizer.py` `_adamw`) runs about 19
// multi-tensor passes a step, each writing f32 temporaries: about 190 bytes
// of traffic a parameter where the work needs 30.
//
// What bounds it on an H100: bytes.  A bf16 parameter needs one read of
// its gradient for the norm (2 bytes), then reads of g, m, v and the f32
// master (14) and writes of m, v, the master and the parameter (14): 1.83 B
// parameters (h2o-danube-1.8b) move 55 GB, 16 ms at 3.35 TB/s.  The
// arithmetic, three IEEE divisions and a square root an element, is a few
// ms on the FMA units.
//
// Design.
//   leaves  a launch takes up to MAX_LEAVES leaves in its parameter block
//           (`Leaves`: pointers, sizes, each leaf's first block and its
//           flags), so no pointer table is copied to the device; the
//           wrapper (`ops.py` `plan`) cuts a model's leaves into as many
//           launches as their count needs.  Block b of a launch works on
//           CHUNK elements of the leaf whose block range holds b (a binary
//           search over `start`), at a 64-bit offset.
//   loads   4 elements a thread at a time (16 bytes of f32, 8 of bf16)
//           where every pointer of the leaf is aligned for it (flag
//           VECTOR), else one; the last block of a leaf takes the elements
//           past a multiple of 4 one at a time.
//   norm    `sumsq_kernel` writes one f32 partial sum of g^2 a block (each
//           thread's fused multiply-adds, then a fixed tree over the
//           block); `finish_kernel`, one block, adds the partials in f64 in
//           a fixed order and writes the norm and the clip's scale
//           min(clip / (norm + tiny), 1) to device scalars, or the f64 sum
//           itself (a sharded model's local shards, all-reduced by the
//           caller).  No atomics: repeats give the same bits.
//   update  `adamw_kernel` reads g, m, v and the master once and writes m,
//           v, the master and the parameter (in its dtype) once, in the
//           order and roundings of the `_foreach` chain's per-leaf formula.
//           The `__f*_rn` intrinsics keep nvcc from contracting a product
//           and a sum into a fused multiply-add that the chain does not
//           run, so the results are its bits.  The scale, the learning
//           rate and the bias corrections are read from device scalars, so
//           a step captured in a CUDA graph replays with the next step's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 64;        // ops.MAX_LEAVES
constexpr int CHUNK = 16384;          // ops.CHUNK: elements a block
constexpr int THREADS = 256;
constexpr int FINISH_THREADS = 1024;
// a leaf's flags (ops.G_BF16, ops.P_BF16, ops.VECTOR)
constexpr unsigned char G_BF16 = 1, P_BF16 = 2, VECTOR = 4;

struct Leaves {
  const void* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  float* w[MAX_LEAVES];               // the f32 master
  void* p[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int start[MAX_LEAVES + 1];          // first block of each leaf; [count] = grid
  unsigned char flags[MAX_LEAVES];
  int count;
};

// device scalars of the step, and the constants as f32 (the values the
// `_foreach` ops receive)
struct Hyper {
  const float* scale;
  const float* lr;
  const float* bc1;
  const float* bc2;
  float b1, omb1, b2, omb2, eps, wd;
};

struct Step {
  float scale, lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ int leaf_of(const Leaves& L, int b) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.start[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float load1(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int i, float x) { p[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// A sum over the block in a fixed order (thread 0 holds it).
template <typename T, int NT>
__device__ __forceinline__ T block_sum(T x) {
  __shared__ T warp[NT / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = x;
  __syncthreads();
  x = T(0);
  if (threadIdx.x < 32) {
    x = threadIdx.x < NT / 32 ? warp[threadIdx.x] : T(0);
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// ---- norm -----------------------------------------------------------------

template <typename G>
__device__ __forceinline__ float sumsq_slice(const G* g, int n, bool vec) {
  float acc = 0.f;
  int k0 = 0;
  if (vec) {
    const int nv = n >> 2;
#pragma unroll 4
    for (int k = threadIdx.x; k < nv; k += THREADS) {
      const float4 x = load4(g + 4 * k);
      acc = fmaf(x.x, x.x, acc);
      acc = fmaf(x.y, x.y, acc);
      acc = fmaf(x.z, x.z, acc);
      acc = fmaf(x.w, x.w, acc);
    }
    k0 = nv << 2;
  }
  for (int k = k0 + threadIdx.x; k < n; k += THREADS) {
    const float x = load1(g, k);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const __grid_constant__ Leaves L, float* __restrict__ partial) {
  const int i = leaf_of(L, blockIdx.x);
  const long long off = (long long)(blockIdx.x - L.start[i]) * CHUNK;
  const int n = (int)min((long long)CHUNK, L.n[i] - off);
  const bool vec = L.flags[i] & VECTOR;
  float acc = (L.flags[i] & G_BF16)
      ? sumsq_slice(static_cast<const __nv_bfloat16*>(L.g[i]) + off, n, vec)
      : sumsq_slice(static_cast<const float*>(L.g[i]) + off, n, vec);
  acc = block_sum<float, THREADS>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const float* __restrict__ partial, long long count, float clip,
              float tiny, float* gnorm, float* scale, double* sumsq) {
  double acc = 0.0;
  for (long long k = threadIdx.x; k < count; k += FINISH_THREADS)
    acc += (double)partial[k];
  acc = block_sum<double, FINISH_THREADS>(acc);
  if (threadIdx.x == 0 && sumsq) *sumsq = acc;
  if (threadIdx.x == 0 && gnorm) {
    const float gn = __fsqrt_rn((float)acc);
    // torch: clamp(clip / (gn + tiny), max=1), the division as
    // reciprocal(gn + tiny) * clip; a NaN norm gives a NaN scale
    const float sc = __fmul_rn(__frcp_rn(__fadd_rn(gn, tiny)), clip);
    *gnorm = gn;
    *scale = sc > 1.f ? 1.f : sc;
  }
}

// ---- update ---------------------------------------------------------------

// One element, in the `_foreach` chain's order:
//   g = g scale;  m = m b1 + g (1 - b1);  v = v b2 + (g (1 - b2)) g;
//   den = sqrt(v / bc2) + eps;  upd = (m / bc1) / den + w wd;
//   w = w - upd lr
__device__ __forceinline__ void adamw1(const Step& s, float g, float& m,
                                       float& v, float& w) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, s.omb2), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den),
                              __fmul_rn(w, s.wd));
  w = __fsub_rn(w, __fmul_rn(upd, s.lr));
}

template <typename G, typename P>
__device__ __forceinline__ void adamw_slice(const Step& s, const G* g,
                                            float* m, float* v, float* w,
                                            P* p, int n, bool vec) {
  int k0 = 0;
  if (vec) {
    const int nv = n >> 2;
#pragma unroll 2
    for (int k = threadIdx.x; k < nv; k += THREADS) {
      const float4 gg = load4(g + 4 * k);
      float4 mm = load4(m + 4 * k), vv = load4(v + 4 * k),
             ww = load4(w + 4 * k);
      adamw1(s, gg.x, mm.x, vv.x, ww.x);
      adamw1(s, gg.y, mm.y, vv.y, ww.y);
      adamw1(s, gg.z, mm.z, vv.z, ww.z);
      adamw1(s, gg.w, mm.w, vv.w, ww.w);
      store4(m + 4 * k, mm);
      store4(v + 4 * k, vv);
      store4(w + 4 * k, ww);
      store4(p + 4 * k, ww);
    }
    k0 = nv << 2;
  }
  for (int k = k0 + threadIdx.x; k < n; k += THREADS) {
    float mm = m[k], vv = v[k], ww = w[k];
    adamw1(s, load1(g, k), mm, vv, ww);
    m[k] = mm;
    v[k] = vv;
    w[k] = ww;
    store1(p, k, ww);
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_kernel(const __grid_constant__ Leaves L, const Hyper h) {
  const int i = leaf_of(L, blockIdx.x);
  const long long off = (long long)(blockIdx.x - L.start[i]) * CHUNK;
  const int n = (int)min((long long)CHUNK, L.n[i] - off);
  const Step s{*h.scale, *h.lr, *h.bc1, *h.bc2, h.b1, h.omb1, h.b2, h.omb2,
               h.eps, h.wd};
  const unsigned char f = L.flags[i];
  const bool vec = f & VECTOR;
  float* m = L.m[i] + off;
  float* v = L.v[i] + off;
  float* w = L.w[i] + off;
  switch (f & (G_BF16 | P_BF16)) {
    case 0:
      adamw_slice(s, static_cast<const float*>(L.g[i]) + off, m, v, w,
                  static_cast<float*>(L.p[i]) + off, n, vec);
      break;
    case G_BF16:
      adamw_slice(s, static_cast<const __nv_bfloat16*>(L.g[i]) + off, m, v, w,
                  static_cast<float*>(L.p[i]) + off, n, vec);
      break;
    case P_BF16:
      adamw_slice(s, static_cast<const float*>(L.g[i]) + off, m, v, w,
                  static_cast<__nv_bfloat16*>(L.p[i]) + off, n, vec);
      break;
    default:
      adamw_slice(s, static_cast<const __nv_bfloat16*>(L.g[i]) + off, m, v, w,
                  static_cast<__nv_bfloat16*>(L.p[i]) + off, n, vec);
  }
}

// The parameter block of one launch; false where the table is malformed.
bool pack(Leaves& L, int count, const void* const* g, float* const* m,
          float* const* v, float* const* w, void* const* p,
          const long long* n, const int* start, const unsigned char* flags) {
  if (count < 1 || count > MAX_LEAVES || start[0] != 0) return false;
  L = Leaves{};
  L.count = count;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1 || start[i + 1] - start[i] != (int)((n[i] + CHUNK - 1) / CHUNK))
      return false;
    L.g[i] = g[i];
    if (m) {
      L.m[i] = m[i];
      L.v[i] = v[i];
      L.w[i] = w[i];
      L.p[i] = p[i];
    }
    L.n[i] = n[i];
    L.start[i] = start[i];
    L.flags[i] = flags[i];
  }
  L.start[count] = start[count];
  return true;
}

}  // namespace

extern "C" {

// Partial sums of g^2 over ``count`` leaves: one f32 a block into
// ``partial`` (start[count] of them).  g[i] bf16 (flags G_BF16) or f32,
// n[i] >= 1 elements, start[i] the leaf's first block (ceil(n / CHUNK)
// blocks a leaf).
int adamw_sumsq_launch(int count, const void* const* g, const long long* n,
                       const int* start, const unsigned char* flags,
                       void* partial, void* stream) {
  Leaves L;
  if (!pack(L, count, g, nullptr, nullptr, nullptr, nullptr, n, start, flags))
    return (int)cudaErrorInvalidValue;
  sumsq_kernel<<<start[count], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

// The sum of ``count`` partials: into the f64 device scalar ``sumsq``
// where it is not null; and where ``gnorm`` is not null, the norm
// sqrt(sum) and the clip's scale min(clip / (norm + tiny), 1), each into an
// f32 device scalar (``gnorm``, ``scale``).
int adamw_norm_finish(const void* partial, long long count, float clip,
                      float tiny, void* gnorm, void* scale, void* sumsq,
                      void* stream) {
  if (count < 0 || (gnorm && !scale)) return (int)cudaErrorInvalidValue;
  finish_kernel<<<1, FINISH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), count, clip, tiny,
      static_cast<float*>(gnorm), static_cast<float*>(scale),
      static_cast<double*>(sumsq));
  return (int)cudaGetLastError();
}

// One AdamW step over ``count`` leaves in place: m, v, the f32 master w and
// the parameter p (bf16 with P_BF16, else f32).  scale, lr, bc1 and bc2 are
// f32 device scalars; b1 ... wd the f32 constants (omb1 = 1 - b1 and omb2 =
// 1 - b2 as computed in double and rounded once).
int adamw_update_launch(int count, const void* const* g, float* const* m,
                        float* const* v, float* const* w, void* const* p,
                        const long long* n, const int* start,
                        const unsigned char* flags, const void* scale,
                        const void* lr, const void* bc1, const void* bc2,
                        float b1, float omb1, float b2, float omb2, float eps,
                        float wd, void* stream) {
  Leaves L;
  if (!m || !v || !w || !p ||
      !pack(L, count, g, m, v, w, p, n, start, flags))
    return (int)cudaErrorInvalidValue;
  const Hyper h{static_cast<const float*>(scale), static_cast<const float*>(lr),
                static_cast<const float*>(bc1), static_cast<const float*>(bc2),
                b1, omb1, b2, omb2, eps, wd};
  adamw_kernel<<<start[count], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(L, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
