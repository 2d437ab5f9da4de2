// The AdamW update of every parameter leaf in two multi-tensor launches, for
// Hopper (sm_90a), hand-written.
//
// The reference has no Pallas kernel here: its update (src/repro/optim/
// adamw.py, `adamw_update`) is jnp code that XLA fuses into the train step
// it jits (src/repro/launch/train.py, `jax.jit(make_train_step(...))`).
// The port's plain update (kernels/adamw.py, `adamw_update_plain`) runs it
// leaf by leaf in about twenty float32 passes with temporaries of each
// leaf's size.  These two kernels are that update, term for term:
//
//   norm launch    gn = sqrt(Σ over leaves of Σ g²), scale = clamp(max_norm
//                  / (gn + 1e-9), max=1), both to device scalars;
//   update launch  per element, in float32, each operation rounded alone:
//                    g   = g·scale
//                    m   = b1·m + (1−b1)·g
//                    v   = b2·v + ((1−b2)·g)·g
//                    p   = p − lr·((m/b1t) / (sqrt(v/b2t) + eps) + wd·p)
//                  p, m and v cast back to their dtypes (round to nearest
//                  even, as `.to()`); float32 or bf16 parameters, gradients
//                  and moments, in any mix.
//
// Every operation is __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn, so nothing contracts into an FMA and each result is the
// plain version's bits (PyTorch's elementwise kernels round each op alone;
// `max_norm / x` on a tensor is `x.reciprocal() * max_norm` there, and so
// here).  lr, 1−b1^t and 1−b2^t are read from device scalars (the step
// counter lives on the device), so a captured graph replays them.
//
// The leaves.  One launch takes a table of up to kMaxLeaves leaves, passed
// by value as a __grid_constant__ parameter (CUDA 12.1+ on sm_70+ allows
// 32 KB of them): each leaf's pointers, length, dtypes and first block.  A
// block is one chunk of kChunk elements of one leaf (a binary search of the
// table's first blocks); more leaves take further launches in leaf order.
//
// The norm's sums are in a fixed order, so every launch gives the same
// bits and the plain version (`adamw_norm_plain`) repeats them: thread t of
// a chunk sums g² of elements t, t+256, ... in order; the block's 256 sums
// go through a shuffle tree (offsets 16..1) a warp, then the 8 warp sums
// through the same tree; the chunk's sum goes to a partial in chunk order.
// The block that finishes last (a counter, after a fence) sums the partials
// the same way (thread t: partials t, t+256, ...; then the tree), takes the
// square root and the clip scale, and resets the counter.  Nothing is read
// back to the host.
//
// Bound: bytes.  The update reads p, g, m, v once and writes p, m, v once
// (22 bytes an element with bf16 p and g, float32 moments), the norm reads
// g once more: about 20 ms for llama3-8b's 2.8 B parameters at 3.35 TB/s,
// against the plain version's ~200 bytes an element.  Each thread keeps
// kUnroll elements' loads in flight; the accesses are coalesced scalars.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                       // a block
constexpr int kIters = 64;                          // elements a thread a chunk
constexpr long long kChunk = (long long)kThreads * kIters;
constexpr int kUnroll = 4;                          // loads in flight a thread
constexpr int kMaxLeaves = 600;                     // leaves a launch

// a leaf's dtypes: set bits are bf16, clear float32
constexpr int kParamBf16 = 1, kGradBf16 = 2, kMomentBf16 = 4;

struct Table {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];   // each leaf's first block; first[count] = blocks
  int kind[kMaxLeaves];
  int count;
};
static_assert(sizeof(Table) <= 32000, "a launch's parameters are at most 32 KB");  // 28.8 KB

struct Consts {
  float b1, one_b1, b2, one_b2, eps, wd;
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T cast(float x);
template <>
__device__ __forceinline__ float cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the leaf of block b: the last leaf whose first block is ≤ b (an empty
// leaf shares its first block with the next, which wins)
__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// thread 0's value: the block's 256 values summed by the fixed tree
__device__ __forceinline__ float block_sum(float x, float* sh) {
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) sh[w] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? sh[lane] : 0.f;
  if (w == 0)
    for (int off = 16; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  __syncthreads();
  return x;
}

template <typename G>
__device__ __forceinline__ float chunk_sumsq(const G* __restrict__ g, long long n,
                                             long long base) {
  float acc = 0.f;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += 2 * kUnroll) {
    float x[2 * kUnroll];
#pragma unroll
    for (int u = 0; u < 2 * kUnroll; ++u) {
      const long long idx = base + (long long)(i0 + u) * kThreads + threadIdx.x;
      x[u] = idx < n ? f32(g[idx]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2 * kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(x[u], x[u]));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Table t, float* __restrict__ partials, int block0,
                  unsigned* __restrict__ done, int total, float* __restrict__ out,
                  float max_norm, float clip_eps) {
  __shared__ float sh[kThreads / 32];
  __shared__ bool last;
  const int b = blockIdx.x;
  const int l = leaf_of(t, b);
  const long long base = (long long)(b - t.first[l]) * kChunk;
  float acc = (t.kind[l] & kGradBf16)
                  ? chunk_sumsq((const __nv_bfloat16*)t.g[l], t.n[l], base)
                  : chunk_sumsq((const float*)t.g[l], t.n[l], base);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[block0 + b] = acc;
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int i = threadIdx.x; i < total; i += kThreads) s = __fadd_rn(s, __ldcg(partials + i));
  s = block_sum(s, sh);
  if (threadIdx.x == 0) {
    const float gn = __fsqrt_rn(s);
    const float r = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(gn, clip_eps)), max_norm);
    out[0] = gn;
    out[1] = r > 1.f ? 1.f : r;       // clamp(max=1); a NaN stays NaN
    *done = 0u;
  }
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void update_chunk(P* __restrict__ p, const G* __restrict__ g,
                                             M* __restrict__ m, M* __restrict__ v, long long n,
                                             long long base, const Consts& c, float scale,
                                             float lr, float b1t, float b2t) {
#pragma unroll 1
  for (int i0 = 0; i0 < kIters; i0 += kUnroll) {
    float gv[kUnroll], mv[kUnroll], vv[kUnroll], pv[kUnroll];
    long long idx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      idx[u] = base + (long long)(i0 + u) * kThreads + threadIdx.x;
      if (idx[u] < n) {
        gv[u] = f32(g[idx[u]]);
        mv[u] = f32(m[idx[u]]);
        vv[u] = f32(v[idx[u]]);
        pv[u] = f32(p[idx[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (idx[u] >= n) continue;
      const float gs = __fmul_rn(gv[u], scale);
      const float m32 = __fadd_rn(__fmul_rn(c.b1, mv[u]), __fmul_rn(c.one_b1, gs));
      const float v32 = __fadd_rn(__fmul_rn(c.b2, vv[u]), __fmul_rn(__fmul_rn(c.one_b2, gs), gs));
      const float mh = __fdiv_rn(m32, b1t);
      const float vh = __fdiv_rn(v32, b2t);
      const float delta = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), c.eps)),
                                    __fmul_rn(c.wd, pv[u]));
      p[idx[u]] = cast<P>(__fsub_rn(pv[u], __fmul_rn(lr, delta)));
      m[idx[u]] = cast<M>(m32);
      v[idx[u]] = cast<M>(v32);
    }
  }
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void update_leaf(const Table& t, int l, long long base,
                                            const Consts& c, float scale, float lr, float b1t,
                                            float b2t) {
  update_chunk((P*)t.p[l], (const G*)t.g[l], (M*)t.m[l], (M*)t.v[l], t.n[l], base, c, scale,
               lr, b1t, b2t);
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table t, const float* __restrict__ norm,
                    const float* __restrict__ lr_t, const float* __restrict__ b1t_p,
                    const float* __restrict__ b2t_p, Consts c) {
  const int b = blockIdx.x;
  const int l = leaf_of(t, b);
  const long long base = (long long)(b - t.first[l]) * kChunk;
  const float scale = norm[1], lr = *lr_t, b1t = *b1t_p, b2t = *b2t_p;
  using bf = __nv_bfloat16;
  switch (t.kind[l]) {
    case 0: update_leaf<float, float, float>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kParamBf16: update_leaf<bf, float, float>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kGradBf16: update_leaf<float, bf, float>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kParamBf16 | kGradBf16:
      update_leaf<bf, bf, float>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kMomentBf16: update_leaf<float, float, bf>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kMomentBf16 | kParamBf16:
      update_leaf<bf, float, bf>(t, l, base, c, scale, lr, b1t, b2t); break;
    case kMomentBf16 | kGradBf16:
      update_leaf<float, bf, bf>(t, l, base, c, scale, lr, b1t, b2t); break;
    default: update_leaf<bf, bf, bf>(t, l, base, c, scale, lr, b1t, b2t); break;
  }
}

// the table of leaves [lo, hi), its blocks; -1 when a leaf is too long
long long fill(Table& t, void* const* p, const void* const* g, void* const* m, void* const* v,
               const long long* n, const int* kind, int lo, int hi) {
  long long blocks = 0;
  t.count = hi - lo;
  for (int i = lo; i < hi; ++i) {
    const int j = i - lo;
    t.p[j] = p ? p[i] : nullptr;
    t.g[j] = g[i];
    t.m[j] = m ? m[i] : nullptr;
    t.v[j] = v ? v[i] : nullptr;
    t.n[j] = n[i];
    t.kind[j] = kind[i];
    t.first[j] = (int)blocks;
    blocks += (n[i] + kChunk - 1) / kChunk;
    if (n[i] < 0 || blocks > 0x7fffffffLL) return -1;
  }
  t.first[t.count] = (int)blocks;
  return blocks;
}

long long total_blocks(const long long* n, int leaves) {
  long long blocks = 0;
  for (int i = 0; i < leaves; ++i) blocks += (n[i] + kChunk - 1) / kChunk;
  return blocks;
}

}  // namespace

// elements a block takes, leaves a launch takes
extern "C" int adamw_chunk_elems() { return (int)kChunk; }
extern "C" int adamw_max_leaves() { return kMaxLeaves; }

// The norm of `leaves` gradients g[i] of n[i] elements (bf16 where kind[i]
// & 2, else float32), in launches of up to kMaxLeaves leaves: out[0] the global norm,
// out[1] the clip scale.  `partials` holds one float a block of all the
// launches (adamw_chunk_elems() elements a block, leaf by leaf), `done` one
// zeroed unsigned int.
extern "C" int adamw_norm_launch(const void* const* g, const long long* n, const int* kind,
                                 int leaves, void* partials, void* done, void* out,
                                 float max_norm, float clip_eps, void* stream) {
  if (leaves < 1) return (int)cudaErrorInvalidValue;
  const long long total = total_blocks(n, leaves);
  if (total < 1 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Table t;
  long long block0 = 0;
  for (int lo = 0; lo < leaves; lo += kMaxLeaves) {
    const int hi = lo + kMaxLeaves < leaves ? lo + kMaxLeaves : leaves;
    const long long blocks = fill(t, nullptr, g, nullptr, nullptr, n, kind, lo, hi);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks == 0) continue;
    adamw_norm_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        t, (float*)partials, (int)block0, (unsigned*)done, (int)total, (float*)out, max_norm,
        clip_eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    block0 += blocks;
  }
  return (int)cudaGetLastError();
}

// The update of `leaves` leaves in place, in launches of up to kMaxLeaves:
// p[i], g[i], m[i], v[i] of n[i] elements, kind[i]'s bits 1, 2 and 4 the
// parameter, gradient and moments bf16 (else float32); norm[1]
// the clip scale (adamw_norm_launch's out), lr_t, b1t, b2t float32 device
// scalars.  Returns the first launch error.
extern "C" int adamw_update_launch(void* const* p, const void* const* g, void* const* m,
                                   void* const* v, const long long* n, const int* kind,
                                   int leaves, const void* norm, const void* lr_t,
                                   const void* b1t, const void* b2t, float b1, float one_b1,
                                   float b2, float one_b2, float eps, float wd, void* stream) {
  if (leaves < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Consts c{b1, one_b1, b2, one_b2, eps, wd};
  Table t;
  for (int lo = 0; lo < leaves; lo += kMaxLeaves) {
    const int hi = lo + kMaxLeaves < leaves ? lo + kMaxLeaves : leaves;
    const long long blocks = fill(t, p, g, m, v, n, kind, lo, hi);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks == 0) continue;
    adamw_update_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        t, (const float*)norm, (const float*)lr_t, (const float*)b1t, (const float*)b2t, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
