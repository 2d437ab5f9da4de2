// The Mamba-1 selective scan h_t = a_t ⊙ h_{t-1} + bx_t, y_t = Σ_N c_t ⊙ h_t,
// for Hopper (sm_90a), hand-written, in two entries built from one kernel
// template:
//   * selective_scan_launch: the TPU kernel's contract, a and bx [B, S, D, N]
//     read from device memory;
//   * selective_scan_fused_launch: the discretisation fused in, a_t and bx_t
//     formed in registers from dt [B, S, D], A [D, N], Bm [B, S, N] and x
//     [B, S, D] (float32 or bf16) as the model computes them:
//     a = exp(dt·A), bx = (dt·x)·B.  Nothing [B, S, D, N]-sized exists.
//
// For training, `selective_scan_fused_ckpt_launch` also writes the state
// before every kCkpt steps ([B, ceil(S/kCkpt), D, N] float32, kCkpt = 16 in
// csrc/selective_scan.cuh), from which
// the backward (csrc/selective_scan_bwd.cu) recomputes each chunk; y and
// h_last are the other entries' bits.
//
// Replaces the Pallas TPU kernel `selective_scan` (src/repro/kernels/
// selective_scan.py, `_kernel`): a grid of (B, D/bd) steps that each own a
// [bd, N] state slice in VMEM and walk the sequence with a fori_loop, so
// the state never leaves fast memory.  Both entries also take an optional
// initial state h0 and write the final state h_last: the serving path
// carries the state into the decode cache.
//
// Bound.  The (a, bx) entry is bound by device-memory bytes: a and bx are
// read once, y written once.  The fused entry reads dt and x and writes y,
// [B, S, D] each, and reads the small Bm/Cm; its floor is the larger of
// those bytes and the S·D·N exponentials (one MUFU.EX2 each, 16 a clock
// an SM).  a = exp2f(dt·A2) with A2 = A·log2(e) formed once in registers:
// exp2f is CUDA's float32 exp2 (at most 2 ulp, CUDA Programming Guide,
// single-precision functions), not __expf; the pre-scaled argument adds
// a relative error of at most about ln2·|dt·A·log2 e|·2^-23 (≈ 1e-6 at
// |dt·A| = 10) against expf(dt·A).
//
// Design:
//   * a block owns kChannels = 32 channels d of one batch row b; each
//     channel's N states are spread over L = N / NPT lanes of a warp, NPT
//     = min(kStates, N) states a thread, all in registers for the whole
//     sequence, with A[d, n] (fused entry) in registers too;
//   * the sequence goes in tiles of kSteps steps: the block stages the
//     tile's Bm and Cm rows (shared by every channel) and, fused, its dt
//     and x rows (32 channels = 128 contiguous bytes a row) in shared
//     memory, walks the tile, and writes the tile's y from shared memory,
//     again 32 channels a row;
//   * y_t of a channel is its lanes' partial sums Σ over NPT states, then
//     a shuffle sum over the L lanes (log2 L shuffles);
//   * channels past D (a ragged last block) load zeros and write nothing
//     but still take part in the shuffles.
// kStates = 2 was the fastest of 1, 2, 4, 8 and 16 states a thread at the
// falcon-mamba-7b prefill's shape on an H100 (fewer states a thread means
// more threads but more shuffles).  NPT and L are template parameters, so
// that every index and the shuffle loop are known to the compiler.
//
// The (a, bx) entry at N = 1 (the RG-LRU: [B, S, 2560] with c = 1) has a
// path of its own, `selective_scan_n1_launch`.  One state a channel leaves
// the template one lane a channel, 80 one-warp blocks at D = 2560, each
// walking every step in a chain of loads; so S is cut into chunks of
// `chunk` steps walked in parallel (the reference computes the RG-LRU the
// same way: an associative scan within chunks under a scan over them).
//   * n1_totals: each (channel, chunk but the last) walks its chunk from
//     zero and keeps (Π a, h_end) in `carry` [B, chunks, D];
//   * n1_walk: each (channel, chunk) folds h0 through the earlier chunks'
//     (Π a, h_end) in chunk order, h = Π a · h + h_end, then walks its chunk
//     from that state and writes y = c·h (and h_last from the last chunk).
// Every fold runs in one fixed order, so every launch gives the same bits.
// A thread loads kN1Batch steps of a and bx before it walks them, so the
// chain waits on the FMAs, not on device memory.  The bytes are a and bx
// read twice and y written once: 20 bytes a (t, d) against the bound's 12.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

constexpr int kChannels = 32;   // channels d a block owns
constexpr int kSteps = 64;      // steps t a tile stages
constexpr int kStates = 2;      // states of a channel a thread holds (at most N)
static_assert(kSteps % kCkpt == 0, "a tile holds whole checkpoint chunks");

template <typename XT> __device__ __forceinline__ float widen(XT v);
template <> __device__ __forceinline__ float widen<float>(float v) { return v; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const float* a;       // [B, S, D, N]                 (a, bx) entry
  const float* bx;      // [B, S, D, N]                 (a, bx) entry
  const float* dt;      // [B, S, D]                    fused entry
  const float* A;       // [D, N]                       fused entry
  const float* Bm;      // [B, S, N]                    fused entry
  const void* x;        // [B, S, D] float32 or bf16    fused entry
  const float* c;       // [B, S, N]
  const float* h0;      // [B, D, N] or null
  float* y;             // [B, S, D]
  float* h_last;        // [B, D, N] or null
  float* ckpt;          // [B, ceil(S / kCkpt), D, N] or null: the state before each
                        // kCkpt-step chunk (the backward's starting points)
  int S, D, N;
};

// NPT (1 or 2) consecutive floats of `p`, 4- or 8-byte aligned as NPT says
template <int NPT>
__device__ __forceinline__ void load_states(const float* p, float (&v)[NPT]) {
  if constexpr (NPT == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

// NPT consecutive floats of shared memory
template <int NPT>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[NPT]) {
#pragma unroll
  for (int j = 0; j < NPT; ++j) v[j] = p[j];
}

// a channel's N = NPT·L states on L lanes; a block has 32·L threads
template <int NPT, int L, bool FUSED, typename XT>
__global__ void __launch_bounds__(kChannels * L) selective_scan_kernel(Args g) {
  __shared__ __align__(16) float c_s[kSteps * 32];             // Cm rows, N ≤ 32
  __shared__ __align__(16) float b_s[FUSED ? kSteps * 32 : 4]; // Bm rows
  __shared__ float dt_s[FUSED ? kSteps * kChannels : 1];
  __shared__ float x_s[FUSED ? kSteps * kChannels : 1];
  __shared__ float y_s[kSteps * kChannels];

  constexpr int N = NPT * L;
  const int S = g.S, D = g.D;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / L;                 // channel within the block
  const int n0 = (threadIdx.x % L) * NPT;         // first state of the thread
  const int d = d0 + ch;
  const bool live = d < D;
  const int nthreads = blockDim.x;

  float h[NPT], A[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) h[j] = A[j] = 0.f;
  if (live && g.h0 != nullptr) load_states<NPT>(g.h0 + ((long long)b * D + d) * N + n0, h);
  if constexpr (FUSED) {
    if (live) load_states<NPT>(g.A + (long long)d * N + n0, A);
#pragma unroll
    for (int j = 0; j < NPT; ++j) A[j] *= 1.4426950408889634f;   // log2(e)
  }
  const XT* x = static_cast<const XT*>(g.x);

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int tn = min(kSteps, S - t0);
    const long long row0 = (long long)b * S + t0;          // first [B, S] row
    __syncthreads();                                        // last tile's y_s read
    for (int i = threadIdx.x; i < tn * N; i += nthreads) {
      c_s[i] = __ldg(g.c + row0 * N + i);
      if constexpr (FUSED) b_s[i] = __ldg(g.Bm + row0 * N + i);
    }
    if constexpr (FUSED) {
      for (int i = threadIdx.x; i < tn * kChannels; i += nthreads) {
        const int t = i / kChannels, dd = d0 + i % kChannels;
        const long long off = (row0 + t) * D + dd;
        dt_s[i] = dd < D ? __ldg(g.dt + off) : 0.f;
        x_s[i] = dd < D ? widen<XT>(x[off]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      if (g.ckpt != nullptr && live && (t % kCkpt) == 0) {
        float* cp = g.ckpt + (((long long)b * ((S + kCkpt - 1) / kCkpt) + (t0 + t) / kCkpt) * D + d) * N + n0;
#pragma unroll
        for (int j = 0; j < NPT; ++j) cp[j] = h[j];
      }
      float av[NPT], bv[NPT];
      if constexpr (FUSED) {
        const float dtv = dt_s[t * kChannels + ch];
        const float dx = dtv * x_s[t * kChannels + ch];
        float bm[NPT];
        load_shared<NPT>(b_s + t * N + n0, bm);
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          av[j] = exp2f(dtv * A[j]);
          bv[j] = dx * bm[j];
        }
      } else {
        const long long off = ((row0 + t) * D + d) * N + n0;
        if (live) {
          load_states<NPT>(g.a + off, av);
          load_states<NPT>(g.bx + off, bv);
        } else {
#pragma unroll
          for (int j = 0; j < NPT; ++j) av[j] = bv[j] = 0.f;
        }
      }
      float cm[NPT];
      load_shared<NPT>(c_s + t * N + n0, cm);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        h[j] = fmaf(av[j], h[j], bv[j]);
        p = fmaf(h[j], cm[j], p);
      }
#pragma unroll
      for (int off = L >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off, L);
      if (n0 == 0) y_s[t * kChannels + ch] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tn * kChannels; i += nthreads) {
      const int t = i / kChannels, dd = d0 + i % kChannels;
      if (dd < D) g.y[(row0 + t) * D + dd] = y_s[i];
    }
  }
  if (live && g.h_last != nullptr) {
    float* hp = g.h_last + ((long long)b * D + d) * N + n0;
#pragma unroll
    for (int j = 0; j < NPT; ++j) hp[j] = h[j];
  }
}

template <int NPT, int L, bool FUSED, typename XT>
int run(const Args& g, dim3 grid, cudaStream_t s) {
  selective_scan_kernel<NPT, L, FUSED, XT><<<grid, kChannels * L, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// NPT = min(kStates, N) states a thread on L = N / NPT lanes
template <bool FUSED, typename XT>
int launch(const Args& g, int B, cudaStream_t s) {
  static_assert(kStates == 2, "the cases below spell out kStates = 2");
  const dim3 grid((g.D + kChannels - 1) / kChannels, B);
  switch (g.N) {
    case 1:   // the (a, bx) entry's N = 1 is selective_scan_n1_launch's
      if constexpr (FUSED) return run<1, 1, FUSED, XT>(g, grid, s);
      return (int)cudaErrorInvalidValue;
    case 2: return run<2, 1, FUSED, XT>(g, grid, s);
    case 4: return run<2, 2, FUSED, XT>(g, grid, s);
    case 8: return run<2, 4, FUSED, XT>(g, grid, s);
    case 16: return run<2, 8, FUSED, XT>(g, grid, s);
    case 32: return run<2, 16, FUSED, XT>(g, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// N a power of two ≤ 32
bool bad_shape(int B, int S, int D, int N) {
  return B < 0 || S < 0 || D < 0 || N < 1 || N > 32 || (N & (N - 1)) != 0 || B > 65535;
}

int launch_fused(const void* dt, const void* A, const void* Bm, const void* Cm, const void* x,
                 int x_bf16, const void* h0, void* y, void* h_last, void* ckpt, int B, int S,
                 int D, int N, void* stream) {
  if (bad_shape(B, S, D, N)) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  Args g{nullptr, nullptr, (const float*)dt, (const float*)A, (const float*)Bm, x,
         (const float*)Cm, (const float*)h0, (float*)y, (float*)h_last, (float*)ckpt, S, D, N};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<true, __nv_bfloat16>(g, B, s) : launch<true, float>(g, B, s);
}

// ---------------------------------------------------------------------------
// the (a, bx) entry at N = 1: chunks walked in parallel
// ---------------------------------------------------------------------------

constexpr int kN1Tile = 128;    // channels a block
constexpr int kN1Batch = 16;    // steps a thread loads before it walks them

// chunk j < chunks - 1 (blockIdx.y) of channels d of batch row b: (Π a,
// h_end from zero) into carry[b, j, d]; chunk is a multiple of kN1Batch
__global__ void __launch_bounds__(kN1Tile)
n1_totals(const float* __restrict__ a, const float* __restrict__ bx, float2* __restrict__ carry,
          int S, int D, int chunk, int chunks) {
  const int d = blockIdx.x * kN1Tile + threadIdx.x;
  if (d >= D) return;
  const int j = blockIdx.y, b = blockIdx.z;
  const long long at = ((long long)b * S + (long long)j * chunk) * D + d;
  float A = 1.f, H = 0.f;
  for (int t = 0; t < chunk; t += kN1Batch) {
    float av[kN1Batch], bv[kN1Batch];
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      av[u] = __ldg(a + at + (long long)(t + u) * D);
      bv[u] = __ldg(bx + at + (long long)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      H = fmaf(av[u], H, bv[u]);
      A *= av[u];
    }
  }
  carry[((long long)b * chunks + j) * D + d] = make_float2(A, H);
}

// chunk j (blockIdx.y) of channels d of batch row b: its state from h0 and
// the earlier chunks' carries, then its steps; y [B, S, D], c [B, S]
__global__ void __launch_bounds__(kN1Tile)
n1_walk(const float* __restrict__ a, const float* __restrict__ bx, const float* __restrict__ c,
        const float* __restrict__ h0, const float2* __restrict__ carry, float* __restrict__ y,
        float* __restrict__ h_last, int S, int D, int chunk) {
  const int d = blockIdx.x * kN1Tile + threadIdx.x;
  if (d >= D) return;
  const int j = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  float h = h0 != nullptr ? h0[(long long)b * D + d] : 0.f;
  const float2* cb = carry + (long long)b * chunks * D + d;
#pragma unroll 8
  for (int i = 0; i < j; ++i) {
    const float2 g = cb[(long long)i * D];
    h = fmaf(g.x, h, g.y);
  }
  const int t0 = j * chunk, tn = min(chunk, S - t0);
  const long long at = ((long long)b * S + t0) * D + d;
  const float* cs = c + (long long)b * S + t0;
  for (int t = 0; t < tn; t += kN1Batch) {
    float av[kN1Batch], bv[kN1Batch], cv[kN1Batch];
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t + u < tn) {
        av[u] = __ldcs(a + at + (long long)(t + u) * D);
        bv[u] = __ldcs(bx + at + (long long)(t + u) * D);
        cv[u] = __ldg(cs + t + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t + u < tn) {
        h = fmaf(av[u], h, bv[u]);
        y[at + (long long)(t + u) * D] = h * cv[u];
      }
    }
  }
  if (h_last != nullptr && j == chunks - 1) h_last[(long long)b * D + d] = h;
}

}  // namespace

// a, bx: [B, S, D, N]; c: [B, S, N]; y: [B, S, D]; h0, h_last: [B, D, N]
// or null; all float32 and contiguous.  Returns cudaGetLastError() after
// the launch.
extern "C" int selective_scan_launch(const void* a, const void* bx, const void* c,
                                     const void* h0, void* y, void* h_last, int B, int S,
                                     int D, int N, void* stream) {
  if (bad_shape(B, S, D, N)) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  Args g{(const float*)a, (const float*)bx, nullptr, nullptr, nullptr, nullptr,
         (const float*)c, (const float*)h0, (float*)y, (float*)h_last, nullptr, S, D, N};
  return launch<false, float>(g, B, reinterpret_cast<cudaStream_t>(stream));
}

// dt: [B, S, D] float32 (after softplus); A: [D, N] float32 (-exp(a_log));
// Bm, Cm: [B, S, N] float32; x: [B, S, D], bf16 when x_bf16 else float32;
// y: [B, S, D] float32; h0, h_last: [B, D, N] float32 or null; all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_fused_launch(const void* dt, const void* A, const void* Bm,
                                           const void* Cm, const void* x, int x_bf16,
                                           const void* h0, void* y, void* h_last, int B,
                                           int S, int D, int N, void* stream) {
  return launch_fused(dt, A, Bm, Cm, x, x_bf16, h0, y, h_last, nullptr, B, S, D, N, stream);
}

// The same, also writing ckpt [B, ceil(S / 16), D, N] float32: the state
// before steps 0, 16, 32, ... (ckpt[:, 0] is h0, or zeros), from which the
// backward recomputes each 16-step chunk's states.
extern "C" int selective_scan_fused_ckpt_launch(const void* dt, const void* A, const void* Bm,
                                                const void* Cm, const void* x, int x_bf16,
                                                const void* h0, void* y, void* h_last,
                                                void* ckpt, int B, int S, int D, int N,
                                                void* stream) {
  return launch_fused(dt, A, Bm, Cm, x, x_bf16, h0, y, h_last, ckpt, B, S, D, N, stream);
}

// The (a, bx) entry at N = 1, in chunks of `chunk` steps (a positive
// multiple of 16): a, bx [B, S, D] (the [B, S, D, 1] arrays), c [B, S],
// h0, h_last [B, D] or null, y [B, S, D]; `carry` is float32 scratch of 2 ·
// B · max(1, ceil(S / chunk)) · D.  All float32 and contiguous.  Returns
// cudaGetLastError() after the launches.
extern "C" int selective_scan_n1_launch(const void* a, const void* bx, const void* c,
                                        const void* h0, void* y, void* h_last, void* carry,
                                        int B, int S, int D, int chunk, void* stream) {
  if (B < 0 || S < 0 || D < 0 || B > 65535 || chunk < kN1Batch || chunk % kN1Batch != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const long long chunks = S == 0 ? 1 : ((long long)S + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)((D + kN1Tile - 1) / kN1Tile);
  float2* cr = static_cast<float2*>(carry);
  if (chunks > 1)
    n1_totals<<<dim3(tiles, (unsigned)chunks - 1, B), kN1Tile, 0, s>>>(
        (const float*)a, (const float*)bx, cr, S, D, chunk, (int)chunks);
  n1_walk<<<dim3(tiles, (unsigned)chunks, B), kN1Tile, 0, s>>>(
      (const float*)a, (const float*)bx, (const float*)c, (const float*)h0, cr, (float*)y,
      (float*)h_last, S, D, chunk);
  return (int)cudaGetLastError();
}

extern "C" int selective_scan_ckpt_steps() { return kCkpt; }

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
