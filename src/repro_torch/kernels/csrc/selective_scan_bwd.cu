// The backward of the fused Mamba-1 selective scan (csrc/selective_scan.cu,
// `selective_scan_fused`), for Hopper (sm_90a), hand-written.
//
// The Pallas TPU kernel `selective_scan` (src/repro/kernels/
// selective_scan.py, `_kernel`) has no backward: the reference trains by
// jax.value_and_grad through `associative_scan` (src/repro/models/ssm.py,
// `mamba_forward`).  This is the backward of the port's fused forward, for
// the LM training step.  Forward, per (b, d, n):
//   a_t = exp(dt_t·A),  h_t = a_t·h_{t-1} + dt_t·x_t·B_t,  y_t = Σ_n C_t·h_t.
// Given dy [B, S, D] and dh_last [B, D, N] (or zero), the reverse walk
//   g_t = C_t·dy_t + a_{t+1}·g_{t+1}   (g_{S-1} starts from dh_last)
// gives, with z_t = dt_t·A and dz_t = g_t·h_{t-1}·a_t:
//   ddt_t = Σ_n (g_t·B_t·x_t + dz_t·A),  dx_t = dt_t·Σ_n g_t·B_t,
//   dB_t = Σ_d g_t·dt_t·x_t,  dC_t = Σ_d dy_t·h_t,  dA = Σ_{b,t} dz_t·dt_t,
//   dh0 = a_0·g_0.
//
// The states.  The forward's checkpoint entry writes the state before
// every kCkpt steps ([B, ceil(S/kCkpt), D, N] float32; kCkpt = 16, in
// csrc/selective_scan.cuh).  A thread walks the chunks last to first: it
// recomputes its chunk's 16 states from the checkpoint in registers
// (exactly the forward's arithmetic), keeping each a_t beside its h_t, then
// walks them in reverse: one exponential a (t, d, n) where the earlier
// design took two.  a_t·g_t is both the carried gradient and the factor of
// dz_t = a_t·g_t·h_{t-1}.  Nothing [B, S, D, N]-sized is stored.
//
// Layout.  A channel's N states are spread over L = N / NPT lanes, NPT =
// min(kNpt, N) = 2 states a thread; a block of 512 threads owns 512/L
// channels d of one batch row b (N = 16: 8 lanes a channel, 64 channels:
// half the dB and dC parts that 32-channel blocks wrote and read back,
// 268 MB at the falcon-mamba-7b step's shape), at most 128 (N ≤ 8: fewer
// threads).
// The chunk's dt, x, dy and B, C rows are staged in shared memory in two
// stages: each thread loads its share of chunk c − 1 into registers before
// it walks chunk c and parks it in the other stage after, so the loads'
// latency hides behind the walk, with two barriers a chunk.
//
// Sums, with no float atomics (the same bits on every launch):
//   * Σ_n dz·A and Σ_n g·B: each lane's two partial sums go to shared
//     memory a step (one 8-byte store), and after the walk one thread a (t,
//     d) sums the channel's L lanes in order and forms ddt = Σ dz·A +
//     x·Σ g·B and dx = dt·Σ g·B (a butterfly over the L lanes a step cost
//     ten instructions where the store costs one);
//   * dB, dC (over d): a reduce-scatter butterfly over the warp's 32/L
//     channels, each level halving the 2·NPT values in flight, so a lane
//     ends with whole sums for its share of (n, dB or dC): 3 shuffles a
//     thread-step at N = 16 where the earlier all-reduce took 8; then the
//     block's warps in order in shared memory, one part per (b, block of
//     channels, t, n); a second launch sums the parts in order;
//   * dA (over b and t): each thread sums its t in registers, one part per
//     (b, d, n); the second launch sums the B parts in order.
// The sums over n and d run in another order than the earlier design's,
// so the last bits of ddt, dx, dB and dC differ from it.
//
// Bound: the bytes (dt, x, dy, ddt, dx [B, S, D] and the checkpoints read
// or written once) or the S·D·N exponentials.  It runs far from both: the
// instructions a (t, d, n) bound it.  Measured on an H100 at the
// falcon-mamba-7b step's shape (PERF.md §6, tools/kernel_ab.py): of the
// layouts tried, 2 states a thread on 512 threads is the fastest; 4 states
// a thread (241 registers, 8 warps an SM), 256-thread blocks of 32
// channels (twice the parts) and forming a_t again in the reverse walk
// (fewer registers) were slower.  The shuffles over the warp's channels
// take about a sixth of the walk's time; its other arithmetic and its
// shared-memory reads most of the rest.
//
// The (a, bx) entry's backward at N = 1 (`selective_scan_n1_bwd_launch`):
// the RG-LRU of recurrentgemma-2b calls the scan's (a, bx) entry with
// N = 1 and c = 1, so the forward's y is the state h itself.  Given h
// [B, S, D] (the forward's y), a [B, S, D], dy [B, S, D] and dh_last
// [B, D] (or zero), the reverse walk
//   g_t = dy_t + c_t,  c_t = a_{t+1}·g_{t+1}  (c_{S-1} = dh_last),
//   da_t = g_t·h_{t-1} (h_{-1} = h0, or zero),  dbx_t = g_t,  dh0 = a_0·g_0.
// The carry out of a stretch of steps is linear in the carry into its
// last step: walked from c, a chunk hands on Π a · c + (its carry out from
// zero).  So S is cut into chunks (`chunk` steps, from S alone:
// kernels/selective_scan.py::_n1_chunk, the forward's), the forward's
// structure run in reverse (csrc/selective_scan.cu, n1_totals / n1_walk):
//   1. n1_bwd_totals: each (channel, chunk but the first) walks its chunk
//      backward from a zero carry and keeps (Π a, carry out), a float2 of
//      the scratch [B, chunks, D];
//   2. n1_bwd_walk: each (channel, chunk) folds dh_last through the later
//      chunks' pairs, last chunk first, then walks its chunk: da, dbx;
//      chunk 0 writes dh0.  A chunk's first h_{t-1} is the previous
//      chunk's last row (or h0).
// A thread a (channel, chunk); a warp's 32 lanes read 32 neighbouring
// channels (128 contiguous bytes) a step, and each 16-step batch's loads
// are issued before the batch before it is walked, so that they are in
// flight while it is (the walk 0.105 → 0.079 ms at [1, 4096, 2560];
// batches of 32 steps were slower).  Every sum
// and product is rounded on its own (__fadd_rn, __fmul_rn: no fused
// multiply-add), in the order the plain version
// (`selective_scan_bwd_plain`) takes: the same bits on every launch, and
// the plain version's.  Bound: bytes, a, h and dy read and da and dbx
// written once (20 B a step); the design moves 28 (launch 1 reads a and
// dy again).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

constexpr int kNpt = 2;          // states of a channel a thread holds (at most N)
constexpr int kThreads = 512;    // threads of a block (fewer when N is small)
constexpr int kMaxChannels = 128;  // channels of a block at most (shared memory)
constexpr unsigned kFull = 0xffffffffu;

template <typename XT> __device__ __forceinline__ float widen(XT v);
template <> __device__ __forceinline__ float widen<float>(float v) { return v; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename XT> __device__ __forceinline__ XT narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

struct Args {
  const float* dt;       // [B, S, D]
  const float* A;        // [D, N]
  const float* Bm;       // [B, S, N]
  const float* Cm;       // [B, S, N]
  const void* x;         // [B, S, D] float32 or bf16
  const float* ckpt;     // [B, nck, D, N]
  const float* dy;       // [B, S, D]
  const float* dh_last;  // [B, D, N] or null
  float* ddt;            // [B, S, D]
  void* dx;              // [B, S, D], x's type
  float* dh0;            // [B, D, N]
  float* dA_part;        // [B, D, N]
  float* dB_part;        // [B, nblk, S, N]
  float* dC_part;        // [B, nblk, S, N]
  int S, D, N, nblk;
};

// The P lanes idx·STRIDE + (lane % STRIDE) of a group each hold V values; a
// butterfly over them, level k exchanging with the lane whose idx differs in
// bit k.  While a lane holds more than one value it keeps the half its bit
// selects and sends the other (a reduce-scatter: each level halves the
// values in flight), then it adds what it receives (an all-reduce of the
// one value left).  Afterwards v[0..R), R = max(V / P, 1), holds the
// group's sums of the values first .. first + R − 1, first = Σ_k bit_k(idx)
// · V / 2^(k+1) over the halving levels.  The order of every sum is fixed.
template <int V, int P, int STRIDE>
__device__ __forceinline__ void butterfly(float (&v)[V], int idx) {
#pragma unroll
  for (int k = 0; k < ilog2(P); ++k) {
    const int half = V >> (k + 1);
    const bool up = (idx >> k) & 1;
    if (half >= 1) {
#pragma unroll
      for (int i = 0; i < (half >= 1 ? half : 1); ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, STRIDE << k);
      }
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], STRIDE << k);
    }
  }
}

// the first value a lane holds after butterfly<V, P, .>, and whether it is
// the one lane of its group that holds it (the all-reduce levels leave
// copies)
template <int V, int P>
__device__ __forceinline__ int butterfly_first(int idx) {
  int first = 0;
#pragma unroll
  for (int k = 0; k < ilog2(P); ++k)
    if ((V >> (k + 1)) >= 1 && ((idx >> k) & 1)) first += V >> (k + 1);
  return first;
}
template <int V, int P>
__device__ __forceinline__ bool butterfly_owner(int idx) {
  constexpr int halving = ilog2(V) < ilog2(P) ? ilog2(V) : ilog2(P);
  return (idx >> halving) == 0;
}

template <int NPT, int L>
struct Cfg {
  static constexpr int N = NPT * L;  // states of a channel
  // threads: kThreads, but at least 32 channels (the wrapper's scratch
  // holds the dB, dC parts of ceil(D/32) blocks) and at most kMaxChannels
  static constexpr int T0 = kThreads > 32 * L ? kThreads : 32 * L;
  static constexpr int T = T0 < kMaxChannels * L ? T0 : kMaxChannels * L;
  static constexpr int W = T / 32;   // warps
  static constexpr int CH = T / L;   // channels of a block
  static constexpr int P = 32 / L;   // channels of a warp
  static constexpr int V = 2 * NPT;  // dB, dC values a thread-step
  static constexpr int LANES = 2 * L + 2;  // floats of a (t, d)'s lane sums, padded
  // floats of shared memory: two stages of dt, x, dy [kCkpt][CH] and B, C
  // [kCkpt][N]; each lane's Σ dz·A, Σ g·B [kCkpt][CH][L][2] (a (t, d) row
  // padded to LANES floats, so that neither its writes nor its reads meet
  // in a bank); the warps' dB, dC sums [kCkpt][W][2N]
  static constexpr int STAGE = kCkpt * (3 * CH + 2 * N);
  static constexpr int FLOATS = 2 * STAGE + kCkpt * CH * LANES + kCkpt * W * 2 * N;
};

// what a thread loads of one chunk, held in registers while the chunk
// before it is walked
template <int NPT, int L, typename XT>
struct Prefetch {
  using C = Cfg<NPT, L>;
  static constexpr int PER = (kCkpt * C::CH + C::T - 1) / C::T;  // of dt, x, dy
  static constexpr int PERN = (kCkpt * C::N + C::T - 1) / C::T;  // of B, C
  float dt[PER], dy[PER], b[PERN], c[PERN];
  XT x[PER];
};

template <int NPT, int L, typename XT>
__global__ void __launch_bounds__(Cfg<NPT, L>::T) scan_bwd_kernel(Args g) {
  using C = Cfg<NPT, L>;
  constexpr int N = C::N, CH = C::CH, P = C::P, V = C::V, T = C::T, W = C::W;
  constexpr int R = V / P > 1 ? V / P : 1;  // dB, dC sums a lane holds after the butterfly
  extern __shared__ __align__(16) float sm[];
  float* lane_s = sm + 2 * C::STAGE;        // [kCkpt][CH][LANES]
  float* w_s = lane_s + kCkpt * CH * C::LANES;  // [kCkpt][W][2N]

  const int S = g.S, D = g.D;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = tid / L;          // channel within the block
  const int l = tid % L;           // state group within the channel
  const int n0 = l * NPT;          // first state of the thread
  const int cw = lane / L;         // channel within the warp
  const int d = d0 + ch;
  const bool live = d < D;
  const int nck = (S + kCkpt - 1) / kCkpt;
  const XT* x = static_cast<const XT*>(g.x);
  XT* dx = static_cast<XT*>(g.dx);

  float A[NPT], A2[NPT], gc[NPT], dA[NPT];  // gc: a_{t+1}·g_{t+1}, carried backwards
#pragma unroll
  for (int j = 0; j < NPT; ++j) A[j] = A2[j] = gc[j] = dA[j] = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      A[j] = g.A[(long long)d * N + n0 + j];
      A2[j] = A[j] * 1.4426950408889634f;  // log2(e), as the forward
      if (g.dh_last != nullptr) gc[j] = g.dh_last[((long long)b * D + d) * N + n0 + j];
    }
  }

  // chunk c's inputs into registers (rows past S and channels past D as 0)
  using PF = Prefetch<NPT, L, XT>;
  PF pf;
  float hs_next[NPT];
  auto fetch = [&](int c) {
    const int t0 = c * kCkpt, tn = min(kCkpt, S - t0);
    const long long row0 = (long long)b * S + t0;
#pragma unroll
    for (int k = 0; k < PF::PER; ++k) {
      const int i = tid + k * T, t = i / CH, dd = d0 + i % CH;
      const bool ok = i < kCkpt * CH && t < tn && dd < D;
      const long long off = ok ? (row0 + t) * D + dd : 0;
      pf.dt[k] = ok ? __ldg(g.dt + off) : 0.f;
      pf.dy[k] = ok ? __ldg(g.dy + off) : 0.f;
      pf.x[k] = ok ? x[off] : narrow<XT>(0.f);
    }
#pragma unroll
    for (int k = 0; k < PF::PERN; ++k) {
      const int i = tid + k * T;
      const bool ok = i < kCkpt * N && i / N < tn;
      pf.b[k] = ok ? __ldg(g.Bm + row0 * N + i) : 0.f;
      pf.c[k] = ok ? __ldg(g.Cm + row0 * N + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      hs_next[j] = live ? __ldg(g.ckpt + (((long long)b * nck + c) * D + d) * N + n0 + j) : 0.f;
  };
  auto park = [&](int st) {  // the fetched chunk into stage st
    float* base = sm + st * C::STAGE;
#pragma unroll
    for (int k = 0; k < PF::PER; ++k) {
      const int i = tid + k * T;
      if (i < kCkpt * CH) {
        base[i] = pf.dt[k];
        base[kCkpt * CH + i] = widen<XT>(pf.x[k]);
        base[2 * kCkpt * CH + i] = pf.dy[k];
      }
    }
#pragma unroll
    for (int k = 0; k < PF::PERN; ++k) {
      const int i = tid + k * T;
      if (i < kCkpt * N) {
        base[3 * kCkpt * CH + i] = pf.b[k];
        base[3 * kCkpt * CH + kCkpt * N + i] = pf.c[k];
      }
    }
  };

  if (nck > 0) {
    fetch(nck - 1);
    park((nck - 1) & 1);
  }
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCkpt;
    const int tn = min(kCkpt, S - t0);
    const long long row0 = (long long)b * S + t0;
    float hs[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) hs[j] = hs_next[j];
    __syncthreads();  // stage c & 1 is in; last chunk's lane_s and w_s are read
    if (c > 0) fetch(c - 1);  // in flight while chunk c is walked
    const float* st = sm + (c & 1) * C::STAGE;
    const float* dt_s = st;
    const float* x_s = dt_s + kCkpt * CH;
    const float* dy_s = x_s + kCkpt * CH;
    const float* b_s = dy_s + kCkpt * CH;
    const float* c_s = b_s + kCkpt * N;

    // the chunk's states, recomputed from its checkpoint as the forward
    // computes them, and their a_t
    float hist[kCkpt][NPT], av[kCkpt][NPT];
#pragma unroll
    for (int i = 0; i < kCkpt; ++i) {
      const float dtv = dt_s[i * CH + ch];
      const float dxv = dtv * x_s[i * CH + ch];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float hp = i == 0 ? hs[j] : hist[i - 1][j];
        if (i < tn) {
          av[i][j] = exp2f(dtv * A2[j]);
          hist[i][j] = fmaf(av[i][j], hp, dxv * b_s[i * N + n0 + j]);
        } else {
          hist[i][j] = hp;
        }
      }
    }

    // the reverse walk over the chunk
#pragma unroll
    for (int i = kCkpt - 1; i >= 0; --i) {
      if (i >= tn) continue;
      const float dtv = dt_s[i * CH + ch];
      const float xv = x_s[i * CH + ch];
      const float dyv = dy_s[i * CH + ch];
      const float dtx = dtv * xv;
      float sum[2] = {0.f, 0.f};  // Σ dz·A, Σ g·B
      float pv[V];                // dB parts (g·dt·x), then dC parts (dy·h)
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float a = av[i][j];
        const float hp = i == 0 ? hs[j] : hist[i - 1][j];
        const float gj = fmaf(c_s[i * N + n0 + j], dyv, gc[j]);  // g_t
        const float gb = gj * b_s[i * N + n0 + j];
        gc[j] = a * gj;               // the carry, and dz = a·g·h_{t-1}
        const float dz = gc[j] * hp;
        sum[0] = fmaf(dz, A[j], sum[0]);
        sum[1] += gb;
        dA[j] = fmaf(dz, dtv, dA[j]);
        pv[j] = gj * dtx;
        pv[NPT + j] = dyv * hist[i][j];
      }
      // this lane's Σ dz·A and Σ g·B; the channel's L lanes are summed, and
      // ddt = Σ dz·A + x·Σ g·B, dx = dt·Σ g·B formed, once a (t, d) after
      // the walk
      *reinterpret_cast<float2*>(lane_s + (i * CH + ch) * C::LANES + 2 * l) =
          make_float2(sum[0], sum[1]);
      // dB and dC over the warp's P channels
      butterfly<V, P, L>(pv, cw);
      if (butterfly_owner<V, P>(cw)) {
        const int first = butterfly_first<V, P>(cw);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int u = first + r;  // < NPT: dB of state n0 + u; else dC of n0 + u − NPT
          const int slot = u < NPT ? n0 + u : N + n0 + u - NPT;
          w_s[(i * W + warp) * 2 * N + slot] = pv[r];
        }
      }
    }
    __syncthreads();  // the walk is done: lane_s and w_s are whole
    for (int i = tid; i < tn * CH; i += T) {
      const int t = i / CH, dd = d0 + i % CH;
      if (dd < D) {
        const float2* ls = reinterpret_cast<const float2*>(lane_s + i * C::LANES);
        float sa = 0.f, sg = 0.f;  // Σ dz·A, Σ g·B over the lanes in order
#pragma unroll
        for (int k = 0; k < L; ++k) {
          sa += ls[k].x;
          sg += ls[k].y;
        }
        const long long off = (row0 + t) * D + dd;
        g.ddt[off] = fmaf(x_s[i], sg, sa);
        dx[off] = narrow<XT>(sg * dt_s[i]);
      }
    }
    // the block's dB, dC parts over its CH channels: the warps in order
    for (int i = tid; i < tn * 2 * N; i += T) {
      const int t = i / (2 * N), u = i % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s += w_s[(t * W + w) * 2 * N + u];
      const long long off = (((long long)b * g.nblk + blk) * S + t0 + t) * N;
      if (u < N)
        g.dB_part[off + u] = s;
      else
        g.dC_part[off + u - N] = s;
    }
    if (c > 0) park((c - 1) & 1);  // stage (c − 1) & 1 was last read two chunks ago
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const long long off = ((long long)b * D + d) * N + n0 + j;
      g.dh0[off] = gc[j];  // a_0·g_0
      g.dA_part[off] = dA[j];
    }
  }
}

// dB, dC [B, S, N]: the nblk partials of each (b, t, n) summed in block
// order; dA [D, N]: the B partials summed in batch order
__global__ void scan_bwd_reduce_kernel(const float* __restrict__ dB_part,
                                       const float* __restrict__ dC_part,
                                       const float* __restrict__ dA_part, float* __restrict__ dB,
                                       float* __restrict__ dC, float* __restrict__ dA, int B,
                                       int S, int D, int N, int nblk) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sn = (long long)S * N;
  for (long long i = first; i < (long long)B * sn; i += stride) {
    const long long b = i / sn, r = i % sn;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const long long off = (b * nblk + k) * sn + r;
      sb += dB_part[off];
      sc += dC_part[off];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  const long long dn = (long long)D * N;
  for (long long i = first; i < dn; i += stride) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dA_part[b * dn + i];
    dA[i] = s;
  }
}

template <int NPT, int L, typename XT>
int run(const Args& g, int B, cudaStream_t s) {
  const size_t bytes = Cfg<NPT, L>::FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(scan_bwd_kernel<NPT, L, XT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  scan_bwd_kernel<NPT, L, XT><<<dim3(g.nblk, B), Cfg<NPT, L>::T, bytes, s>>>(g);
  return (int)cudaGetLastError();
}

// NPT = min(kNpt, N) states a thread on L = N / NPT lanes
template <int N>
using CfgN = Cfg<(N < kNpt ? N : kNpt), N / (N < kNpt ? N : kNpt)>;

template <int N, typename XT>
int run_n(const Args& g, int B, cudaStream_t s) {
  constexpr int NPT = N < kNpt ? N : kNpt;
  return run<NPT, N / NPT, XT>(g, B, s);
}

// channels of a block
inline int block_channels(int N) {
  switch (N) {
    case 1: return CfgN<1>::CH;
    case 2: return CfgN<2>::CH;
    case 4: return CfgN<4>::CH;
    case 8: return CfgN<8>::CH;
    case 16: return CfgN<16>::CH;
    default: return CfgN<32>::CH;
  }
}

template <typename XT>
int launch(const Args& g, int B, cudaStream_t s) {
  switch (g.N) {
    case 1: return run_n<1, XT>(g, B, s);
    case 2: return run_n<2, XT>(g, B, s);
    case 4: return run_n<4, XT>(g, B, s);
    case 8: return run_n<8, XT>(g, B, s);
    case 16: return run_n<16, XT>(g, B, s);
    case 32: return run_n<32, XT>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the (a, bx) entry's backward at N = 1: chunks walked in parallel
// ---------------------------------------------------------------------------

constexpr int kN1Tile = 128;   // channels a block
constexpr int kN1Batch = 16;   // steps a thread loads before it walks them

// chunk j ≥ 1 (blockIdx.y + 1) of channels d of batch row b, walked
// backward from a zero carry: (Π a, the carry out) into carry[b, j, d]
__global__ void __launch_bounds__(kN1Tile)
    n1_bwd_totals(const float* __restrict__ a, const float* __restrict__ dy,
                  float2* __restrict__ carry, int S, int D, int chunk, int chunks) {
  const int d = blockIdx.x * kN1Tile + threadIdx.x;
  if (d >= D) return;
  const int j = blockIdx.y + 1, b = blockIdx.z;
  const int t0 = j * chunk, tn = min(chunk, S - t0);
  const long long at = ((long long)b * S + t0) * D + d;
  float P = 1.f, c = 0.f;
  float av[kN1Batch], gv[kN1Batch];
  auto load = [&](int t, float (&x)[kN1Batch], float (&y)[kN1Batch]) {
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t - u >= 0) {
        x[u] = __ldg(a + at + (long long)(t - u) * D);
        y[u] = __ldg(dy + at + (long long)(t - u) * D);
      }
    }
  };
  if (tn > 0) load(tn - 1, av, gv);
  for (int t = tn - 1; t >= 0; t -= kN1Batch) {
    float an[kN1Batch], gn[kN1Batch];
    if (t - kN1Batch >= 0) load(t - kN1Batch, an, gn);
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t - u >= 0) {
        c = __fmul_rn(av[u], __fadd_rn(gv[u], c));
        P = __fmul_rn(P, av[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      av[u] = an[u];
      gv[u] = gn[u];
    }
  }
  carry[((long long)b * chunks + j) * D + d] = make_float2(P, c);
}

// chunk j (blockIdx.y) of channels d of batch row b: the carry into its
// last step (dh_last folded through the later chunks' pairs, last chunk
// first), then its steps in reverse: da, dbx, and dh0 from chunk 0
__global__ void __launch_bounds__(kN1Tile)
    n1_bwd_walk(const float* __restrict__ a, const float* __restrict__ h,
                const float* __restrict__ h0, const float* __restrict__ dy,
                const float* __restrict__ dh_last, const float2* __restrict__ carry,
                float* __restrict__ da, float* __restrict__ dbx, float* __restrict__ dh0,
                int S, int D, int chunk) {
  const int d = blockIdx.x * kN1Tile + threadIdx.x;
  if (d >= D) return;
  const int j = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  const long long row = (long long)b * D + d;
  float c = dh_last != nullptr ? dh_last[row] : 0.f;
  const float2* cb = carry + (long long)b * chunks * D + d;
#pragma unroll 8
  for (int k = chunks - 1; k > j; --k) {
    const float2 p = cb[(long long)k * D];
    c = __fadd_rn(__fmul_rn(p.x, c), p.y);
  }
  const float start = h0 != nullptr ? h0[row] : 0.f;
  const int t0 = j * chunk, tn = min(chunk, S - t0);
  const long long at = ((long long)b * S + t0) * D + d;
  float av[kN1Batch], gv[kN1Batch], hv[kN1Batch];
  auto load = [&](int t, float (&x)[kN1Batch], float (&y)[kN1Batch], float (&z)[kN1Batch]) {
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t - u >= 0) {
        const long long o = at + (long long)(t - u) * D;
        x[u] = __ldcs(a + o);
        y[u] = __ldcs(dy + o);
        z[u] = t0 + t - u > 0 ? __ldcs(h + o - D) : start;  // h_{t-1}
      }
    }
  };
  if (tn > 0) load(tn - 1, av, gv, hv);
  for (int t = tn - 1; t >= 0; t -= kN1Batch) {
    float an[kN1Batch], gn[kN1Batch], hn[kN1Batch];
    if (t - kN1Batch >= 0) load(t - kN1Batch, an, gn, hn);
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      if (t - u >= 0) {
        const long long o = at + (long long)(t - u) * D;
        const float g = __fadd_rn(gv[u], c);
        da[o] = __fmul_rn(g, hv[u]);
        dbx[o] = g;
        c = __fmul_rn(av[u], g);
      }
    }
#pragma unroll
    for (int u = 0; u < kN1Batch; ++u) {
      av[u] = an[u];
      gv[u] = gn[u];
      hv[u] = hn[u];
    }
  }
  if (j == 0) dh0[row] = c;
}

}  // namespace

// The (a, bx) entry's backward at N = 1, in chunks of `chunk` steps (a
// positive multiple of 16): a, h (the forward's y), dy, da, dbx [B, S, D];
// h0, dh_last [B, D] or null (zero); dh0 [B, D]; `carry` float32 scratch of
// 2 · B · max(1, ceil(S / chunk)) · D.  All float32 and contiguous.
// Returns cudaGetLastError() after the launches.
extern "C" int selective_scan_n1_bwd_launch(const void* a, const void* h, const void* h0,
                                            const void* dy, const void* dh_last, void* da,
                                            void* dbx, void* dh0, void* carry, int B, int S,
                                            int D, int chunk, void* stream) {
  if (B < 0 || S < 0 || D < 0 || B > 65535 || chunk < kN1Batch || chunk % kN1Batch != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const long long chunks = S == 0 ? 1 : ((long long)S + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)((D + kN1Tile - 1) / kN1Tile);
  float2* cr = static_cast<float2*>(carry);
  if (chunks > 1)
    n1_bwd_totals<<<dim3(tiles, (unsigned)chunks - 1, B), kN1Tile, 0, s>>>(
        (const float*)a, (const float*)dy, cr, S, D, chunk, (int)chunks);
  n1_bwd_walk<<<dim3(tiles, (unsigned)chunks, B), kN1Tile, 0, s>>>(
      (const float*)a, (const float*)h, (const float*)h0, (const float*)dy,
      (const float*)dh_last, cr, (float*)da, (float*)dbx, (float*)dh0, S, D, chunk);
  return (int)cudaGetLastError();
}

// dt, dy, ddt: [B, S, D] float32; A: [D, N] float32; Bm, Cm, dB, dC:
// [B, S, N] float32; x, dx: [B, S, D], bf16 when x_bf16 else float32;
// ckpt: [B, ceil(S/16), D, N] float32 as selective_scan_fused_ckpt_launch
// writes it; dh_last: [B, D, N] float32 or null (zero); dh0: [B, D, N]
// float32; dA: [D, N] float32; scratch: B·D·N + 2·B·ceil(D/CH)·S·N
// floats, CH the channels of a block (block_channels: at least 32, so
// B·D·N + 2·B·ceil(D/32)·S·N always suffices).  All contiguous.  N a power
// of two ≤ 32.  Returns cudaGetLastError() after the launches.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* A, const void* Bm,
                                         const void* Cm, const void* x, int x_bf16,
                                         const void* ckpt, const void* dy, const void* dh_last,
                                         void* ddt, void* dx, void* dA, void* dB, void* dC,
                                         void* dh0, void* scratch, int B, int S, int D, int N,
                                         void* stream) {
  if (B < 0 || S < 0 || D < 0 || N < 1 || N > 32 || (N & (N - 1)) != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const int nblk = (D + block_channels(N) - 1) / block_channels(N);
  float* part = (float*)scratch;
  Args g{(const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm, x,
         (const float*)ckpt, (const float*)dy, (const float*)dh_last, (float*)ddt, dx,
         (float*)dh0, part, part + (long long)B * D * N,
         part + (long long)B * D * N + (long long)B * nblk * S * N, S, D, N, nblk};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rc = x_bf16 ? launch<__nv_bfloat16>(g, B, s) : launch<float>(g, B, s);
  if (rc != 0) return rc;
  const long long work = (long long)B * S * N > (long long)D * N ? (long long)B * S * N
                                                                 : (long long)D * N;
  const int threads = 256;
  const long long blocks = (work + threads - 1) / threads;
  scan_bwd_reduce_kernel<<<(unsigned)(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535),
                           threads, 0, s>>>(g.dB_part, g.dC_part, g.dA_part, (float*)dB,
                                            (float*)dC, (float*)dA, B, S, D, N, nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
