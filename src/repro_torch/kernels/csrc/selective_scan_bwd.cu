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
// csrc/selective_scan.cuh).  A thread walks
// the chunks last to first: it recomputes its chunk's 16 states from the
// checkpoint in registers (exactly the forward's arithmetic), then walks
// them in reverse.  Nothing [B, S, D, N]-sized is stored.
//
// Layout: the forward's.  A block owns 32 channels d of one batch row b;
// a channel's N states are spread over L = N / NPT lanes, NPT = 2 states a
// thread (N = 1: one state on one lane); the chunk's dt, x, dy (32
// channels) and B, C rows are staged in shared memory.
//
// Sums, with no float atomics (the same bits on every launch):
//   * ddt, dx (over n): a shuffle sum over the channel's L lanes;
//   * dB, dC (over d): a shuffle sum over the warp's channels, then the
//     block's warps summed in order in shared memory, one partial per
//     (b, block of 32 channels, t, n); a second launch sums the D/32
//     partials in order;
//   * dA (over b and t): each thread sums its t in registers, one partial
//     per (b, d, n); the second launch sums the B partials in order.
//
// Bound: the S·D·N exponentials, twice (the recompute and the reverse
// walk), or the bytes: dt, x, dy, ddt, dx [B, S, D] and the checkpoints
// read once.  The shuffles (log2 L for ddt and dx, log2(32/L) for dB and
// dC, a step) come on top: this first version is not tuned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

constexpr int kChannels = 32;   // channels d a block owns

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

template <int NPT, int L>
constexpr int smem_floats() {
  // dt, x, dy, ddt, dx [kCkpt][32]; B, C [kCkpt][N]; warp sums [kCkpt][L][N] × 2
  return kCkpt * (5 * kChannels + 2 * NPT * L + 2 * L * NPT * L);
}

template <int NPT, int L, typename XT>
__global__ void __launch_bounds__(kChannels * L) scan_bwd_kernel(Args g) {
  constexpr int N = NPT * L;
  constexpr int W = L;  // warps a block (32·L threads)
  extern __shared__ __align__(16) float sm[];
  float* dt_s = sm;                         // [kCkpt][32]
  float* x_s = dt_s + kCkpt * kChannels;    // [kCkpt][32]
  float* dy_s = x_s + kCkpt * kChannels;    // [kCkpt][32]
  float* ddt_s = dy_s + kCkpt * kChannels;  // [kCkpt][32]
  float* dx_s = ddt_s + kCkpt * kChannels;  // [kCkpt][32]
  float* b_s = dx_s + kCkpt * kChannels;    // [kCkpt][N]
  float* c_s = b_s + kCkpt * N;             // [kCkpt][N]
  float* wb_s = c_s + kCkpt * N;            // [kCkpt][W][N]
  float* wc_s = wb_s + kCkpt * W * N;       // [kCkpt][W][N]

  const int S = g.S, D = g.D;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * kChannels;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = tid / L;               // channel within the block
  const int n0 = (tid % L) * NPT;       // first state of the thread
  const int d = d0 + ch;
  const bool live = d < D;
  const int nthreads = blockDim.x;
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

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCkpt;
    const int tn = min(kCkpt, S - t0);
    const long long row0 = (long long)b * S + t0;  // first [B, S] row
    __syncthreads();  // the last chunk's reads of shared memory are done
    for (int i = tid; i < tn * kChannels; i += nthreads) {
      const int t = i / kChannels, dd = d0 + i % kChannels;
      const long long off = (row0 + t) * D + dd;
      const bool ok = dd < D;
      dt_s[i] = ok ? __ldg(g.dt + off) : 0.f;
      x_s[i] = ok ? widen<XT>(x[off]) : 0.f;
      dy_s[i] = ok ? __ldg(g.dy + off) : 0.f;
    }
    for (int i = tid; i < tn * N; i += nthreads) {
      b_s[i] = __ldg(g.Bm + row0 * N + i);
      c_s[i] = __ldg(g.Cm + row0 * N + i);
    }
    __syncthreads();

    // the chunk's states, recomputed from its checkpoint as the forward
    // computes them
    float hs[NPT], hist[kCkpt][NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      hs[j] = live ? g.ckpt[(((long long)b * nck + c) * D + d) * N + n0 + j] : 0.f;
#pragma unroll
    for (int i = 0; i < kCkpt; ++i) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float hp = i == 0 ? hs[j] : hist[i - 1][j];
        if (i < tn) {
          const float dtv = dt_s[i * kChannels + ch];
          const float dxv = dtv * x_s[i * kChannels + ch];
          hist[i][j] = fmaf(exp2f(dtv * A2[j]), hp, dxv * b_s[i * N + n0 + j]);
        } else {
          hist[i][j] = hp;
        }
      }
    }

    // the reverse walk over the chunk
#pragma unroll
    for (int i = kCkpt - 1; i >= 0; --i) {
      if (i >= tn) continue;
      const float dtv = dt_s[i * kChannels + ch];
      const float xv = x_s[i * kChannels + ch];
      const float dyv = dy_s[i * kChannels + ch];
      float sdt = 0.f, sgb = 0.f, pb[NPT], pc[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float a = exp2f(dtv * A2[j]);
        const float hp = i == 0 ? hs[j] : hist[i - 1][j];
        const float gj = fmaf(c_s[i * N + n0 + j], dyv, gc[j]);  // g_t
        const float gb = gj * b_s[i * N + n0 + j];
        const float dz = gj * hp * a;
        sdt = fmaf(gb, xv, fmaf(dz, A[j], sdt));
        sgb += gb;
        dA[j] = fmaf(dz, dtv, dA[j]);
        pb[j] = gj * (dtv * xv);
        pc[j] = dyv * hist[i][j];
        gc[j] = a * gj;
      }
      // over the channel's L lanes: ddt and Σ g·B
#pragma unroll
      for (int off = L >> 1; off > 0; off >>= 1) {
        sdt += __shfl_xor_sync(0xffffffffu, sdt, off, L);
        sgb += __shfl_xor_sync(0xffffffffu, sgb, off, L);
      }
      if (n0 == 0) {
        ddt_s[i * kChannels + ch] = sdt;
        dx_s[i * kChannels + ch] = sgb * dtv;
      }
      // over the warp's channels (lanes l, l + L, l + 2L, ...): dB and dC
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {
          pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], off);
          pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], off);
        }
      }
      if (lane < L) {
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          wb_s[(i * W + warp) * N + n0 + j] = pb[j];
          wc_s[(i * W + warp) * N + n0 + j] = pc[j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < tn * kChannels; i += nthreads) {
      const int t = i / kChannels, dd = d0 + i % kChannels;
      if (dd < D) {
        const long long off = (row0 + t) * D + dd;
        g.ddt[off] = ddt_s[i];
        dx[off] = narrow<XT>(dx_s[i]);
      }
    }
    // the block's partial sums over its 32 channels, warps in order
    for (int i = tid; i < tn * N; i += nthreads) {
      const int t = i / N, n = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sb += wb_s[(t * W + w) * N + n];
        sc += wc_s[(t * W + w) * N + n];
      }
      const long long off = (((long long)b * g.nblk + blk) * S + t0 + t) * N + n;
      g.dB_part[off] = sb;
      g.dC_part[off] = sc;
    }
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
  const size_t bytes = smem_floats<NPT, L>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(scan_bwd_kernel<NPT, L, XT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  scan_bwd_kernel<NPT, L, XT><<<dim3(g.nblk, B), kChannels * L, bytes, s>>>(g);
  return (int)cudaGetLastError();
}

// NPT = min(2, N) states a thread on L = N / NPT lanes, as the forward
template <typename XT>
int launch(const Args& g, int B, cudaStream_t s) {
  switch (g.N) {
    case 1: return run<1, 1, XT>(g, B, s);
    case 2: return run<2, 1, XT>(g, B, s);
    case 4: return run<2, 2, XT>(g, B, s);
    case 8: return run<2, 4, XT>(g, B, s);
    case 16: return run<2, 8, XT>(g, B, s);
    case 32: return run<2, 16, XT>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dt, dy, ddt: [B, S, D] float32; A: [D, N] float32; Bm, Cm, dB, dC:
// [B, S, N] float32; x, dx: [B, S, D], bf16 when x_bf16 else float32;
// ckpt: [B, ceil(S/16), D, N] float32 as selective_scan_fused_ckpt_launch
// writes it; dh_last: [B, D, N] float32 or null (zero); dh0: [B, D, N]
// float32; dA: [D, N] float32; scratch: B·D·N + 2·B·ceil(D/32)·S·N
// floats.  All contiguous.  N a power of two ≤ 32.  Returns
// cudaGetLastError() after the launches.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* A, const void* Bm,
                                         const void* Cm, const void* x, int x_bf16,
                                         const void* ckpt, const void* dy, const void* dh_last,
                                         void* ddt, void* dx, void* dA, void* dB, void* dC,
                                         void* dh0, void* scratch, int B, int S, int D, int N,
                                         void* stream) {
  if (B < 0 || S < 0 || D < 0 || N < 1 || N > 32 || (N & (N - 1)) != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const int nblk = (D + kChannels - 1) / kChannels;
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
