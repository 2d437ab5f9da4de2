// Causal (or full) attention with an online softmax, for Hopper (sm_90a),
// hand-written.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`): a grid of (batch*heads, Sq/bq) steps that
// each hold one query tile and scan K/V in [bk] chunks with a running
// (max, sum, acc) in VMEM, never materialising the [Sq, Sk] scores.
//
// Bound: operations.  Causal attention over [BH, S, hd] needs
// 4·BH·hd·S(S+1)/2 flops against (4·BH·S·hd) elements of traffic, far above
// the card's flop-per-byte line at the prefill lengths of the serve path.
// This first kernel does the products with float32 FMAs (no tensor cores,
// no TMA): its limit is the FMA rate and the shared-memory reads that feed
// it.  Design:
//   * one block of 256 threads per (bh, 64-row query tile), the tiles with
//     the most keys scheduled first; the query tile
//     is loaded once, scaled by hd^-0.5, into shared memory as float32;
//   * K and V are staged through shared memory in 32-key tiles, converted
//     to float32 on the way in; a causal block stops at its diagonal tile;
//   * thread (ty, tx) of a 16×16 grid owns query rows 4·ty..4·ty+3, the
//     score columns tx and tx+16 of a tile and the output columns
//     tx + 16·c; row max and row sum go across the 16 lanes of a half-warp
//     with shuffles; running max, sum and accumulator stay in registers in
//     float32, and the result is written once in the input type;
//   * the ragged last query tile and key tile are masked in the block:
//     padded keys weigh exactly 0, causal-masked scores are -1e30 as in
//     the TPU kernel, and rows past Sq are never written;
//   * rows of Q and K in shared memory are padded by one float so that the
//     strided column reads of the score loop hit distinct banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

namespace {

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 32;         // keys of a staged tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
         (size_t)BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                           const T* __restrict__ V, T* __restrict__ O, int Sq, int Sk,
                           float scale, int causal) {
  constexpr int LD = HD + 1;    // padded row stride of Qs and Ks
  constexpr int LP = BK + 1;    // padded row stride of Ps
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD], scaled
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][LP], this tile's softmax weights

  // the longest causal rows first, so that short blocks fill the tail
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* q = Q + (long long)bh * Sq * HD;
  const T* k = K + (long long)bh * Sk * HD;
  const T* v = V + (long long)bh * Sk * HD;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    Qs[r * LD + c] = row < Sq ? to_f(q[(long long)row * HD + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // a causal block sees keys up to its last row only
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, key = k0 + r;
      const bool ok = key < Sk;
      Ks[r * LD + c] = ok ? to_f(k[(long long)key * HD + c]) : 0.f;
      Vs[r * HD + c] = ok ? to_f(v[(long long)key * HD + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
      const float k0v = Ks[tx * LD + d];
      const float k1v = Ks[(tx + 16) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= Sk)
          s[i][j] = -INFINITY;  // padding: weighs exactly 0
        else if (causal && key > row)
          s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 is a real key, so the tile max is finite
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = __expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* o = O + (long long)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[(long long)row * HD + tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
           float scale, int causal, cudaStream_t s) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  // above 48 KB a block's shared memory has to be asked for explicitly
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Sk, float scale, int causal, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, Sq, Sk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q, out:
// [BH, Sq, hd]; k, v: [BH, Sk, hd]; all contiguous.  hd ∈ {16, 32, 64, 128}.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq, int Sk,
                                      int hd, float scale, int causal, void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, q, k, v, out, BH, Sq, Sk, scale, causal, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, BH, Sq, Sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
