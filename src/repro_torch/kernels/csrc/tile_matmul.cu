// Block-sparse C = A @ B over a §5 packed lhs, for Hopper (sm_90a),
// hand-written.
//
// Replaces the Pallas TPU kernel `tile_matmul` (src/repro/kernels/
// tile_matmul.py, `_kernel` and `_masked_kernel`).  The TPU grid cannot skip
// a block, so its masked form multiplies every absent tile out by its mask
// value of 0.  Here each block reads the tile mask itself and skips a k-step
// whose A tiles are all absent: an absent tile costs no loads and no FMAs
// and contributes exactly zero, which is `unpack`'s meaning.
//
// Bound: operations.  2·M·N·K·density flops against 67 TFLOP/s of FP32
// outside the tensor cores (989 TFLOP/s bf16 on the tensor cores, which this
// first kernel does not use).  Design: one 128×128 output tile per block of
// 256 threads, each thread an 8×8 register sub-tile accumulated in float32;
// A and B stage through shared memory 8 k-values at a time (bf16 inputs are
// widened with __bfloat162float as they are staged).  A k-step stays inside
// the packing tiles it touches whatever (bm, bk) is: where one mask entry
// covers the whole step it scales the staged A tile once, otherwise every
// element looks up its own tile.  Ragged M, N and K edges load zeros and
// store nothing.  A is read through four strides, so the same kernel takes a
// dense row-major lhs or the §5 packed tiles in place (no unpack, no padded
// copy of B).  wgmma, TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);    // 256
constexpr int kColThreads = BN / TN;               // 16
static_assert(kThreads % BK == 0 && BM * BK % kThreads == 0,
              "A staging: every thread stages whole rows of one k column");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Logical A [M, K]: element (r, c) lies at
//   (r / bm)·sa0 + (c / bk)·sa1 + (r % bm)·sa2 + (c % bk)·sa3
// (a dense row-major lhs: {bm·K, bk, K, 1}; packed tiles [Mt, Kt, bm, bk]:
// {Kt·bm·bk, bm·bk, bk, 1}).  B [K, N] row-major; mask [ceil(M/bm), Kt]
// float or null; C [M, N] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(const T* __restrict__ A, long long sa0, long long sa1,
                   long long sa2, long long sa3, const T* __restrict__ B,
                   const float* __restrict__ mask, float* __restrict__ C,
                   int M, int N, int K, int bm, int bk, int Kt) {
  __shared__ float As[BK][BM + 4];    // k-major; +4 keeps the staging stores conflict-free
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tr = tid / kColThreads;   // rows tr*TM .. tr*TM+7
  const int tc = tid % kColThreads;   // cols tc, tc+16, ... (conflict-free Bs reads)
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int m_last = min(m0 + BM, M) - 1;
  const int mr0 = mask ? m0 / bm : 0;
  const int mr1 = mask ? m_last / bm : 0;

  // A staging: thread tid stages column tid % BK of every k-step for the
  // same kARows rows each step, so the rows' tile indices and offsets are
  // worked out once here, and each step costs one division (its column).
  constexpr int kARows = BM * BK / kThreads;         // 4
  const int a_kk = tid % BK;
  int a_mm[kARows], a_ti[kARows];
  long long a_off[kARows];
#pragma unroll
  for (int j = 0; j < kARows; ++j) {
    a_mm[j] = tid / BK + j * (kThreads / BK);
    const int gr = m0 + a_mm[j];
    a_ti[j] = gr < M ? gr / bm : -1;                 // -1: past the ragged edge
    a_off[j] = gr < M ? a_ti[j] * sa0 + (gr - a_ti[j] * bm) * sa2 : 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    float scale = 1.0f;
    bool per_elem = false;
    if (mask != nullptr) {
      const int kc0 = k0 / bk;
      const int kc1 = (min(k0 + BK, K) - 1) / bk;
      const float first = mask[(long long)mr0 * Kt + kc0];
      bool any = false, uniform = true;
      for (int r = mr0; r <= mr1; ++r)
        for (int c = kc0; c <= kc1; ++c) {
          const float mv = mask[(long long)r * Kt + c];
          any |= (mv != 0.0f);
          uniform &= (mv == first);
        }
      if (!any) continue;             // uniform across the block: every thread skips
      if (uniform) scale = first; else per_elem = true;
    }
    {
      const int gc = k0 + a_kk;
      const int tj = gc / bk;
      const long long col = tj * sa1 + (gc - tj * bk) * sa3;
#pragma unroll
      for (int j = 0; j < kARows; ++j) {
        float v = 0.0f;
        if (a_ti[j] >= 0 && gc < K) {
          const float mv = per_elem ? mask[(long long)a_ti[j] * Kt + tj] : scale;
          if (mv != 0.0f) v = to_f32(A[a_off[j] + col]) * mv;
        }
        As[a_kk][a_mm[j]] = v;
      }
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int gr = k0 + kk, gc = n0 + nn;
      Bs[kk][nn] = (gr < K && gc < N) ? to_f32(B[(long long)gr * N + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tc + j * kColThreads];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + tr * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tc + j * kColThreads;
      if (c < N) C[(long long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32 A and B, 1 = bfloat16 A and B.  sa0..sa3: A's strides
// in elements, as the kernel reads them.  mask may be null (the unmasked
// kernel); otherwise it is [ceil(M/bm), ceil(K/bk)] float32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tile_matmul_launch(int dtype, const void* A, long long sa0, long long sa1,
                                  long long sa2, long long sa3, const void* B,
                                  const void* mask, void* C, int M, int N, int K, int bm,
                                  int bk, void* stream) {
  if (M < 0 || N < 0 || K < 0 || bm < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const int Kt = (K + bk - 1) / bk;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  if (dtype == 0)
    tile_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)A, sa0, sa1, sa2, sa3, (const float*)B, mk, (float*)C, M, N, K, bm,
        bk, Kt);
  else if (dtype == 1)
    tile_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)A, sa0, sa1, sa2, sa3, (const __nv_bfloat16*)B, mk, (float*)C,
        M, N, K, bm, bk, Kt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* tile_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
