// Block-sparse C = A @ B over a §5 packed lhs, for Hopper (sm_90a),
// hand-written.
//
// Replaces the Pallas TPU kernel `tile_matmul` (src/repro/kernels/
// tile_matmul.py, `_kernel` and `_masked_kernel`).  The TPU grid cannot skip
// a block, so its masked form multiplies every absent tile out by its mask
// value of 0.  Here each block skips the packing tiles whose rows of A are
// all absent: an absent tile costs no loads and no FMAs and contributes
// exactly zero, which is `unpack`'s meaning.
//
// Bound: operations.  2·M·N·K·density flops against 67 TFLOP/s of FP32
// outside the tensor cores; the float32 contract forbids TF32.  Design, the
// classic register-blocked SIMT SGEMM:
//   * one 128×128 output tile per block of 256 threads; thread (tr, tc) of
//     a 16×16 grid accumulates an 8×8 sub-tile in float32 registers, rows
//     {4tr..4tr+3, 64+4tr..}, columns {4tc..4tc+3, 64+4tc..}, so that every
//     shared-memory read is a float4 and a warp's reads are conflict-free
//     (A: two addresses, broadcast; B: 16 threads × 16 contiguous bytes);
//   * k-tiles of 16: A is staged k-major (As[k][m], rows padded by 4 floats
//     so that the transposing stores of a warp hit 32 distinct banks), B
//     row-major; both through a two-stage ring fed by register prefetch:
//     the global loads of k-tile s+1 are in flight while k-tile s is
//     multiplied, with one __syncthreads a k-tile.  Global loads are 16
//     bytes (float4, or 4 bf16 widened to float32 as they are staged)
//     wherever the four elements are contiguous and aligned, else scalar;
//   * the k loop runs over k-ranges, the packing tiles' columns
//     [c·bk, (c+1)·bk), inside which a row's address is its range's base
//     plus the column's offset times one stride (no division in the loop).
//     With a mask, the presence of a range is decided once, by one
//     __syncthreads_or over the block's rows, and an absent range costs
//     nothing more.  Each thread looks up the mask value of its own two
//     rows' tiles once a range, and scales its A elements by it as they are
//     staged (not at all when it is 1, and to exactly 0, without a load,
//     when it is 0).  So bm and bk need not divide 128 or 16: a k-tile that
//     runs past its range's end loads zeros there, and the next range
//     starts a k-tile of its own (a bk below 16 wastes the rest of each
//     k-tile);
//   * A is read through four strides, so the same kernel takes a dense
//     lhs in any layout or the §5 packed tiles in place (no unpack, no
//     padded copy of B).  Ragged M, N and K edges load zeros and store
//     nothing.
// wgmma, TMA and a bf16 tensor-core path are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int kThreads = 256;
constexpr int APAD = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements, 4·sizeof(T)-byte aligned, as float32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

template <typename T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// Logical A [M, K]: element (r, c) lies at
//   (r / bm)·sa0 + (c / bk)·sa1 + (r % bm)·sa2 + (c % bk)·sa3
// (a dense row-major lhs: {bm·K, bk, K, 1}; packed tiles [Mt, Kt, bm, bk]:
// {Kt·bm·bk, bm·bk, bk, 1}).  B [K, N] row-major; mask [ceil(M/bm), Kt]
// float or null; C [M, N] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tile_matmul_kernel(const T* __restrict__ A, long long sa0, long long sa1,
                   long long sa2, long long sa3, const T* __restrict__ B,
                   const float* __restrict__ mask, float* __restrict__ C,
                   int M, int N, int K, int bm, int bk, int Kt) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // staging: A rows ar and ar+64, k-offsets 4·aq..4·aq+3 (a warp: 16 rows ×
  // two quads); B rows bkr and bkr+8, columns gn..gn+3 (a warp: one row)
  const int ar = (tid & 15) + 16 * (tid >> 6);
  const int aq = (tid >> 4) & 3;
  const int bkr = tid >> 5;
  const int gn = n0 + (tid & 31) * 4;
  // this k-range's first column of A's rows ar and ar+64, their tile row
  // (-1 past the ragged edge) and their tiles' mask value in this range
  const T* a_rng[2];
  int a_ti[2];
  float sc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + ar + 64 * i;
    a_ti[i] = r < M ? r / bm : -1;
    a_rng[i] = r < M ? A + a_ti[i] * sa0 + (r - a_ti[i] * bm) * sa2 : A;
  }
  const bool a_vec = sa3 == 1;
  const bool b_vec = (N & 3) == 0 && gn + 3 < N && aligned4(B);

  // the k-ranges are the packing tiles' columns [c·bk, (c+1)·bk) ∩ [0, K)
  int c = -1, k0 = 0, rs = 0, re = 0;

  // the next k-tile, or false at the end; uniform across the block
  auto advance = [&]() -> bool {
    k0 += BK;
    if (k0 < re) return true;
    while (++c < Kt) {
      rs = c * bk;
      re = min(rs + bk, K);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (c > 0) a_rng[i] += sa1;
        sc[i] = a_ti[i] < 0 ? 0.f : mask ? mask[(long long)a_ti[i] * Kt + c] : 1.f;
      }
      if (!mask || __syncthreads_or(sc[0] != 0.f || sc[1] != 0.f)) {
        k0 = rs;
        return true;
      }
    }
    return false;
  };

  float ra[2][4], rb[2][4];   // the next k-tile, in flight
  auto load_global = [&]() {
    const int kin = k0 - rs + aq * 4;   // this thread's columns in the range
    const int width = re - rs;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i][0] = ra[i][1] = ra[i][2] = ra[i][3] = 0.f;
      if (sc[i] != 0.f && kin < width) {
        const T* p = a_rng[i] + kin * sa3;
        if (a_vec && kin + 3 < width && aligned4(p)) {
          load4(p, ra[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kin + e < width) ra[i][e] = to_f32(p[e * sa3]);
        }
        if (sc[i] != 1.f) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ra[i][e] *= sc[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gk = k0 + bkr + 8 * i;
      rb[i][0] = rb[i][1] = rb[i][2] = rb[i][3] = 0.f;
      if (gk < re) {
        const T* p = B + (long long)gk * N + gn;
        if (b_vec) {
          load4(p, rb[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gn + e < N) rb[i][e] = to_f32(p[e]);
        }
      }
    }
  };
  auto store_smem = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][aq * 4 + e][ar + 64 * i] = ra[i][e];
      *reinterpret_cast<float4*>(&Bs[buf][bkr + 8 * i][(tid & 31) * 4]) =
          make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
  };

  const int tr = tid >> 4, tc = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  if (advance()) {
    load_global();
    store_smem(0);
    __syncthreads();
    for (int buf = 0;; buf ^= 1) {
      const bool more = advance();
      if (more) load_global();   // in flight during this k-tile's FMAs
      compute(buf);
      if (!more) break;
      store_smem(buf ^ 1);       // last read one k-tile ago, before the barrier
      __syncthreads();
    }
  }

  const bool c_vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i >> 2) * 64 + tr * 4 + (i & 3);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tc * 4;
      float* dst = C + (long long)r * N + col;
      if (c_vec && col + 3 < N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) dst[e] = acc[i][h * 4 + e];
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32 A and B, 1 = bfloat16 A and B.  sa0..sa3: A's strides
// in elements, as the kernel reads them.  mask may be null (the unmasked
// kernel); otherwise it is [ceil(M/bm), ceil(K/bk)] float32.  C must be
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int tile_matmul_launch(int dtype, const void* A, long long sa0, long long sa1,
                                  long long sa2, long long sa3, const void* B,
                                  const void* mask, void* C, int M, int N, int K, int bm,
                                  int bk, void* stream) {
  if (M < 0 || N < 0 || K < 0 || bm < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(C) % 16) return (int)cudaErrorMisalignedAddress;
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
