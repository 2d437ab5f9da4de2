// The Mamba-1 selective scan h_t = a_t ⊙ h_{t-1} + bx_t, y_t = Σ_N c_t ⊙ h_t,
// for Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `selective_scan` (src/repro/kernels/
// selective_scan.py, `_kernel`): a grid of (B, D/bd) steps that each own a
// [bd, N] state slice in VMEM and walk the sequence with a fori_loop, so
// the state never leaves fast memory.  This kernel also takes an initial
// state h0 and writes the final state h_last, both optional: the serving
// path carries the state across chunks and into the decode cache.
//
// Bound: device-memory bytes.  Each element of a and bx [B, S, D, N] is
// read once, c [B, S, N] is read by every channel (it stays in L1/L2), y
// [B, S, D] is written once; there are ~3 flops per element of a.  Design:
//   * one thread per (b, d, n): N consecutive lanes of a warp own one
//     channel d, so a warp's loads of a and bx at step t are one contiguous
//     run of 32 floats and a block's a run of 256;
//   * the state h stays in a register for the whole sequence; the loop over
//     S is sequential only through that one FMA, and is unrolled so that
//     the loads of later steps are in flight while earlier steps finish;
//   * y_t is a shuffle sum over the N lanes of the channel (width N); lane
//     n = 0 writes it;
//   * channels past D (a ragged last block) load nothing and write nothing
//     but still take part in the shuffles.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                          const float* __restrict__ c, const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_last, int S, int D,
                          int N) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * (kThreads / N) + threadIdx.x / N;
  const int n = threadIdx.x % N;
  const bool live = d < D;
  const long long step = (long long)D * N;            // a/bx stride of t
  const float* ap = a + (long long)b * S * step + (long long)d * N + n;
  const float* bp = bx + (long long)b * S * step + (long long)d * N + n;
  const float* cp = c + (long long)b * S * N + n;
  float* yp = y + (long long)b * S * D + d;
  float h = (live && h0 != nullptr) ? h0[((long long)b * D + d) * N + n] : 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const float av = live ? ap[t * step] : 0.f;
    const float bv = live ? bp[t * step] : 0.f;
    h = fmaf(av, h, bv);
    float p = h * cp[(long long)t * N];
    for (int off = N >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off, N);
    if (live && n == 0) yp[(long long)t * D] = p;
  }
  if (live && h_last != nullptr) h_last[((long long)b * D + d) * N + n] = h;
}

}  // namespace

// a, bx: [B, S, D, N]; c: [B, S, N]; y: [B, S, D]; h0, h_last: [B, D, N]
// or null; all float32 and contiguous.  N must divide 32 (a power of two).
// Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(const void* a, const void* bx, const void* c,
                                     const void* h0, void* y, void* h_last, int B, int S,
                                     int D, int N, void* stream) {
  if (B < 0 || S < 0 || D < 0 || N < 1 || N > 32 || (N & (N - 1)) != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const int per_block = kThreads / N;
  const dim3 grid((D + per_block - 1) / per_block, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  selective_scan_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)a, (const float*)bx, (const float*)c, (const float*)h0, (float*)y,
      (float*)h_last, S, D, N);
  return (int)cudaGetLastError();
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
