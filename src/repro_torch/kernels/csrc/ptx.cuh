// Inline-PTX helpers shared by the hand-written Hopper kernels: 16-byte
// cp.async copies into shared memory, ldmatrix, the bf16 tensor-core
// product mma.sync m16n8k16 with float32 accumulators, and ex2.approx.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4·g + t, g = lane / 4,
// t = lane % 4), as the PTX ISA gives them:
//   A 16×16 (row): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                  a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9);
//   B 16×8 (col):  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g);
//   C 16×8:        c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1);
// each b32 register holds two bf16, the lower index in the lower half.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; `bytes` (0 or 16) are read and the rest of the
// 16 are zero-filled, so bytes = 0 writes zeros without touching `src`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i (row lane / 4, columns 2·(lane % 4)..+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// the same, each matrix transposed: register i receives matrix i's
// (rows 2·(lane % 4)..+1, column lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a · b on the tensor cores: bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit alone (results below 2^-126 flush to
// 0, where exp2f would add instructions to keep them)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats → one b32 of two bf16 (lo in the lower half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace ptx
