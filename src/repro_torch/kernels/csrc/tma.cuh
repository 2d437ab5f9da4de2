// Tensor maps for TMA loads (cp.async.bulk.tensor, csrc/wgmma.cuh's
// tma_load_3d), built on the host at each launch: a [BH][rows][HD] bf16
// tensor read as boxes of [box_rows][64] columns in the 128-byte swizzle,
// one wgmma.cuh panel a box.  libcuda's cuTensorMapEncodeTiled is looked
// up at run time through cudaGetDriverEntryPoint, so nothing links
// against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got) ==
            cudaSuccess &&
        got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a [BH][rows][HD] bf16 tensor as boxes of [box_rows][64] with the 128-byte
// swizzle (one wgmma.cuh panel a box); rows past `rows` read as zeros.
// Returns 0 or a cudaError_t
inline int tensor_map(CUtensorMap* map, const void* base, int HD, int rows, int BH,
                      int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tma
