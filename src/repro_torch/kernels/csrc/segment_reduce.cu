// Segment-⊕ (⊕ ∈ {+, min, max}) for Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `segment_reduce` (src/repro/kernels/
// segment_reduce.py, `_kernel`), which builds a one-hot [bn, bk] block per
// step and reduces it on the MXU.  Hopper has no reason to materialize the
// one-hot: each row's id names its destination directly, so this kernel is a
// scatter with atomics.
//
// Bound: device-memory bytes.  The least traffic is the ids and values read
// once (4N + 4N·D bytes; 4N alone when the value is a broadcast constant)
// and the [K, D] output written once, plus its identity fill.  Design:
//   * grid-stride pass over rows, one row's D columns per iteration; a
//     dropped row (id < 0 or id ≥ K) is never read, which gives the drop
//     semantics and keeps 0×inf / NaN of a dropped row out of the result;
//   * when the [K, D] output fits shared memory (≤ 48K cells) every block
//     keeps a private identity-filled copy, reduces into it with shared
//     atomics, then merges the non-identity cells into device memory with
//     one global atomic each — the histogram case, where global atomics
//     would serialize on a few hundred addresses;
//   * otherwise rows go straight to device memory with global atomics — the
//     large-K group-by case, whose output stays resident in the 50 MB L2.
// Float + uses atomicAdd (the order of the adds, and so the last bits of a
// sum, changes from run to run); float min/max use an atomicCAS loop that
// propagates NaN like jnp.min/jnp.max; int32 uses atomicAdd/Min/Max and is
// exact.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemThreads = 1024;       // one large private copy per SM still
                                         // keeps 32 warps in flight
constexpr int kSmemCells = 48 * 1024;    // 192 KB of 4-byte cells

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int OP> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, kSum>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return INFINITY; }
template <> __device__ __forceinline__ float identity<float, kMax>() { return -INFINITY; }
template <> __device__ __forceinline__ int identity<int, kSum>() { return 0; }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return -INT_MAX; }

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// works on shared and device memory alike (generic addressing)
template <int OP>
__device__ __forceinline__ void cas_minmax(float* addr, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(addr);
  unsigned int old = *a;
  unsigned int assumed;
  do {
    assumed = old;
    float cur = __uint_as_float(assumed);
    float nv = OP == kMin ? nan_min(cur, v) : nan_max(cur, v);
    unsigned int nb = __float_as_uint(nv);
    if (nb == assumed) return;
    old = atomicCAS(a, assumed, nb);
  } while (old != assumed);
}

template <typename T, int OP> __device__ __forceinline__ void atomic_op(T* addr, T v);
template <> __device__ __forceinline__ void atomic_op<float, kSum>(float* a, float v) { atomicAdd(a, v); }
template <> __device__ __forceinline__ void atomic_op<float, kMin>(float* a, float v) { cas_minmax<kMin>(a, v); }
template <> __device__ __forceinline__ void atomic_op<float, kMax>(float* a, float v) { cas_minmax<kMax>(a, v); }
template <> __device__ __forceinline__ void atomic_op<int, kSum>(int* a, int v) { atomicAdd(a, v); }
template <> __device__ __forceinline__ void atomic_op<int, kMin>(int* a, int v) { atomicMin(a, v); }
template <> __device__ __forceinline__ void atomic_op<int, kMax>(int* a, int v) { atomicMax(a, v); }

template <typename T, int OP>
__global__ void fill_identity(T* __restrict__ out, long long cells) {
  const T ident = identity<T, OP>();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cells; i += stride)
    out[i] = ident;
}

// vstride: elements between consecutive rows of `vals` (D for a dense
// [N, D] block, 0 when every row carries the same broadcast value)
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
seg_global(const int* __restrict__ ids, const T* __restrict__ vals, T* __restrict__ out,
           long long n, int d, long long vstride, int k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    const int id = __ldg(ids + row);
    if (id < 0 || id >= k) continue;            // dropped: value never read
    const T* v = vals + row * vstride;
    T* o = out + (long long)id * d;
    for (int j = 0; j < d; ++j) atomic_op<T, OP>(o + j, __ldg(v + j));
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kSmemThreads)
seg_smem(const int* __restrict__ ids, const T* __restrict__ vals, T* __restrict__ out,
         long long n, int d, long long vstride, int k) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int cells = k * d;
  const T ident = identity<T, OP>();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) acc[j] = ident;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    const int id = __ldg(ids + row);
    if (id < 0 || id >= k) continue;
    const T* v = vals + row * vstride;
    T* o = acc + id * d;
    for (int j = 0; j < d; ++j) atomic_op<T, OP>(o + j, __ldg(v + j));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const T v = acc[j];
    if (!(v == ident)) atomic_op<T, OP>(out + j, v);   // NaN != ident: merged
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int OP>
void launch(const int* ids, const T* vals, T* out, long long n, int d, long long vstride,
            int k, cudaStream_t stream) {
  const long long cells = (long long)k * d;
  const int sms = num_sms();
  long long fill_blocks = (cells + kThreads - 1) / kThreads;
  if (fill_blocks > 4LL * sms) fill_blocks = 4LL * sms;
  if (fill_blocks < 1) fill_blocks = 1;
  fill_identity<T, OP><<<(int)fill_blocks, kThreads, 0, stream>>>(out, cells);
  if (n == 0 || cells == 0) return;
  long long want = (n + kThreads - 1) / kThreads;
  // a private copy pays off once the rows outnumber the cells it must
  // initialize and merge
  if (cells <= kSmemCells && n >= 8 * cells) {
    const size_t bytes = (size_t)cells * sizeof(T);
    cudaFuncSetAttribute(seg_smem<T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_smem<T, OP>, kSmemThreads, bytes);
    if (per_sm < 1) per_sm = 1;
    long long blocks = (long long)per_sm * sms;
    const long long want_smem = (n + kSmemThreads - 1) / kSmemThreads;
    if (blocks > want_smem) blocks = want_smem;
    seg_smem<T, OP><<<(int)blocks, kSmemThreads, bytes, stream>>>(ids, vals, out, n, d, vstride, k);
  } else {
    long long blocks = 16LL * sms;
    if (blocks > want) blocks = want;
    seg_global<T, OP><<<(int)blocks, kThreads, 0, stream>>>(ids, vals, out, n, d, vstride, k);
  }
}

template <typename T>
void launch_op(int op, const int* ids, const T* vals, T* out, long long n, int d,
               long long vstride, int k, cudaStream_t s) {
  if (op == kSum) launch<T, kSum>(ids, vals, out, n, d, vstride, k, s);
  else if (op == kMin) launch<T, kMin>(ids, vals, out, n, d, vstride, k, s);
  else launch<T, kMax>(ids, vals, out, n, d, vstride, k, s);
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  op: 0 = +, 1 = min, 2 = max.
// ids [n] int32; vals rows of d elements, `vstride` elements apart; out
// [k, d], fully written (identity where no row lands).  Returns
// cudaGetLastError() after the launches.
extern "C" int segment_reduce_launch(int dtype, int op, const void* ids, const void* vals,
                                     void* out, long long n, int d, long long vstride, int k,
                                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (op < 0 || op > 2 || d < 1 || k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_op<float>(op, (const int*)ids, (const float*)vals, (float*)out, n, d, vstride, k, s);
  else if (dtype == 1)
    launch_op<int>(op, (const int*)ids, (const int*)vals, (int*)out, n, d, vstride, k, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
