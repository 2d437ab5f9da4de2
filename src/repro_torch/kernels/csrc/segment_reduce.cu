// Segment-⊕ (⊕ ∈ {+, min, max}) for Hopper (sm_90a), hand-written,
// deterministic: the same inputs give the same bits on every launch, for
// float + too.
//
// Replaces the Pallas TPU kernel `segment_reduce` (src/repro/kernels/
// segment_reduce.py, `_kernel`), which builds a one-hot [bn, bk] block per
// step and reduces it on the MXU in a fixed grid order.  Hopper has no
// reason to materialize the one-hot: each row's id names its destination.
// What the TPU kernel's fixed order gives for free, this kernel keeps by
// construction: every row is combined in an order fixed by the ids alone,
// and every output cell is written once by the block that owns it.  No
// atomic touches device memory, and no separate fill launch runs.
//
// Bound: device-memory bytes.  The least traffic is the ids and values read
// once and the [K, D] output written once.  Data read once is loaded with
// the streaming hint (`__ldcs`, evict-first in L1 and L2).  Three paths:
//   * small [K, D] (≤ kSmallCells cells: kmeans K = 64, histogram K = 256):
//     each warp walks a fixed contiguous range of rows 32 at a time into
//     its own copy of [K, D] in shared memory; the block merges its warps'
//     copies in warp order into a partial [blocks, K, D] (device scratch),
//     and a second short kernel folds the partials in block order.  The
//     block count is fixed by N.
//   * large [K, D] (group-by into 2^17 … 4.85M segments): a partitioned
//     reduction over buckets of 2^shift consecutive ids (a bucket's slice
//     of [K, D] fits shared memory).  bucket_count counts each warp range's
//     kept rows per bucket; an exclusive scan over the [bucket, warp range]
//     counts gives each (bucket, warp range) its place; the scatter writes
//     every kept row's id and values there, stable in row order, so the
//     scratch holds the rows bucket after bucket; bucket_reduce gives a
//     block to a bucket, reduces its rows as the small path does (warps
//     over fixed sub-ranges, copies merged in warp order) and writes its
//     slice of the output once, identity where nothing landed.  This moves
//     about 2·(4 + |id|)·N + 3·4·N·D bytes against the least (|id| + 4D)·N.
//     A row scattered by itself leaves a partial 32-byte sector, which
//     costs the device memory a read-modify-write: bucket_scatter_staged
//     (one value a row, or none, and at most kStageBuckets buckets: every
//     main path) stages each bucket's open sector in shared memory and
//     stores it whole.
//   * wide rows (d ≥ 64: the MoE combine; segment_reduce_wide_launch): the
//     large path's count, scans and scatter, but the scatter moves records
//     of (id, row index) and no value, and the reduce's grid is (bucket,
//     column tile), as the TPU kernel tiles the row width in its grid: a
//     block reads its columns of each of its bucket's rows straight from
//     the input, 16 bytes a thread (bf16 widened in registers), and every
//     output cell is ⊕-ed in row order by the one thread that owns it.
// The device-count entry (`segment_reduce_launch_rows`) takes the row count
// from device memory: a lane of a served batch whose rows were padded to
// the batch's length, counted on the device.  The grid and the scratch are
// sized for the padded length; every block derives the blocks and warp
// ranges of the counted rows exactly as the host's plan derives them for a
// count it knows (`rows_of`), blocks and ranges past them reduce nothing,
// and the fold reads the same count.  So a padded launch gives the bits of
// a launch over the counted rows alone, and reads no padded row.
// The lanes entry (`segment_reduce_launch_lanes`) is that launch for the
// lanes of a served flush at once: the same group-by (op, K, d, dtype, N)
// over up to kMaxLanes lanes, each with its own ids, values, output and
// count (lane b reads counts[b]).  The lane is the grid's second axis in
// every pass, each lane's pointers reach the kernels by value in their
// parameters (`Lanes`, which a CUDA graph keeps), and each lane's scratch is
// a copy of one lane's plan, `lane_bytes` apart.  A lane's blocks do what
// its own device-count launch does, so every lane has that launch's bits;
// a flush runs each pass once with B lanes' blocks, not B chains of
// under-filled launches.  The wide route stays a launch a lane: no served
// program has rows of d ≥ 64.  Every pass of a solo launch is lane 0 of a
// grid of one lane.
// Within 32 rows, lanes that share an id commit to the warp's copy one at a
// time in lane order for a few rounds (`lane_rounds`), and the rest of a
// crowded id (a hot key) together, combined in a fixed tree
// (`match_group`, `add_crowded`).  A dropped row (id < 0 or id ≥ K) is
// never read, which gives the drop semantics and keeps 0×inf / NaN of a
// dropped row out of the result.  Float min/max propagate NaN like
// jnp.min/jnp.max; int32 is exact.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 8;                 // warps a block of every pass
constexpr int kThreads = kWarps * 32;
constexpr int kSmallCells = 2048;         // cells of one warp's copy (8 warps a block)
constexpr int kSliceCells = 8192;         // cells of a bucket's slice (4 warps' copies)
constexpr int kStageBuckets = 600;        // buckets whose sectors a block can stage
constexpr int kScanChunk = 4096;          // counts one scan block covers
constexpr int kUnroll = 8;                // 32-row groups loaded ahead
constexpr int kTags = 512;                // tag slots a warp (a power of two)
// lane-order rounds at most, then match_any: a small [K, D] meets ids
// that repeat within 32 rows as a matter of course, a large one only on a
// hot key
constexpr int kSmallRounds = 6, kLargeRounds = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 32;             // lanes of one lanes launch at most

// Each lane's ids, values and output: lane blockIdx.y's are read by its
// blocks (a solo launch is lane 0).  Passed by value, as a __grid_constant__
// parameter, so that indexing it by the lane reads the parameter bank.
struct Lanes {
  const void* ids[kMaxLanes];
  const void* vals[kMaxLanes];
  void* out[kMaxLanes];
};

// The calling block's lane's copy of a scratch array: lanes lie `lane_bytes`
// bytes apart
template <typename P>
__device__ __forceinline__ P* at_lane(P* p, long long lane_bytes) {
  return (P*)((const unsigned char*)p + (long long)blockIdx.y * lane_bytes);
}

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int OP> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, kSum>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return INFINITY; }
template <> __device__ __forceinline__ float identity<float, kMax>() { return -INFINITY; }
template <> __device__ __forceinline__ int identity<int, kSum>() { return 0; }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return -INT_MAX; }

template <typename T, int OP> __device__ __forceinline__ T combine(T a, T b);
template <> __device__ __forceinline__ float combine<float, kSum>(float a, float b) { return a + b; }
template <> __device__ __forceinline__ float combine<float, kMin>(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
template <> __device__ __forceinline__ float combine<float, kMax>(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
template <> __device__ __forceinline__ int combine<int, kSum>(int a, int b) { return a + b; }
template <> __device__ __forceinline__ int combine<int, kMin>(int a, int b) { return min(a, b); }
template <> __device__ __forceinline__ int combine<int, kMax>(int a, int b) { return max(a, b); }

// rows [begin, end) of warp range `wt` when N rows are cut into `ranges`
// ranges of `per` rows
__device__ __forceinline__ void warp_range(long long n, long long per, long long wt,
                                           long long* begin, long long* end) {
  *begin = min(n, wt * per);
  *end = min(n, *begin + per);
}

// Where the rows of a launch come from: none (the host's count and plan),
// or a row count in device memory, `n_rows[lane] - base` clamped to [0, n]
// (`base`: the launch's first row in the caller's rows; lane blockIdx.y),
// whose plan is clamp(ceil(m / rpb), 1, cap) blocks, as
// kernels/segment_reduce.py::_plan makes it on the host
struct Count {
  const int* n_rows;
  long long base;
  int cap, rpb;
};

// The rows a launch reduces and their split: m rows, `blocks` blocks of
// kWarps warp ranges of `per` rows
struct Rows {
  long long m, per;
  int blocks;
};
__device__ __forceinline__ Rows rows_of(long long n, long long per, int blocks, Count c) {
  if (c.n_rows == nullptr) return {n, per, blocks};
  const long long m = max(0LL, min((long long)c.n_rows[blockIdx.y] - c.base, n));
  const int b = (int)max(1LL, min((long long)c.cap, (m + c.rpb - 1) / c.rpb));
  const long long ranges = (long long)b * kWarps;
  return {m, ((m + ranges - 1) / ranges + 31) / 32 * 32, b};
}

// The rows of one 32-row group that share a tag slot commit one a round,
// in lane order, for up to ROUNDS rounds: each round every pending lane
// writes 32 to its slot, the lowest pending lane of the slot wins it
// (shared-memory atomicMin on an int, whose result does not depend on
// order), and the winners, whose slots and so keys differ, commit
// together.  A slot is key mod kTags, so two keys may share one and then
// merely wait for each other.  Returns whether this lane is still pending:
// the callers take the rest of a crowded group (a hot key) together, by
// `__match_any_sync`, which is slower a group but not a round a row.
// Called by one whole warp; `tag` is the warp's own kTags ints in shared
// memory.
template <int ROUNDS, typename F>
__device__ __forceinline__ bool lane_rounds(bool pending, int key, int* tag, F commit) {
  const int lane = threadIdx.x & 31;
  int* t = tag + (key & (kTags - 1));
  for (int round = 0; round < ROUNDS && __any_sync(kFull, pending); ++round) {
    if (pending) *t = 32;
    __syncwarp();
    if (pending) atomicMin(t, lane);
    __syncwarp();
    if (pending && *t == lane) {
      commit();
      pending = false;
    }
    __syncwarp();
  }
  return pending;
}

// The pending lanes' match groups (lanes of one key): the mask of my group
// (a lane that is not pending is a group of its own), its first lane, and
// my rank in it
struct Group {
  unsigned mask;
  int leader, rank;
};
__device__ __forceinline__ Group match_group(bool pending, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __match_any_sync(kFull, pending ? key : -2 - lane);
  return {m, __ffs(m) - 1, __popc(m & ((1u << lane) - 1))};
}

// The rest of each id's rows in a crowded group: combined over their match
// group by pointer jumping (a fixed tree), added by the group's first lane.
// Out of line, so that the common path keeps its registers.
template <typename T, int OP>
__device__ __noinline__ void add_crowded(bool pending, int id, T v, const T* row, int d,
                                         T* copy) {
  const int lane = threadIdx.x & 31;
  const Group g = match_group(pending, id);
  const unsigned later = g.mask & ~(0xffffffffu >> (31 - lane));
  const int next0 = later ? __ffs(later) - 1 : -1;
  const int most = __reduce_max_sync(kFull, __popc(g.mask));
  for (int j = 0; j < d; ++j) {
    T x = !pending ? identity<T, OP>() : j == 0 ? v : __ldcs(row + j);
    int nx = next0;
    for (int reach = 1; reach < most; reach <<= 1) {
      const T o = __shfl_sync(kFull, x, nx & 31);
      const int onx = __shfl_sync(kFull, nx, nx & 31);
      if (nx >= 0) {
        x = combine<T, OP>(x, o);
        nx = onx;
      }
    }
    if (pending && lane == g.leader) {
      T* c = copy + (long long)id * d + j;
      *c = combine<T, OP>(*c, x);
    }
  }
  __syncwarp();
}

// Reduce rows [begin, end) in order, 32 at a time, into `copy` ([span, d],
// cells of ids id_lo … id_lo + span - 1); row r's id is ids[r·istride], its
// values vals[r·vstride + j].  Rows of one id meet the copy in row order.  Called
// by one whole warp; `copy` is the warp's own (shared or device memory).
template <typename T, int OP, typename IdT, int U, int ROUNDS>
__device__ void reduce_rows(const IdT* __restrict__ ids, int istride,
                            const T* __restrict__ vals, long long vstride, int d,
                            long long begin, long long end, long long id_lo, int span,
                            T* copy, int* tag) {
  const int lane = threadIdx.x & 31;
  for (long long base = begin; base < end; base += 32 * U) {
    int rel[U];
    T v0[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + u * 32 + lane;
      rel[u] = -1;
      if (r < end) {
        const long long x = (long long)__ldcs(ids + r * istride) - id_lo;
        if (x >= 0 && x < span) rel[u] = (int)x;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + u * 32 + lane;
      if (rel[u] >= 0) v0[u] = __ldcs(vals + r * vstride);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * 32 >= end) break;                     // warp-uniform
      const long long r = base + u * 32 + lane;
      const int id = rel[u];
      const T v = v0[u];
      const bool pending = lane_rounds<ROUNDS>(id >= 0, id, tag, [=] {
        T* c = copy + (long long)id * d;
        c[0] = combine<T, OP>(c[0], v);
        for (int j = 1; j < d; ++j) c[j] = combine<T, OP>(c[j], __ldcs(vals + r * vstride + j));
      });
      if (__any_sync(kFull, pending))
        add_crowded<T, OP>(pending, id, v, vals + r * vstride, d, copy);
    }
  }
}

// Fill `cells` cells with the identity: the calling block's threads.
template <typename T, int OP>
__device__ __forceinline__ void fill(T* p, int cells) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) p[i] = identity<T, OP>();
}

// Merge the block's warps' copies ([warps][stride] in shared memory) in
// warp order into dst[0 … cells).
template <typename T, int OP>
__device__ __forceinline__ void merge_warps(const T* copies, int warps, int stride, int cells,
                                            T* dst) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    T acc = copies[i];
    for (int w = 1; w < warps; ++w) acc = combine<T, OP>(acc, copies[w * stride + i]);
    dst[i] = acc;
  }
}

// Each kernel below is a thin __global__ that finds its lane's pointers
// (`lanes`, and the scratch at `lane_bytes` a lane) and calls its body,
// whose pointer parameters are __restrict__ as a kernel's own would be.

// small path, pass 1: block g reduces warp ranges g·kWarps … into
// dst[g] ([K, D]; the output itself when there is one block)
template <typename T, int OP, typename IdT>
__device__ __forceinline__ void small_reduce_body(const IdT* __restrict__ ids,
                                                  const T* __restrict__ vals, long long n, int d,
                                                  long long vstride, int k, long long per,
                                                  Count count, T* __restrict__ dst) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tags[kWarps * kTags];
  const Rows r = rows_of(n, per, gridDim.x, count);
  if ((int)blockIdx.x >= r.blocks) return;            // block-uniform
  T* copies = reinterpret_cast<T*>(smem_raw);
  const int cells = k * d;
  fill<T, OP>(copies, kWarps * cells);
  __syncthreads();
  const int w = threadIdx.x >> 5;
  long long begin, end;
  warp_range(r.m, r.per, (long long)blockIdx.x * kWarps + w, &begin, &end);
  reduce_rows<T, OP, IdT, kUnroll, kSmallRounds>(ids, 1, vals, vstride, d, begin, end, 0, k,
                                                 copies + w * cells, tags + w * kTags);
  __syncthreads();
  merge_warps<T, OP>(copies, kWarps, cells, cells, dst + (long long)blockIdx.x * cells);
}

// part: the partials (null: the lane's output, when there is one block)
template <typename T, int OP, typename IdT>
__global__ void __launch_bounds__(kThreads)
small_reduce(const __grid_constant__ Lanes lanes, long long n, int d, long long vstride, int k,
             long long per, Count count, T* part, long long lane_bytes) {
  small_reduce_body<T, OP, IdT>(static_cast<const IdT*>(lanes.ids[blockIdx.y]),
                                static_cast<const T*>(lanes.vals[blockIdx.y]), n, d, vstride, k,
                                per, count,
                                part != nullptr ? at_lane(part, lane_bytes)
                                                : static_cast<T*>(lanes.out[blockIdx.y]));
}

// small path, pass 2: fold the partials [blocks, cells] in block order
// (the blocks pass 1 used: of n rows, or of the counted ones)
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fold_partials(const T* part, long long lane_bytes, long long n, long long per, int blocks,
              Count count, int cells, const __grid_constant__ Lanes lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  blocks = rows_of(n, per, blocks, count).blocks;
  part = at_lane(part, lane_bytes);
  T* out = static_cast<T*>(lanes.out[blockIdx.y]);
  T acc = part[i];
  for (int g = 1; g < blocks; ++g) acc = combine<T, OP>(acc, part[(long long)g * cells + i]);
  out[i] = acc;
}

// large path, pass 1a: kept rows per (bucket, warp range), written
// bucket-major: counts[b · ranges + wt]
template <typename IdT>
__device__ __forceinline__ void bucket_count_body(const IdT* __restrict__ ids, long long n, int k,
                                                  int shift, int nb, long long per, Count count,
                                                  int ranges, int* __restrict__ counts) {
  extern __shared__ int cnt[];                 // [kWarps][nb]
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // every block writes its counts: a range past the counted rows' counts 0
  const Rows r = rows_of(n, per, gridDim.x, count);
  long long begin, end;
  warp_range(r.m, r.per, (long long)blockIdx.x * kWarps + w, &begin, &end);
#pragma unroll 4
  for (long long r = begin + lane; r < end; r += 32) {
    const long long id = __ldcs(ids + r);
    if (id >= 0 && id < k) atomicAdd(&cnt[w * nb + (int)(id >> shift)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) {
    const int b = i / kWarps, ww = i % kWarps;
    counts[(long long)b * ranges + (long long)blockIdx.x * kWarps + ww] = cnt[ww * nb + b];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[(long long)nb * ranges] = 0;
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
bucket_count(const __grid_constant__ Lanes lanes, long long n, int k, int shift, int nb,
             long long per, Count count, int ranges, int* counts, long long lane_bytes) {
  bucket_count_body<IdT>(static_cast<const IdT*>(lanes.ids[blockIdx.y]), n, k, shift, nb, per,
                         count, ranges, at_lane(counts, lane_bytes));
}

// exclusive scan of counts[0 … len) in place, in three kernels: chunk
// sums, a scan of the sums by one block, each chunk scanned from its sum
// (each lane's: its counts and sums `lane_bytes` after the last lane's)
__global__ void __launch_bounds__(kThreads)
scan_sums(const int* counts, long long len, int* sums, long long lane_bytes) {
  counts = at_lane(counts, lane_bytes);
  sums = at_lane(sums, lane_bytes);
  const long long lo = (long long)blockIdx.x * kScanChunk;
  int s = 0;
  for (long long i = lo + threadIdx.x; i < min(len, lo + kScanChunk); i += blockDim.x)
    s += counts[i];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  __shared__ int part[kWarps];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += part[w];
    sums[blockIdx.x] = t;
  }
}

// block-wide exclusive scan of one int a thread; returns the thread's
// prefix and sets *total
__device__ __forceinline__ int block_exclusive(int v, int* total) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < kWarps; ++i) {
    before += i < w ? warp_tot[i] : 0;
    all += warp_tot[i];
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

__global__ void __launch_bounds__(kThreads)
scan_chunk_sums(int* sums, int chunks, long long lane_bytes) {
  sums = at_lane(sums, lane_bytes);
  int carry = 0;
  for (int lo = 0; lo < chunks; lo += kThreads) {
    const int i = lo + threadIdx.x;
    const int v = i < chunks ? sums[i] : 0;
    int total;
    const int ex = block_exclusive(v, &total);
    if (i < chunks) sums[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_chunks(int* counts, long long len, const int* sums, long long lane_bytes) {
  counts = at_lane(counts, lane_bytes);
  sums = at_lane(sums, lane_bytes);
  constexpr int kPer = kScanChunk / kThreads;
  const long long lo = (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kPer;
  int v[kPer];
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = lo + j < len ? counts[lo + j] : 0;
    s += v[j];
  }
  int total;
  int run = sums[blockIdx.x] + block_exclusive(s, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (lo + j < len) counts[lo + j] = run;
    run += v[j];
  }
}

// large path, pass 1b: every kept row's id and (unless the value is one
// broadcast row) values to its place, stable in row order
// With ROWS (the wide route) each kept row's record is (id, row index), an
// int2 at sid[2·place], and no value is read.
template <typename T, typename IdT, bool ROWS>
__device__ __forceinline__ void bucket_scatter_body(const IdT* __restrict__ ids,
                                                    const T* __restrict__ vals, long long n, int d,
                                                    long long vstride, int k, int shift, int nb,
                                                    long long per, Count count, int ranges,
                                                    const int* __restrict__ offs,
                                                    int* __restrict__ sid,
                                                    T* __restrict__ sval) {
  extern __shared__ int cur[];                 // [kWarps][nb]: next free place
  __shared__ int tags[kWarps * kTags];
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) {
    const int b = i / kWarps, ww = i % kWarps;
    cur[ww * nb + b] = offs[(long long)b * ranges + (long long)blockIdx.x * kWarps + ww];
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rows rw = rows_of(n, per, gridDim.x, count);
  long long begin, end;
  warp_range(rw.m, rw.per, (long long)blockIdx.x * kWarps + w, &begin, &end);
  for (long long base = begin; base < end; base += 32 * kUnroll) {
    long long id[kUnroll];
    T v0[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * 32 + lane;
      id[u] = r < end ? (long long)__ldcs(ids + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * 32 + lane;
      if (vstride != 0 && id[u] >= 0 && id[u] < k) v0[u] = __ldcs(vals + r * vstride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * 32 >= end) break;                     // warp-uniform
      const long long r = base + u * 32 + lane;
      const int bucket = id[u] >= 0 && id[u] < k ? (int)(id[u] >> shift) : -1;
      int place = 0;
      int* const at = cur + w * nb + bucket;
      // places taken in lane order: the scatter is stable
      const bool pending =
          lane_rounds<kLargeRounds>(bucket >= 0, bucket, tags + w * kTags,
                                    [&place, at] { place = (*at)++; });
      if (__any_sync(kFull, pending)) {
        const Group g = match_group(pending, bucket);
        int base = 0;
        if (pending && lane == g.leader) {
          base = *at;
          *at = base + __popc(g.mask);
        }
        base = __shfl_sync(kFull, base, g.leader);
        if (pending) place = base + g.rank;
        __syncwarp();
      }
      if (bucket >= 0 && ROWS) {
        reinterpret_cast<int2*>(sid)[place] = make_int2((int)id[u], (int)r);
      } else if (bucket >= 0) {
        sid[place] = (int)id[u];
        if (vstride != 0) {
          sval[(long long)place * d] = v0[u];
          for (int j = 1; j < d; ++j)
            sval[(long long)place * d + j] = __ldcs(vals + r * vstride + j);
        }
      }
    }
  }
}

template <typename T, typename IdT, bool ROWS = false>
__global__ void __launch_bounds__(kThreads)
bucket_scatter(const __grid_constant__ Lanes lanes, long long n, int d, long long vstride, int k,
               int shift, int nb, long long per, Count count, int ranges, const int* offs,
               int* sid, T* sval, long long lane_bytes) {
  bucket_scatter_body<T, IdT, ROWS>(
      static_cast<const IdT*>(lanes.ids[blockIdx.y]),
      static_cast<const T*>(lanes.vals[blockIdx.y]), n, d, vstride, k, shift, nb, per, count,
      ranges, at_lane(offs, lane_bytes), at_lane(sid, lane_bytes), at_lane(sval, lane_bytes));
}

template <typename T> __device__ __forceinline__ unsigned bits(T v);
template <> __device__ __forceinline__ unsigned bits<float>(float v) { return __float_as_uint(v); }
template <> __device__ __forceinline__ unsigned bits<int>(int v) { return (unsigned)v; }

// large path, pass 1b for rows of one word of value (or none, broadcast):
// the same places as bucket_scatter, but written a 32-byte sector at a
// time.  Records are W words (id, then the value's bits when W = 2), R = 8
// / W to a sector.  Each warp stages the open sector of each bucket in
// shared memory and stores it whole once its last record has its place;
// a bucket's first and last sectors, which it shares with its neighbours,
// are stored record by record.  Scattered single-record stores leave
// partial sectors to the L2 and cost a device-memory read-modify-write
// each; whole sectors do not.  With ROWS (the wide route, W = 2) a
// record's second word is the row's index, and no value is read.
template <typename T, typename IdT, int W, bool ROWS>
__device__ __forceinline__ void bucket_scatter_staged_body(const IdT* __restrict__ ids,
                                                           const T* __restrict__ vals, long long n,
                                                           int k, int shift, int nb, long long per,
                                                           Count count, int ranges,
                                                           const int* __restrict__ offs,
                                                           unsigned* __restrict__ rec) {
  constexpr int R = 8 / W;
  extern __shared__ int smem_int[];
  int* cur = smem_int;                         // [kWarps][nb]: next free place
  int* first = cur + kWarps * nb;              // [kWarps][nb]: the warp's first place
  unsigned* stage = reinterpret_cast<unsigned*>(first + kWarps * nb);  // [kWarps][nb][8]
  __shared__ int tags[kWarps * kTags];
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) {
    const int b = i / kWarps, ww = i % kWarps;
    const int at = offs[(long long)b * ranges + (long long)blockIdx.x * kWarps + ww];
    cur[ww * nb + b] = first[ww * nb + b] = at;
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rows rw = rows_of(n, per, gridDim.x, count);
  long long begin, end;
  warp_range(rw.m, rw.per, (long long)blockIdx.x * kWarps + w, &begin, &end);
  for (long long base = begin; base < end; base += 32 * kUnroll) {
    long long id[kUnroll];
    T v0[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * 32 + lane;
      id[u] = r < end ? (long long)__ldcs(ids + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * 32 + lane;
      if (W == 2 && !ROWS && id[u] >= 0 && id[u] < k) v0[u] = __ldcs(vals + r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * 32 >= end) break;                     // warp-uniform
      const int bucket = id[u] >= 0 && id[u] < k ? (int)(id[u] >> shift) : -1;
      const unsigned idw = (unsigned)id[u];
      const unsigned vw = W == 2 && bucket >= 0
                              ? (ROWS ? (unsigned)(base + u * 32 + lane) : bits<T>(v0[u]))
                              : 0u;
      // places taken in lane order, one a bucket a round: the scatter is
      // stable, and the lane that fills a sector stores it
      const bool pending = lane_rounds<kLargeRounds>(bucket >= 0, bucket, tags + w * kTags, [=] {
        const int slot = w * nb + bucket;
        const int p = cur[slot]++;
        unsigned* st = stage + slot * 8;
        st[(p % R) * W] = idw;
        if (W == 2) st[(p % R) * W + 1] = vw;
        if (p % R == R - 1) {
          const int lo = p - (R - 1);
          if (lo >= first[slot]) {
            uint4* dst = reinterpret_cast<uint4*>(rec + (long long)lo * W);
            dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
            dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
          } else {
            for (int q = first[slot] - lo; q < R; ++q)
              for (int x = 0; x < W; ++x) rec[(long long)(lo + q) * W + x] = st[q * W + x];
          }
        }
      });
      if (__any_sync(kFull, pending)) {
        // the rest of a crowded bucket: its open sector's staged records
        // go out one by one, then the group's records straight to their
        // places, contiguous; every place below the new cursor is then in
        // device memory (`first` moves up to it)
        const Group g = match_group(pending, bucket);
        int base = 0;
        if (pending && lane == g.leader) {
          const int slot = w * nb + bucket;
          base = cur[slot];
          const int lo = base - base % R;
          const unsigned* st = stage + slot * 8;
          for (int q = max(first[slot] - lo, 0); q < base - lo; ++q)
            for (int x = 0; x < W; ++x) rec[(long long)(lo + q) * W + x] = st[q * W + x];
          cur[slot] = first[slot] = base + __popc(g.mask);
        }
        base = __shfl_sync(kFull, base, g.leader);
        if (pending) {
          rec[(long long)(base + g.rank) * W] = idw;
          if (W == 2) rec[(long long)(base + g.rank) * W + 1] = vw;
        }
        __syncwarp();
      }
    }
  }
  __syncwarp();
  // the open sector of every bucket: its records one by one
  for (int b = lane; b < nb; b += 32) {
    const int slot = w * nb + b, p = cur[slot];
    const int lo = p - p % R;
    const unsigned* st = stage + slot * 8;
    for (int q = max(first[slot] - lo, 0); q < p - lo; ++q)
      for (int x = 0; x < W; ++x) rec[(long long)(lo + q) * W + x] = st[q * W + x];
  }
}

template <typename T, typename IdT, int W, bool ROWS = false>
__global__ void __launch_bounds__(kThreads)
bucket_scatter_staged(const __grid_constant__ Lanes lanes, long long n, int k, int shift, int nb,
                      long long per, Count count, int ranges, const int* offs, unsigned* rec,
                      long long lane_bytes) {
  bucket_scatter_staged_body<T, IdT, W, ROWS>(
      static_cast<const IdT*>(lanes.ids[blockIdx.y]),
      static_cast<const T*>(lanes.vals[blockIdx.y]), n, k, shift, nb, per, count, ranges,
      at_lane(offs, lane_bytes), at_lane(rec, lane_bytes));
}

// large path, pass 2: block b reduces bucket b's rows (ids[r·istride],
// values rows[r·rstride + j]; null rows: the lane's broadcast value row)
// and writes its slice of the lane's output.  With
// `in_smem` each of its warps (8, or 4 for a slice above kSmallCells
// cells, each then with twice the rows in flight) keeps a copy of the
// slice in shared memory and takes a fixed share of the rows; the copies
// are merged in warp order.  Otherwise (a slice too large for it) one warp
// reduces straight into the output slice, which only this block writes.
template <typename T, int OP>
__device__ __forceinline__ void bucket_reduce_body(const int* __restrict__ ids, int istride,
                                                   const T* __restrict__ rows, long long rstride,
                                                   int d, int k, int shift, int ranges,
                                                   const int* __restrict__ offs, bool in_smem,
                                                   T* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tags[kWarps * kTags];
  const int b = blockIdx.x;
  const long long lo = offs[(long long)b * ranges], hi = offs[(long long)(b + 1) * ranges];
  const long long id_lo = (long long)b << shift;
  const int span = (int)min((long long)1 << shift, (long long)k - id_lo);
  const int cells = span * d;
  T* slice = out + id_lo * d;
  if (!in_smem) {
    fill<T, OP>(slice, cells);
    __syncwarp();
    reduce_rows<T, OP, int, kUnroll, kLargeRounds>(ids, istride, rows, rstride, d, lo, hi, id_lo,
                                                   span, slice, tags);
    return;
  }
  T* copies = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x >> 5;
  const int stride = (1 << shift) * d;
  fill<T, OP>(copies, warps * stride);
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const long long per = (hi - lo + warps - 1) / warps;
  const long long wb = min(hi, lo + w * per), we = min(hi, wb + per);
  if (warps == kWarps)
    reduce_rows<T, OP, int, kUnroll, kLargeRounds>(ids, istride, rows, rstride, d, wb, we, id_lo,
                                                   span, copies + w * stride, tags + w * kTags);
  else
    reduce_rows<T, OP, int, 2 * kUnroll, kLargeRounds>(ids, istride, rows, rstride, d, wb, we,
                                                       id_lo, span, copies + w * stride,
                                                       tags + w * kTags);
  __syncthreads();
  merge_warps<T, OP>(copies, warps, stride, cells, slice);
}

// One lane's (a solo launch, or a lanes launch of one lane): the lane's
// pointers as parameters, which stay in the parameter bank and take no
// registers
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
bucket_reduce_one(const int* __restrict__ ids, int istride, const T* __restrict__ rows,
                  long long rstride, int d, int k, int shift, int ranges,
                  const int* __restrict__ offs, bool in_smem, T* __restrict__ out) {
  bucket_reduce_body<T, OP>(ids, istride, rows, rstride, d, k, shift, ranges, offs, in_smem, out);
}

// MIN_BLOCKS: the blocks an SM must hold at once (its registers' bound)
template <typename T, int OP, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
bucket_reduce(const int* ids, int istride, const T* rows, long long rstride, int d, int k,
              int shift, int ranges, const int* offs, bool in_smem,
              const __grid_constant__ Lanes lanes, long long lane_bytes) {
  bucket_reduce_body<T, OP>(at_lane(ids, lane_bytes), istride,
                            rows != nullptr ? at_lane(rows, lane_bytes)
                                            : static_cast<const T*>(lanes.vals[blockIdx.y]),
                            rstride, d, k, shift, ranges, at_lane(offs, lane_bytes), in_smem,
                            static_cast<T*>(lanes.out[blockIdx.y]));
}

// ---------------------------------------------------------------------------
// The wide route: rows of d ≥ 64 values (the MoE combine: 16,384 bf16 rows
// of 2,048 into 2,048 tokens).  The count, the scans and the scatter above
// order the kept rows by bucket, stable, but the scatter moves records of
// (id, row index), 8 bytes a row, and no value.  wide_reduce then owns a
// (bucket, column tile) cell of the grid, as the TPU kernel tiles the row
// width in its grid: it walks the bucket's records in their stable order
// and reads each row's columns of the tile straight from the input, one
// 16-byte load a thread, widening bf16 in registers.  Each thread owns its
// VEC columns of the bucket's ids for the whole walk, so every output cell
// is ⊕-ed by one thread in row order, with no atomic and no barrier, and
// written once (MODE kRegs, kShared).  The accumulators live in registers
// when a bucket holds one id, else in shared memory ([span][VEC][threads],
// conflict-free), else (a slice too large for it) in the output slice
// itself, which only this block writes.
// ---------------------------------------------------------------------------

// bf16 values are read as their 16 bits and widened exactly by a shift
using bf16_bits = unsigned short;

// a value type in device memory: its accumulator and the values one
// 16-byte load holds
template <typename V> struct Wide;
template <> struct Wide<float> { using T = float; static constexpr int kVec = 4; };
template <> struct Wide<int> { using T = int; static constexpr int kVec = 4; };
template <> struct Wide<bf16_bits> { using T = float; static constexpr int kVec = 8; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ int widen(int v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) { return __uint_as_float((unsigned)v << 16); }

// kVec values from 16-byte aligned memory, read once
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const int* p, int (&v)[4]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const bf16_bits* p, float (&v)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// four accumulators to 16-byte aligned memory
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}
__device__ __forceinline__ void store4(int* p, int a, int b, int c, int e) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, e);
}

enum WideMode { kRegs = 0, kShared = 1, kGlobal = 2 };
constexpr int kWideRows = 8;              // records (rows) a thread loads ahead
constexpr int kWideSlice = 64 * 1024;     // shared bytes of a block's accumulators at most
constexpr int kWideMaxBuckets = 4096;     // buckets at most (pass 1's counters)

// Block (bucket b, column tile y) of the wide route: rows rec[offs[b·ranges]
// … offs[(b+1)·ranges]), each (id, row), their values vals[row·vstride + c]
// for the tile's columns c; writes out[id, c] for the bucket's ids.  `vec`:
// the rows' columns may be read 16 bytes at a time.
template <typename V, int OP, int MODE>
__global__ void wide_reduce(const int2* __restrict__ rec, const V* __restrict__ vals,
                            long long vstride, int d, int k, int shift, int ranges,
                            const int* __restrict__ offs, int vec,
                            typename Wide<V>::T* __restrict__ out) {
  using T = typename Wide<V>::T;
  constexpr int VEC = Wide<V>::kVec;
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= d) return;                    // no barrier follows: threads work alone
  const long long lo = offs[(long long)b * ranges], hi = offs[(long long)(b + 1) * ranges];
  const long long id_lo = (long long)b << shift;
  const int span = (int)min((long long)1 << shift, (long long)k - id_lo);
  const int nc = min(VEC, d - c0);
  const bool whole = vec && nc == VEC;
  // my cell (s, j): cells[s·sstride + j·jstride]
  T* cells = nullptr;
  long long sstride = 0, jstride = 0;
  if (MODE == kShared) {
    cells = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
    jstride = blockDim.x;
    sstride = (long long)VEC * blockDim.x;
  } else if (MODE == kGlobal) {
    cells = out + id_lo * d + c0;
    jstride = 1;
    sstride = d;
  }
  T acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = identity<T, OP>();
  if (MODE != kRegs)
    for (int s = 0; s < span; ++s)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (j < nc) cells[s * sstride + j * jstride] = identity<T, OP>();
  const V* col = vals + c0;
  for (long long p = lo; p < hi; p += kWideRows) {
    const int m = (int)min((long long)kWideRows, hi - p);
    int2 r[kWideRows];
    T v[kWideRows][VEC];
#pragma unroll
    for (int u = 0; u < kWideRows; ++u)
      if (u < m) r[u] = rec[p + u];
#pragma unroll
    for (int u = 0; u < kWideRows; ++u) {
      if (u >= m) break;
      const V* src = col + (long long)r[u].y * vstride;
      if (whole) {
        load_vec(src, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u][j] = j < nc ? widen(__ldcs(src + j)) : identity<T, OP>();
      }
    }
#pragma unroll
    for (int u = 0; u < kWideRows; ++u) {
      if (u >= m) break;
      if (MODE == kRegs) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = combine<T, OP>(acc[j], v[u][j]);
      } else {
        T* c = cells + (long long)(r[u].x - id_lo) * sstride;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (j < nc) c[j * jstride] = combine<T, OP>(c[j * jstride], v[u][j]);
      }
    }
  }
  if (MODE == kGlobal) return;            // the cells are the output
  for (int s = 0; s < span; ++s) {
    if (MODE == kShared) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = cells[s * sstride + j * jstride];
    }
    T* dst = out + (id_lo + s) * d + c0;
    if (whole && d % 4 == 0) {             // dst is 16-byte aligned
#pragma unroll
      for (int q = 0; q < VEC; q += 4) store4(dst + q, acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (j < nc) dst[j] = acc[j];
    }
  }
}

long long align256(long long bytes) { return (bytes + 255) / 256 * 256; }

// every kernel here also holds kWarps·kTags ints of static shared memory,
// so the opt-in above 48 KB is asked for whatever the dynamic size
int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// One launch of lanes 0 … nl - 1 of `ln` (a solo launch: one lane): the
// plan is one lane's, and lane b's scratch is the `scratch_bytes` at
// scratch + b·lane_bytes
template <typename T, int OP, typename IdT>
int launch(const Lanes& ln, int nl, long long n, int d, long long vstride, int k,
           unsigned char* scratch, long long scratch_bytes, long long lane_bytes, int blocks,
           int shift, Count count, cudaStream_t s) {
  const long long cells = (long long)k * d;
  if (cells == 0) return 0;
  const long long ranges = (long long)blocks * kWarps;
  const long long per = ((n + ranges - 1) / ranges + 31) / 32 * 32;
  if (shift < 0) {                                       // small path
    if (cells > kSmallCells) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kWarps * cells * sizeof(T);
    T* part = blocks == 1 ? nullptr : reinterpret_cast<T*>(scratch);
    if (blocks > 1 && scratch_bytes < (long long)blocks * cells * (long long)sizeof(T))
      return (int)cudaErrorInvalidValue;
    int err = set_smem((const void*)small_reduce<T, OP, IdT>, smem);
    if (err) return err;
    small_reduce<T, OP, IdT><<<dim3(blocks, nl), kThreads, smem, s>>>(ln, n, d, vstride, k, per,
                                                                      count, part, lane_bytes);
    if (blocks > 1)
      fold_partials<T, OP><<<dim3((int)((cells + kThreads - 1) / kThreads), nl), kThreads, 0,
                             s>>>(part, lane_bytes, n, per, blocks, count, (int)cells, ln);
    return 0;
  }
  // large path: the scratch holds counts [nb·ranges + 1], chunk sums, the
  // kept rows' ids [n] and, unless broadcast, their values [n, d] (for d =
  // 1 the two interleaved, a record of 8 bytes a row)
  const long long nb = (k + (1LL << shift) - 1) >> shift;
  const long long len = nb * ranges + 1;
  const long long chunks = (len + kScanChunk - 1) / kScanChunk;
  int* counts = reinterpret_cast<int*>(scratch);
  int* sums = reinterpret_cast<int*>(scratch + align256(4 * len));
  int* sid = reinterpret_cast<int*>(scratch + align256(4 * len) + align256(4 * chunks));
  T* sval = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sid) + align256(4 * n));
  const long long need = align256(4 * len) + align256(4 * chunks) + align256(4 * n) +
                         (vstride != 0 ? (long long)sizeof(T) * n * d : 0);
  const long long slice = (1LL << shift) * d;
  const bool in_smem = slice <= kSliceCells;
  const int warps2 = slice <= kSmallCells ? kWarps : kWarps / 2;
  const bool staged = (d == 1 || vstride == 0) && nb <= kStageBuckets;
  if (scratch_bytes < need || n >= (1LL << 31) || len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem1 = (size_t)kWarps * nb * sizeof(int);
  const size_t smem_staged = (size_t)kWarps * nb * (2 * sizeof(int) + 32);
  const size_t smem2 = in_smem ? (size_t)warps2 * slice * sizeof(T) : 0;
  int err = set_smem((const void*)bucket_count<IdT>, smem1);
  if (!err && staged && vstride == 0)
    err = set_smem((const void*)bucket_scatter_staged<T, IdT, 1>, smem_staged);
  if (!err && staged && vstride != 0)
    err = set_smem((const void*)bucket_scatter_staged<T, IdT, 2>, smem_staged);
  if (!err && !staged) err = set_smem((const void*)bucket_scatter<T, IdT>, smem1);
  // The reduce of one lane takes its pointers as parameters (64 registers
  // a thread, a few spilled), but for a slice above kSmallCells cells: its
  // 4-warp blocks are one an SM by shared memory, and the lanes kernel's
  // 91-100 registers, spilling nothing, serve them faster (pagerank's
  // reduce, PERF.md).  With more lanes the lane's pointers take registers:
  // an 8-warp block of a slice of at most kSmallCells / 2 cells then keeps
  // four blocks an SM by its bounds (64 registers), as one lane's does,
  // since shared memory holds four; a larger slice holds fewer.
  const bool one = nl == 1 && !(in_smem && warps2 < kWarps);
  const bool four = in_smem && slice <= kSmallCells / 2;
  const int threads2 = in_smem ? warps2 * 32 : 32;
  const void* reduce_fn = one  ? (const void*)bucket_reduce_one<T, OP>
                          : four ? (const void*)bucket_reduce<T, OP, 4>
                                 : (const void*)bucket_reduce<T, OP, 1>;
  if (!err) err = set_smem(reduce_fn, smem2);
  if (err) return err;
  auto reduce = [&](int istride, const T* rows, long long rstride) {
    if (one)
      bucket_reduce_one<T, OP><<<(int)nb, threads2, smem2, s>>>(
          sid, istride, rows != nullptr ? rows : static_cast<const T*>(ln.vals[0]), rstride, d,
          k, shift, (int)ranges, counts, in_smem, static_cast<T*>(ln.out[0]));
    else if (four)
      bucket_reduce<T, OP, 4><<<dim3((int)nb, nl), threads2, smem2, s>>>(
          sid, istride, rows, rstride, d, k, shift, (int)ranges, counts, in_smem, ln, lane_bytes);
    else
      bucket_reduce<T, OP, 1><<<dim3((int)nb, nl), threads2, smem2, s>>>(
          sid, istride, rows, rstride, d, k, shift, (int)ranges, counts, in_smem, ln, lane_bytes);
  };
  const dim3 rows_grid(blocks, nl), scan_grid((int)chunks, nl);
  bucket_count<IdT><<<rows_grid, kThreads, smem1, s>>>(ln, n, k, shift, (int)nb, per, count,
                                                       (int)ranges, counts, lane_bytes);
  scan_sums<<<scan_grid, kThreads, 0, s>>>(counts, len, sums, lane_bytes);
  scan_chunk_sums<<<dim3(1, nl), kThreads, 0, s>>>(sums, (int)chunks, lane_bytes);
  scan_chunks<<<scan_grid, kThreads, 0, s>>>(counts, len, sums, lane_bytes);
  unsigned* rec = reinterpret_cast<unsigned*>(sid);
  if (staged && vstride == 0) {
    bucket_scatter_staged<T, IdT, 1><<<rows_grid, kThreads, smem_staged, s>>>(
        ln, n, k, shift, (int)nb, per, count, (int)ranges, counts, rec, lane_bytes);
    reduce(1, nullptr, 0);
  } else if (staged) {
    bucket_scatter_staged<T, IdT, 2><<<rows_grid, kThreads, smem_staged, s>>>(
        ln, n, k, shift, (int)nb, per, count, (int)ranges, counts, rec, lane_bytes);
    reduce(2, reinterpret_cast<const T*>(rec + 1), 2);
  } else {
    bucket_scatter<T, IdT><<<rows_grid, kThreads, smem1, s>>>(ln, n, d, vstride, k, shift,
                                                              (int)nb, per, count, (int)ranges,
                                                              counts, sid, sval, lane_bytes);
    reduce(1, vstride != 0 ? sval : nullptr, vstride != 0 ? d : 0);
  }
  return 0;
}

template <typename T, typename IdT>
int launch_op(int op, const Lanes& ln, int nl, long long n, int d, long long vstride, int k,
              unsigned char* scratch, long long scratch_bytes, long long lane_bytes, int blocks,
              int shift, Count count, cudaStream_t s) {
  if (op == kSum)
    return launch<T, kSum, IdT>(ln, nl, n, d, vstride, k, scratch, scratch_bytes, lane_bytes,
                                blocks, shift, count, s);
  if (op == kMin)
    return launch<T, kMin, IdT>(ln, nl, n, d, vstride, k, scratch, scratch_bytes, lane_bytes,
                                blocks, shift, count, s);
  return launch<T, kMax, IdT>(ln, nl, n, d, vstride, k, scratch, scratch_bytes, lane_bytes, blocks,
                              shift, count, s);
}

// The small and bucketed paths of lanes 0 … nl - 1 of `ln`: dtype 0 =
// float32, 1 = int32; int64 ids when id64, else int32
int launch_any(int dtype, int op, const Lanes& ln, int nl, long long n, int d, long long vstride,
               int k, void* stream, int id64, void* scratch, long long scratch_bytes,
               long long lane_bytes, int blocks, int shift, Count count) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (op < 0 || op > 2 || d < 1 || k < 0 || n < 0 || blocks < 1 || shift > 30 ||
      (dtype != 0 && dtype != 1) || nl < 1 || nl > kMaxLanes || lane_bytes < 0 ||
      lane_bytes % 256 != 0 || (nl > 1 && lane_bytes < scratch_bytes))
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  int err;
  if (dtype == 0)
    err = id64 ? launch_op<float, long long>(op, ln, nl, n, d, vstride, k, sc, scratch_bytes,
                                             lane_bytes, blocks, shift, count, s)
               : launch_op<float, int>(op, ln, nl, n, d, vstride, k, sc, scratch_bytes, lane_bytes,
                                       blocks, shift, count, s);
  else
    err = id64 ? launch_op<int, long long>(op, ln, nl, n, d, vstride, k, sc, scratch_bytes,
                                           lane_bytes, blocks, shift, count, s)
               : launch_op<int, int>(op, ln, nl, n, d, vstride, k, sc, scratch_bytes, lane_bytes,
                                     blocks, shift, count, s);
  return err ? err : (int)cudaGetLastError();
}

// one lane's pointers: a solo launch
Lanes solo(const void* ids, const void* vals, void* out) {
  Lanes ln{};
  ln.ids[0] = ids;
  ln.vals[0] = vals;
  ln.out[0] = out;
  return ln;
}

// The wide route: count, scan, scatter of (id, row) records, then the
// (bucket, column tile) reduce with `threads` threads a block.
template <typename V, int OP, typename IdT>
int launch_wide(const IdT* ids, const V* vals, typename Wide<V>::T* out, long long n, int d,
                long long vstride, int k, unsigned char* scratch, long long scratch_bytes,
                int blocks, int shift, int threads, Count count, cudaStream_t s) {
  using T = typename Wide<V>::T;
  constexpr int VEC = Wide<V>::kVec;
  if ((long long)k * d == 0) return 0;
  const long long ranges = (long long)blocks * kWarps;
  const long long per = ((n + ranges - 1) / ranges + 31) / 32 * 32;
  const long long nb = (k + (1LL << shift) - 1) >> shift;
  const long long len = nb * ranges + 1;
  const long long chunks = (len + kScanChunk - 1) / kScanChunk;
  const long long tile = (long long)threads * VEC;
  const long long tiles = (d + tile - 1) / tile;
  int* counts = reinterpret_cast<int*>(scratch);
  int* sums = reinterpret_cast<int*>(scratch + align256(4 * len));
  int2* rec = reinterpret_cast<int2*>(scratch + align256(4 * len) + align256(4 * chunks));
  const long long need = align256(4 * len) + align256(4 * chunks) + 8 * n;
  if (scratch_bytes < need || n >= (1LL << 31) || len >= (1LL << 31) || nb > kWideMaxBuckets ||
      threads < 32 || threads > kThreads || (threads & (threads - 1)) != 0 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const bool staged = nb <= kStageBuckets;
  const size_t smem1 = (size_t)kWarps * nb * sizeof(int);
  const size_t smem_staged = (size_t)kWarps * nb * (2 * sizeof(int) + 32);
  const long long span = k < (1LL << shift) ? k : 1LL << shift;   // a bucket's ids at most
  const long long slice = span * tile * (long long)sizeof(T);
  const int mode = span == 1 ? kRegs : slice <= kWideSlice ? kShared : kGlobal;
  const size_t smem2 = mode == kShared ? (size_t)slice : 0;
  const void* reduce = mode == kRegs     ? (const void*)wide_reduce<V, OP, kRegs>
                       : mode == kShared ? (const void*)wide_reduce<V, OP, kShared>
                                         : (const void*)wide_reduce<V, OP, kGlobal>;
  int err = set_smem((const void*)bucket_count<IdT>, smem1);
  if (!err && staged)
    err = set_smem((const void*)bucket_scatter_staged<float, IdT, 2, true>, smem_staged);
  if (!err && !staged) err = set_smem((const void*)bucket_scatter<float, IdT, true>, smem1);
  if (!err) err = set_smem(reduce, smem2);
  if (err) return err;
  const Lanes ln = solo(ids, nullptr, nullptr);
  bucket_count<IdT><<<blocks, kThreads, smem1, s>>>(ln, n, k, shift, (int)nb, per, count,
                                                    (int)ranges, counts, 0);
  scan_sums<<<(int)chunks, kThreads, 0, s>>>(counts, len, sums, 0);
  scan_chunk_sums<<<1, kThreads, 0, s>>>(sums, (int)chunks, 0);
  scan_chunks<<<(int)chunks, kThreads, 0, s>>>(counts, len, sums, 0);
  if (staged)
    bucket_scatter_staged<float, IdT, 2, true><<<blocks, kThreads, smem_staged, s>>>(
        ln, n, k, shift, (int)nb, per, count, (int)ranges, counts,
        reinterpret_cast<unsigned*>(rec), 0);
  else
    bucket_scatter<float, IdT, true><<<blocks, kThreads, smem1, s>>>(
        ln, n, 1, 0, k, shift, (int)nb, per, count, (int)ranges, counts,
        reinterpret_cast<int*>(rec), nullptr, 0);
  const int vec = reinterpret_cast<unsigned long long>(vals) % 16 == 0 &&
                  (vstride * (long long)sizeof(V)) % 16 == 0;
  const dim3 grid((unsigned)nb, (unsigned)tiles);
  if (mode == kRegs)
    wide_reduce<V, OP, kRegs><<<grid, threads, 0, s>>>(rec, vals, vstride, d, k, shift,
                                                       (int)ranges, counts, vec, out);
  else if (mode == kShared)
    wide_reduce<V, OP, kShared><<<grid, threads, smem2, s>>>(rec, vals, vstride, d, k, shift,
                                                             (int)ranges, counts, vec, out);
  else
    wide_reduce<V, OP, kGlobal><<<grid, threads, 0, s>>>(rec, vals, vstride, d, k, shift,
                                                         (int)ranges, counts, vec, out);
  return 0;
}

template <typename V, typename IdT>
int wide_op(int op, const IdT* ids, const void* vals, void* out, long long n, int d,
            long long vstride, int k, unsigned char* scratch, long long scratch_bytes, int blocks,
            int shift, int threads, Count count, cudaStream_t s) {
  using T = typename Wide<V>::T;
  const V* v = static_cast<const V*>(vals);
  T* o = static_cast<T*>(out);
  if (op == kSum)
    return launch_wide<V, kSum, IdT>(ids, v, o, n, d, vstride, k, scratch, scratch_bytes, blocks,
                                     shift, threads, count, s);
  if (op == kMin)
    return launch_wide<V, kMin, IdT>(ids, v, o, n, d, vstride, k, scratch, scratch_bytes, blocks,
                                     shift, threads, count, s);
  return launch_wide<V, kMax, IdT>(ids, v, o, n, d, vstride, k, scratch, scratch_bytes, blocks,
                                   shift, threads, count, s);
}

template <typename IdT>
int wide_dtype(int dtype, int op, const IdT* ids, const void* vals, void* out, long long n,
               int d, long long vstride, int k, unsigned char* scratch, long long scratch_bytes,
               int blocks, int shift, int threads, Count count, cudaStream_t s) {
  if (dtype == 0)
    return wide_op<float, IdT>(op, ids, vals, out, n, d, vstride, k, scratch, scratch_bytes,
                               blocks, shift, threads, count, s);
  if (dtype == 1)
    return wide_op<int, IdT>(op, ids, vals, out, n, d, vstride, k, scratch, scratch_bytes,
                             blocks, shift, threads, count, s);
  return wide_op<bf16_bits, IdT>(op, ids, vals, out, n, d, vstride, k, scratch, scratch_bytes,
                                 blocks, shift, threads, count, s);
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  op: 0 = +, 1 = min, 2 = max.  ids [n],
// int64 when id64 else int32; vals rows of d elements, `vstride` elements
// apart (0: one broadcast row); out [k, d], every cell written (identity
// where no row lands).  The plan comes from the caller: `blocks` blocks of
// warp ranges, and shift < 0 for the small path or the bucket size 2^shift
// of the large path; `scratch` is device memory of `scratch_bytes` (the
// small path's partials, the large path's counts and scattered rows).
// Returns the first CUDA error of the launches.
extern "C" int segment_reduce_launch(int dtype, int op, const void* ids, const void* vals,
                                     void* out, long long n, int d, long long vstride, int k,
                                     void* stream, int id64, void* scratch,
                                     long long scratch_bytes, int blocks, int shift) {
  return launch_any(dtype, op, solo(ids, vals, out), 1, n, d, vstride, k, stream, id64, scratch,
                    scratch_bytes, 0, blocks, shift, Count{nullptr, 0, 0, 0});
}

// The device-count entry: the same launch over ids and values of n rows,
// of which it reduces the first `*n_rows - base` (clamped to [0, n]), an
// int32 in device memory that the launch reads on the device.  The plan
// (blocks, shift, scratch) is the host's for n rows; `cap` and `rpb` are
// its block cap and rows a block, from which the device derives the
// counted rows' blocks.  The result has the bits of a launch over the
// counted rows alone.
extern "C" int segment_reduce_launch_rows(int dtype, int op, const void* ids, const void* vals,
                                          void* out, long long n, int d, long long vstride,
                                          int k, void* stream, int id64, void* scratch,
                                          long long scratch_bytes, int blocks, int shift,
                                          const void* n_rows, long long base, int cap,
                                          int rpb) {
  if (n_rows == nullptr || cap < 1 || rpb < 1) return (int)cudaErrorInvalidValue;
  return launch_any(dtype, op, solo(ids, vals, out), 1, n, d, vstride, k, stream, id64, scratch,
                    scratch_bytes, 0, blocks, shift,
                    Count{static_cast<const int*>(n_rows), base, cap, rpb});
}

// The lanes entry: the device-count launch for `lanes` lanes at once (1 …
// kMaxLanes), each lane b with its own ids[b], vals[b] and out[b] (host
// arrays of device pointers, copied into the launches' parameters, so a
// CUDA graph that captures the launch keeps them) and its own count
// counts[b] (an int32 array in device memory), of which it reduces the
// first `counts[b] - base` of n rows.  The lanes share everything else
// (dtype, op, n, d, vstride, k, id64, the plan), and lane b's scratch is the
// `lane_bytes` (a multiple of 256, at least one lane's plan) at scratch +
// b·lane_bytes.  Every lane's output has the bits of its own
// segment_reduce_launch_rows.  The small and bucketed paths only.
extern "C" int segment_reduce_launch_lanes(int dtype, int op, const void* const* ids,
                                           const void* const* vals, void* const* out, int lanes,
                                           long long n, int d, long long vstride, int k,
                                           void* stream, int id64, void* scratch,
                                           long long lane_bytes, int blocks, int shift,
                                           const void* counts, long long base, int cap,
                                           int rpb) {
  if (counts == nullptr || cap < 1 || rpb < 1 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  Lanes ln{};
  for (int b = 0; b < lanes; ++b) {
    ln.ids[b] = ids[b];
    ln.vals[b] = vals[b];
    ln.out[b] = out[b];
  }
  return launch_any(dtype, op, ln, lanes, n, d, vstride, k, stream, id64, scratch, lane_bytes,
                    lane_bytes, blocks, shift,
                    Count{static_cast<const int*>(counts), base, cap, rpb});
}

// The wide route (rows of d ≥ 64 values; kernels/segment_reduce.py::_route):
// the arguments of segment_reduce_launch, with dtype 0 = float32, 1 =
// int32, 2 = bf16 (summed in float32: `out` is float32); `shift` the
// bucket size 2^shift; `threads` a reduce block's threads (its column tile
// is threads · 16 bytes of values); the scratch holds the counts, the
// scan's sums and a record of (id, row) for every kept row.  With `n_rows`
// (a device count, as segment_reduce_launch_rows: `base`, `cap`, `rpb`) the
// launch reduces the first `*n_rows - base` rows; null: all n.  Every
// output cell is the ⊕ of its rows in row order, by one thread.
extern "C" int segment_reduce_wide_launch(int dtype, int op, const void* ids, const void* vals,
                                          void* out, long long n, int d, long long vstride,
                                          int k, void* stream, int id64, void* scratch,
                                          long long scratch_bytes, int blocks, int shift,
                                          int threads, const void* n_rows, long long base,
                                          int cap, int rpb) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (op < 0 || op > 2 || d < 1 || k < 0 || n < 0 || blocks < 1 || shift < 0 || shift > 30 ||
      dtype < 0 || dtype > 2 || (n_rows != nullptr && (cap < 1 || rpb < 1)))
    return (int)cudaErrorInvalidValue;
  const Count count{static_cast<const int*>(n_rows), base, cap, rpb};
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const int err =
      id64 ? wide_dtype<long long>(dtype, op, (const long long*)ids, vals, out, n, d, vstride, k,
                                   sc, scratch_bytes, blocks, shift, threads, count, s)
           : wide_dtype<int>(dtype, op, (const int*)ids, vals, out, n, d, vstride, k, sc,
                             scratch_bytes, blocks, shift, threads, count, s);
  return err ? err : (int)cudaGetLastError();
}

extern "C" const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
