// Causal (or full) attention with an online softmax, optionally within a
// local window, for Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`): a grid of (batch*heads, Sq/bq) steps that
// each hold one query tile and scan K/V in [bk] chunks with a running
// (max, sum, acc) in VMEM, never materialising the [Sq, Sk] scores.
//
// Bound: operations.  Causal attention over [BH, S, hd] needs
// 4·BH·hd·S(S+1)/2 flops against (4·BH·S·hd) elements of traffic, far above
// the card's flop-per-byte line at the prefill lengths of the serve path.
//
// Local window (`window` > 0; recurrentgemma-2b's lattn layers): key j is
// kept for query i when j > i - window, beside the causal j <= i; masked
// scores are -1e30, as the reference's `_scores_mask`.  The TPU package
// computes the window in jnp and slices each query chunk's key span; here
// a block starts its key loop at the tile that its first row's window
// reaches, so a causal windowed block visits at most
// ceil((window + TQ) / TK) + 1 key tiles and a windowed prefill costs
// O(S·window).  A tile is masked element by element only when it is an
// edge tile: ragged, crossing the causal diagonal, or holding a key below
// some row's window.  A row whose keys in a visited tile are all masked
// sums weights of 1 at the running max -1e30; they are scaled by exactly 0
// at the row's first visible key (every causal row sees its own key).
//
// bfloat16 (the serve path): both products on the tensor cores, with
// mma.sync m16n8k16 (bf16 in, float32 accumulators; csrc/ptx.cuh).
//   * one block of 4 warps per (bh, 64-row query tile), the tiles with the
//     most keys scheduled first (causal: the last query tiles); each warp
//     owns 16 query rows, whose Q fragments are loaded once with ldmatrix
//     and stay in registers up to hd 128.  At hd 256 they would take 64
//     registers a lane beside 128 accumulators of O, past the 255 a thread
//     may have, so there the fragments are read again from the Q tile in
//     shared memory (ldmatrix) at each k-step of QKᵀ, and the key tile is
//     32 keys (Q 32 KB + two stages of K and V 64 KB: two blocks an SM);
//   * K and V are staged in bf16, 64 keys a tile (32 at hd 256), by 16-byte cp.async
//     copies into a two-stage ring: the copy of tile j+1 is in flight while
//     tile j is multiplied, with one __syncthreads a tile.  16-byte chunks
//     are XOR-swizzled within each group of eight rows, so that ldmatrix
//     (K) and ldmatrix.trans (V) read eight rows without bank conflicts;
//   * S = QKᵀ stays in the accumulator fragments; the online softmax runs
//     there in float32, on scores scaled by hd^-0.5·log2(e) for exp2f, with
//     row max and row sum across the 4 lanes that share a row;
//   * P is re-packed to bf16 in registers as the A fragments of O += PV
//     (the C layout of one 16×16 pair of n-tiles is the A layout);
//   * a causal block stops at its diagonal key tile; only that tile and
//     the ragged last tile are masked element by element: causal-masked
//     scores are -1e30 as in the TPU kernel, keys past Sk weigh exactly 0,
//     and their staging rows are zero-filled (cp.async with src-size 0), so
//     that whatever lies past Sk cannot reach the output as 0·NaN.  Rows
//     past Sq are never written.
//   Shared memory: Q 64×hd plus two stages of K and V TK×hd, bf16: 80 KB at
//   hd 128 and 96 KB at hd 256, two blocks an SM.
//
// Training: `flash_attention_lse_launch` also writes each query row's
// log-sum-exp of its scaled, masked scores (natural log, float32), from the
// running max and sum the block already holds; the output is computed as
// in `flash_attention_launch`, bit for bit.  The backward
// (csrc/flash_attention_bwd.cu) recomputes the weights from it.
//
// float32 (the 2-layer float32 model check): float32 FMAs, no tensor cores
// (float32 has no tensor-core path without TF32):
//   * one block of 256 threads per (bh, 64-row query tile); the query tile
//     is loaded once, scaled by hd^-0.5, into shared memory;
//   * K and V are staged through shared memory in 32-key tiles; a causal
//     block stops at its diagonal tile, a windowed one starts at the tile
//     its first row's window reaches; at hd 256 the tiles take 137 KB;
//   * thread (ty, tx) of a 16×16 grid owns query rows 4·ty..4·ty+3, the
//     score columns tx and tx+16 of a tile and the output columns
//     tx + 16·c; row max and row sum go across the 16 lanes of a half-warp
//     with shuffles; running max, sum and accumulator stay in registers;
//   * rows of Q and K in shared memory are padded by one float so that the
//     strided column reads of the score loop hit distinct banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TQ = 64;            // query rows of a block, 16 a warp
constexpr int kTcThreads = 128;   // 4 warps

// keys of a staged tile, and whether a warp keeps its Q fragments in
// registers across the key loop (not at hd 256: see the head comment)
template <int HD>
__host__ __device__ constexpr int tile_keys() { return HD >= 256 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 128; }
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of the 16-byte chunk `chunk` of row `row` in a [rows][HD]
// bf16 tile: chunk ^ (a function of row) within each row, so that the same
// chunk of eight consecutive rows falls into eight distinct groups of 4 banks.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = HD / 8;  // chunks a row
  if constexpr (C >= 8)
    return (row * C + (chunk ^ (row & 7))) * 8;
  else
    return (row * C + (chunk ^ ((row / (8 / C)) & (C - 1)))) * 8;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
constexpr size_t tc_smem_bytes() {
  return (size_t)(TQ + 4 * tile_keys<HD>()) * HD * sizeof(__nv_bfloat16);
}

// The first key a block of query rows q0.. must visit: its first row's
// window starts there (0 without a window).
__device__ __forceinline__ int first_key(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) : 0;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ Q,
                      const __nv_bfloat16* __restrict__ K,
                      const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                      float* __restrict__ LSE, int Sq, int Sk, float scale_log2, int causal,
                      int window) {
  constexpr int TK = tile_keys<HD>();
  constexpr bool QREG = q_in_registers<HD>();
  constexpr int C = HD / 8;    // 16-byte chunks a row
  constexpr int KD = HD / 16;  // k-steps of QKᵀ
  constexpr int NT = TK / 8;   // n-tiles of S (8 keys each)
  constexpr int DT = HD / 8;   // n-tiles of O (8 columns each)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][HD]
  __nv_bfloat16* Ks = Qs + TQ * HD;                                 // [2][TK][HD]
  __nv_bfloat16* Vs = Ks + 2 * TK * HD;                             // [2][TK][HD]

  // the blocks with the most key tiles first, so that short blocks fill
  // the tail: the last query tiles when causal (with a window too: those
  // before the window's reach are the short ones), the first otherwise
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q = Q + (long long)bh * Sq * HD;
  const __nv_bfloat16* k = K + (long long)bh * Sk * HD;
  const __nv_bfloat16* v = V + (long long)bh * Sk * HD;

  // a causal block sees keys up to its last row only, a windowed one from
  // its first row's window on (≥ 1 tile: Sk ≥ 1)
  const int kend = causal ? min(Sk, q0 + TQ) : Sk;
  const int tile0 = min(first_key(q0, window), kend - 1) / TK;
  const int ntiles = (kend + TK - 1) / TK;
  // the last key some row of the block masks by its window (-1: none)
  const int wlast = window > 0 ? q0 + TQ - 1 - window : -1;

  for (int i = tid; i < TQ * C; i += kTcThreads) {
    const int r = i / C, c = i % C, row = q0 + r;
    const bool ok = row < Sq;
    ptx::cp_async16(ptx::smem_addr(Qs + swz<HD>(r, c)),
                    q + (ok ? (long long)row * HD + c * 8 : 0), ok ? 16 : 0);
  }
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* ks = Ks + stage * TK * HD;
    __nv_bfloat16* vs = Vs + stage * TK * HD;
    for (int i = tid; i < TK * C; i += kTcThreads) {
      const int r = i / C, c = i % C, key = tile * TK + r;
      const bool ok = key < Sk;  // keys past Sk: zero-filled
      const long long off = ok ? (long long)key * HD + c * 8 : 0;
      const int d = swz<HD>(r, c);
      ptx::cp_async16(ptx::smem_addr(ks + d), k + off, ok ? 16 : 0);
      ptx::cp_async16(ptx::smem_addr(vs + d), v + off, ok ? 16 : 0);
    }
  };
  load_kv(tile0, tile0 & 1);
  ptx::cp_async_commit();

  ptx::cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 rows of Q: in registers for the whole key loop, or read
  // from the Q tile at each k-step (hd 256)
  auto q_frag = [&](uint32_t (&r)[4], int kd) {
    ptx::ldmatrix_x4(r, ptx::smem_addr(Qs + swz<HD>(warp * 16 + (lane & 15), kd * 2 + (lane >> 4))));
  };
  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) q_frag(qf[kd], kd);
  }
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8; l per lane
  const int row0 = q0 + warp * 16 + g;

  for (int j = tile0; j < ntiles; ++j) {
    ptx::cp_async_wait<0>();  // this thread's copies of tile j landed
    __syncthreads();          // everyone's did; stage (j+1)&1 is no longer read
    if (j + 1 < ntiles) {
      load_kv(j + 1, (j + 1) & 1);
      ptx::cp_async_commit();
    }
    const __nv_bfloat16* ks = Ks + (j & 1) * TK * HD;
    const __nv_bfloat16* vs = Vs + (j & 1) * TK * HD;

    // S = Q Kᵀ for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      if constexpr (QREG) {
        qa[0] = qf[kd][0];
        qa[1] = qf[kd][1];
        qa[2] = qf[kd][2];
        qa[3] = qf[kd][3];
      } else {
        q_frag(qa, kd);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, ptx::smem_addr(ks + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                       kd * 2 + ((lane >> 3) & 1))));
        ptx::mma_bf16_16816(s[2 * np], qa, b[0], b[1]);
        ptx::mma_bf16_16816(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    // scale (log2 domain), mask the diagonal, the window's lower edge and
    // the ragged tile only
    const int k0 = j * TK;
    const bool edge = k0 + TK > Sk || (causal && k0 + TK - 1 > q0) || k0 <= wlast;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk)
            x = -INFINITY;  // padding: weighs exactly 0
          else if ((causal && key > row) || (window > 0 && key <= row - window))
            x = kNeg;
        }
        s[n][e] = x;
      }
    }

    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);  // key k0 is real, so at least -1e30
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, P re-packed to bf16 A fragments in registers
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {ptx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              ptx::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              ptx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              ptx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ptx::ldmatrix_x4_trans(
            b, ptx::smem_addr(vs + swz<HD>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           dp * 2 + (lane >> 4))));
        ptx::mma_bf16_16816(o[2 * dp], pa, b[0], b[1]);
        ptx::mma_bf16_16816(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  __nv_bfloat16* out = O + (long long)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float lsum = quad_sum(l[i]);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (row >= Sq) continue;
    // the row's log-sum-exp of the scaled scores, natural log: m is in
    // log2 units of the scaled scores
    if (LSE != nullptr && t == 0) LSE[(long long)bh * Sq + row] = (m[i] + log2f(lsum)) * kLn2;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long long)row * HD + 2 * t);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      dst[d * 4] = ptx::pack_bf16(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
                int Sk, float scale, int causal, int window, cudaStream_t s) {
  const size_t bytes = tc_smem_bytes<HD>();
  // above 48 KB a block's shared memory has to be asked for explicitly
  cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + TQ - 1) / TQ);
  flash_bf16_kernel<HD><<<grid, kTcThreads, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, Sq, Sk, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 32;         // keys of a staged tile
constexpr int kThreads = 256;  // 16 x 16

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, float* __restrict__ O,
                     float* __restrict__ LSE, int Sq, int Sk, float scale, int causal,
                     int window) {
  constexpr int LD = HD + 1;    // padded row stride of Qs and Ks
  constexpr int LP = BK + 1;    // padded row stride of Ps
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD], scaled
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][LP], this tile's softmax weights

  // the blocks with the most key tiles first (as the bf16 kernel)
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* q = Q + (long long)bh * Sq * HD;
  const float* k = K + (long long)bh * Sk * HD;
  const float* v = V + (long long)bh * Sk * HD;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    Qs[r * LD + c] = row < Sq ? q[(long long)row * HD + c] * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // a causal block sees keys up to its last row only, a windowed one from
  // its first row's window on
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = min(first_key(q0, window), kend - 1) / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, key = k0 + r;
      const bool ok = key < Sk;
      Ks[r * LD + c] = ok ? k[(long long)key * HD + c] : 0.f;
      Vs[r * HD + c] = ok ? v[(long long)key * HD + c] : 0.f;
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
        else if ((causal && key > row) || (window > 0 && key <= row - window))
          s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 is a real key, so the tile max is at least -1e30
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

  float* o = O + (long long)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[(long long)row * HD + tx + 16 * c] = acc[i][c] * inv;
    // the row's log-sum-exp: m and the scores are in natural units here
    if (LSE != nullptr && tx == 0) LSE[(long long)bh * Sq + row] = m[i] + logf(l[i]);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
               int Sk, float scale, int causal, int window, cudaStream_t s) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_f32_kernel<HD><<<grid, kThreads, bytes, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq, Sk, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int BH,
           int Sq, int Sk, float scale, int causal, int window, cudaStream_t s) {
  if (dtype == 0) return launch_f32<HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, window, s);
  if (dtype == 1) return launch_bf16<HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

int launch_any(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
               int BH, int Sq, int Sk, int hd, float scale, int causal, int window,
               void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || window < 0 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (BH == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, out, lse, BH, Sq, Sk, scale, causal, window, s);
    case 32: return launch<32>(dtype, q, k, v, out, lse, BH, Sq, Sk, scale, causal, window, s);
    case 64: return launch<64>(dtype, q, k, v, out, lse, BH, Sq, Sk, scale, causal, window, s);
    case 128: return launch<128>(dtype, q, k, v, out, lse, BH, Sq, Sk, scale, causal, window, s);
    case 256: return launch<256>(dtype, q, k, v, out, lse, BH, Sq, Sk, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q, out:
// [BH, Sq, hd]; k, v: [BH, Sk, hd]; all contiguous, bfloat16 ones 16-byte
// aligned.  hd ∈ {16, 32, 64, 128, 256}.  window: 0 for none, else key j is
// kept for query i only when j > i - window.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq, int Sk,
                                      int hd, float scale, int causal, int window,
                                      void* stream) {
  return launch_any(dtype, q, k, v, out, nullptr, BH, Sq, Sk, hd, scale, causal, window,
                    stream);
}

// The same, also writing lse [BH, Sq] float32: each query row's
// log-sum-exp (natural log) of its scaled, masked scores, what the
// backward (csrc/flash_attention_bwd.cu) recomputes the weights from.
extern "C" int flash_attention_lse_launch(int dtype, const void* q, const void* k,
                                          const void* v, void* out, void* lse, int BH, int Sq,
                                          int Sk, int hd, float scale, int causal, int window,
                                          void* stream) {
  return launch_any(dtype, q, k, v, out, (float*)lse, BH, Sq, Sk, hd, scale, causal, window,
                    stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
