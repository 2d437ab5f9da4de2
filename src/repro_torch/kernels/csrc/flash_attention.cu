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
// bfloat16 at hd 64 and 256 from 64 query rows (`flash_attention_wg_launch`;
// recurrentgemma-2b's lattn layers, whisper-tiny's attention): both
// products on wgmma (csrc/wgmma.cuh), Q, K and V in shared memory in the
// 128-byte-swizzled panels wgmma reads, S = QKᵀ as m64n64k16 products
// with both operands there, the online softmax on S's accumulator
// fragments (the mma.sync C layout), P re-packed to bf16 register A
// operands of O += P·V (V MN-major), 64-key tiles.  The products wait on
// the softmax, so it is kept short: ex2.approx.ftz in place of exp2f
// (which adds instructions to keep results below 2^-126), row maxima and
// sums as trees, the scale folded into the exponent's FMA off the edge
// tiles, and O's rescale skipped by a warp whose rows kept their max:
//   * hd 256 (`flash_tma_kernel`): 128 query rows a block, two consumer
//     warpgroups of 64 and a producer warpgroup, one thread of which
//     loads Q once and each tile's K and V by TMA into two stages each,
//     mbarriers a stage for landed and freed; the producer's registers
//     are lowered (setmaxnreg) so that each consumer thread may hold 240
//     (O's 128 accumulators, S's 32, P's 16 among them).  Each
//     consumer issues a tile's S with the last tile's P·V behind it (P·V
//     runs under the tile's softmax), and the two take turns to issue
//     (named barriers), so that one's softmax runs under the other's
//     products.  197 KB of shared memory, one block an SM;
//   * hd 64 (`flash_wg_kernel`): one warpgroup of 64 rows a block, K and V
//     by cp.async into two stages each, each tile in turn (S, softmax, O
//     rescaled, O += P·V), 41 KB and few registers, so that several blocks
//     share an SM and one's softmax runs under another's products.
//   Both stage O through the Q tile and store whole 16-byte chunks.
// bfloat16 otherwise (hd 16, 32 and 128; fewer than 64 query rows, as a
// decode tick's one; and every width in `flash_attention_launch` and
// `flash_attention_lse_launch`): both products with mma.sync m16n8k16
// (bf16 in, float32 accumulators; csrc/ptx.cuh).
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
// Training: `flash_attention_lse_launch` (and `flash_attention_wg_launch`
// given an lse pointer) also writes each query row's log-sum-exp of its
// scaled, masked scores (natural log, float32), from the running max and
// sum the block already holds; the output is computed as without it, bit
// for bit.  The backward (csrc/flash_attention_bwd.cu) recomputes the
// weights from it.
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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "ptx.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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
// bfloat16 at hd 64 and 256: wgmma
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // query rows of a warpgroup
constexpr int kWgTK = 64;    // keys of a tile

// rows [r0, r0 + R) of a [S][HD] bf16 matrix into an R-row 128-byte-swizzled
// tile at shared address `tile` (wgmma.cuh's panels), by 16-byte cp.async
// copies of NT threads: thread tid copies chunk tid % C of rows tid / C +
// k·NT/C; rows at or past S are zero-filled
template <int HD, int R, int NT>
__device__ __forceinline__ void stage_wg(uint32_t tile, const __nv_bfloat16* src, int r0, int S,
                                         int tid) {
  constexpr int C = HD / 8, RS = NT / C;  // chunks a row, rows a pass
  static_assert(NT % C == 0 && R % RS == 0, "whole rows a pass");
  const int c = tid % C, r = tid / C;
  const __nv_bfloat16* p = src + (long long)(r0 + r) * HD + c * 8;
  const uint32_t d = tile + (c >> 3) * R * 128 + r * 128;
#pragma unroll
  for (int k = 0; k < R / RS; ++k) {
    const int rr = r + k * RS;
    const bool ok = r0 + rr < S;
    ptx::cp_async16(d + k * RS * 128 + (((c & 7) ^ (rr & 7)) << 4), ok ? p + k * RS * HD : src,
                    ok ? 16 : 0);
  }
}

// S = Q·Kᵀ over a 64-key tile: m64n64k16 products, both operands K-major
// (Q: the warpgroup's rows of a BQ-row tile at `qa`; K at `kt`); the first
// k16 step does not accumulate
template <int HD, int BQ>
__device__ __forceinline__ void issue_s(float (&s)[kWgTK / 2], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)
    wg::mma_m64n64k16_ss<0, 0>(s, wg::desc(qa + (kd >> 2) * BQ * 128 + (kd & 3) * 32, 16, 1024),
                               wg::desc(kt + (kd >> 2) * kWgTK * 128 + (kd & 3) * 32, 16, 1024),
                               kd > 0);
  wg::commit();
}

// O += P·V over a 64-key tile (4 k16 steps), P from registers, V MN-major
// at shared address `vt`; hd 256 as two m64n128 products a step, columns
// 0..127 (panels 0, 1) and 128..255 (panels 2, 3)
template <int HD, int NO, int OW>
__device__ __forceinline__ void issue_pv(float (&o)[NO][OW], const uint32_t (&pa)[kWgTK / 16][4],
                                         uint32_t vt) {
  constexpr uint32_t LBO = kWgTK * 128;  // the next 64 columns: a panel on
#pragma unroll
  for (int kk = 0; kk < kWgTK / 16; ++kk) {
    const uint32_t v = vt + kk * 2048;
    if constexpr (HD == 64) {
      wg::mma_m64n64k16_rs<1>(o[0], pa[kk], wg::desc(v, LBO, 1024), 1);
    } else {
#pragma unroll
      for (int h = 0; h < NO; ++h)
        wg::mma_m64n128k16_rs<1>(o[h], pa[kk], wg::desc(v + h * 2 * LBO, LBO, 1024), 1);
    }
  }
  wg::commit();
}

template <int NO, int OW>
__device__ __forceinline__ void hold_o(float (&o)[NO][OW]) {
#pragma unroll
  for (int h = 0; h < NO; ++h) wg::hold(o[h]);
}
template <int PK>
__device__ __forceinline__ void hold_pa(uint32_t (&pa)[PK][4]) {
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) wg::hold(pa[kk]);
}

// the larger of s[4n + 2h] and s[4n + 2h + 1] over n, as a tree (no chain
// of dependent instructions as long as the row)
template <int NS>
__device__ __forceinline__ float row_max(const float (&s)[NS], int h) {
  float a[NS / 4];
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) a[n] = fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]);
#pragma unroll
  for (int w = NS / 8; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) a[n] = fmaxf(a[n], a[n + w]);
  return a[0];
}

// The online softmax of one tile's scores on the accumulator fragments
// (s[4n + 2h + e]: row row0 + 8h, key k0 + 8n + 2t + e) in the log2
// domain: the running max m and sum l (per lane) moved on; returns in
// `alpha` the factor the rows' earlier sums are scaled by, and leaves
// exp2 of the scaled scores less the max in s.  An edge tile is scaled
// and masked element by element; any other is scaled inside the
// exponent's FMA (its max taken on the unscaled scores: scale_log2 > 0
// keeps their order)
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, bool edge,
                                             int k0, int row0, int t, int Sk, int causal,
                                             int window) {
  float mx[2];
  if (edge) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (key >= Sk)
          x = -INFINITY;  // padding: weighs exactly 0
        else if ((causal && key > row) || (window > 0 && key <= row - window))
          x = kNeg;
        s[4 * n + e] = x;
      }
    }
    mx[0] = row_max(s, 0);
    mx[1] = row_max(s, 1);
  } else {
    mx[0] = row_max(s, 0) * scale_log2;
    mx[1] = row_max(s, 1) * scale_log2;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(m[h], quad_max(mx[h]));  // key k0 is real, so at least -1e30
    alpha[h] = ptx::ex2(m[h] - mx[h]);
    m[h] = mx[h];
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = ptx::ex2(s[i] - mx[(i >> 1) & 1]);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = ptx::ex2(fmaf(s[i], scale_log2, -mx[(i >> 1) & 1]));
  }
  float rs[2][4] = {};  // four partial sums a row
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) rs[e >> 1][(n & 1) * 2 + (e & 1)] += s[4 * n + e];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * alpha[h] + ((rs[h][0] + rs[h][1]) + (rs[h][2] + rs[h][3]));
}

// O's rows rescaled to a tile's new max: o[h][4j + 2hh + e] is row row0 +
// 8hh; nothing to do (o·1 = o) when no row of the warp has a new max
template <int NO, int OW>
__device__ __forceinline__ void rescale_o(float (&o)[NO][OW], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int h = 0; h < NO; ++h)
#pragma unroll
    for (int i = 0; i < OW; ++i) o[h][i] *= alpha[(i >> 1) & 1];
}

// P in bf16 as the A fragments of O += P·V: k16 step kk holds keys
// 16kk..16kk+15 (the accumulator's n-tiles 2kk and 2kk+1)
template <int PK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[PK][4], const float (&s)[PK * 8]) {
#pragma unroll
  for (int kk = 0; kk < PK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = ptx::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A warp's O / l in bf16 into its rows (r0 + g and r0 + g + 8, r0 its
// first row in the tile) of the BQ-row Q tile at `qtile` (the products
// are done with them), and each row's log-sum-exp of its scaled scores
// (natural log; m is in log2 units) into lse[q0 + r] when lse is not null
template <int HD, int BQ, int NO, int OW>
__device__ __forceinline__ void stage_o(unsigned char* qtile, float (&o)[NO][OW],
                                        const float (&m)[2], const float (&l)[2], int r0,
                                        int q0, int Sq, float* lse, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    const float lsum = quad_sum(l[hh]);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (lse != nullptr && t == 0 && q0 + r < Sq) lse[q0 + r] = (m[hh] + log2f(lsum)) * kLn2;
#pragma unroll
    for (int h = 0; h < NO; ++h)
#pragma unroll
      for (int jj = 0; jj < OW / 4; ++jj)
        *reinterpret_cast<uint32_t*>(qtile + wg::sw128<BQ>(r, h * (2 * OW / 8) + jj) + 4 * t) =
            ptx::pack_bf16(o[h][4 * jj + 2 * hh] * inv, o[h][4 * jj + 2 * hh + 1] * inv);
  }
}

// rows [r0, r0 + R) of the staged BQ-row tile out to O's rows q0 + r (those
// below Sq), whole 16-byte chunks, by NT threads
template <int HD, int BQ, int R, int NT>
__device__ __forceinline__ void store_o(__nv_bfloat16* out, const unsigned char* qtile, int r0,
                                        int q0, int Sq, int tid) {
  constexpr int C = HD / 8;
#pragma unroll
  for (int kk = 0; kk < R * C / NT; ++kk) {
    const int i = tid + kk * NT, r = r0 + i / C, c = i % C, row = q0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (long long)row * HD + c * 8) =
          *reinterpret_cast<const uint4*>(qtile + wg::sw128<BQ>(r, c));
  }
}

// hd 64: one warpgroup a block and five blocks an SM (at most 96 registers
// a thread, 41 KB), K and V by cp.async into two stages each; each tile in
// turn: S, its softmax, O rescaled, O += P·V.  Whisper-tiny's encoder at
// 4 requests has 24 (batch, head) × 24 query tiles, 4.4 an SM of 132:
// with five resident a block, no tile waits for a second round.  At 96
// registers ptxas serialises the wgmma products (its C7512 note); four
// blocks an SM (111 registers, not serialised) measured no faster.
constexpr int kWgBlocks = 5;

template <int HD>
constexpr size_t wg_smem_bytes() {
  // 1024 of slack to align the tiles; Q; two stages of K and of V
  return 1024 + (size_t)(kWgRows + 4 * kWgTK) * HD * 2;
}

template <int HD>
__global__ void __launch_bounds__(128, kWgBlocks)
    flash_wg_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                    const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                    float* __restrict__ LSE, int Sq, int Sk, float scale_log2, int causal,
                    int window) {
  static_assert(HD == 64, "the cp.async wgmma kernel is hd 64's");
  constexpr int TK = kWgTK, BQ = kWgRows, PK = TK / 16, NS = TK / 2;
  constexpr int NO = 1, OW = HD / 2;
  constexpr uint32_t KB = TK * HD * 2;  // bytes of a K or V stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [BQ][HD]
  const uint32_t sK = sQ + BQ * HD * 2;                       // [2][TK][HD]
  const uint32_t sV = sK + 2 * KB;                            // [2][TK][HD]
  unsigned char* const qtile = smem_raw + (sQ - raw);

  // the blocks with the most key tiles first (as the mma.sync kernel)
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long koff = (long long)blockIdx.x * Sk * HD;

  // the block's key tiles: up to its last row when causal, from its first
  // row's window on (≥ 1 tile: Sk ≥ 1); a tile is masked element by
  // element only past k_safe (ragged, or crossing the diagonal) or up to
  // the window's last masked key (wlast, -1: none)
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  const int tile0 = min(first_key(q0, window), kend - 1) / TK;
  const int ntiles = (kend + TK - 1) / TK;
  const int k_safe = causal ? min(Sk, q0 + 1) - TK : Sk - TK;
  const int wlast = window > 0 ? q0 + BQ - 1 - window : -1;
  // tile j's K and V into stage j & 1, one group
  auto load = [&](int j) {
    const uint32_t st = ((j - tile0) & 1) * KB;
    stage_wg<HD, TK, 128>(sK + st, K + koff, j * TK, Sk, tid);
    stage_wg<HD, TK, 128>(sV + st, V + koff, j * TK, Sk, tid);
    ptx::cp_async_commit();
  };
  stage_wg<HD, BQ, 128>(sQ, Q + (long long)blockIdx.x * Sq * HD, q0, Sq, tid);
  load(tile0);

  float o[NO][OW];
#pragma unroll
  for (int i = 0; i < OW; ++i) o[0][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows row0 and row0 + 8; l per lane
  float alpha[2];
  uint32_t pa[PK][4];
  float s[NS];
  const int row0 = q0 + 16 * warp + (lane >> 2);
  for (int j = tile0; j < ntiles; ++j) {
    const int k0 = j * TK;
    const uint32_t st = ((j - tile0) & 1) * KB;
    // tile j landed everywhere, and tile j-1's products are done: tile
    // j+1's copy may start.  S's registers were last read by the pack,
    // which the last P·V waited on
    ptx::cp_async_wait<0>();
    wg::fence_async_shared();
    __syncthreads();
    if (j + 1 < ntiles) load(j + 1);
    wg::fence();
    issue_s<HD, BQ>(s, sQ, sK + st);
    wg::wait<0>();
    wg::hold(s);
    softmax_tile(s, m, l, alpha, scale_log2, k0 > k_safe || k0 <= wlast, k0, row0, lane & 3, Sk,
                 causal, window);
    rescale_o(o, alpha);
    pack_p(pa, s);
    hold_pa(pa);
    hold_o(o);
    wg::fence();
    issue_pv<HD, NO, OW>(o, pa, sV + st);
    wg::wait<0>();
    hold_o(o);
  }

  // O / l in bf16, staged through the Q tile, out in whole 16-byte chunks
  stage_o<HD, BQ>(qtile, o, m, l, 16 * warp, q0, Sq,
                  LSE == nullptr ? nullptr : LSE + (long long)blockIdx.x * Sq, lane);
  __syncthreads();
  store_o<HD, BQ, BQ, 128>(O + (long long)blockIdx.x * Sq * HD, qtile, 0, q0, Sq, tid);
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
              int Sk, float scale, int causal, int window, cudaStream_t s) {
  const size_t bytes = wg_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_wg_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + kWgRows - 1) / kWgRows);
  flash_wg_kernel<HD><<<grid, 128, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, Sq, Sk, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

// hd 256: two consumer warpgroups of 64 query rows and one producer
// warpgroup, one thread of which issues TMA copies: Q once, then each
// tile's K and V into KS and VS stages as the consumers free them.  The
// producer's registers are lowered to kProdRegs a thread, the consumers'
// raised to kConsRegs (a launch of 384 threads starts at 168).  Each
// consumer issues a tile's S with the last tile's P·V behind it, so that
// P·V runs while the tile's softmax runs, and the two take turns to issue
// (named barriers 1 + w), so that one's softmax runs under the other's
// products.
constexpr int kTmaWG = 2, kTmaKS = 2, kTmaVS = 2;
constexpr int kTmaThreads = (kTmaWG + 1) * 128;
constexpr int kProdRegs = 24, kConsRegs = 240;
// named barriers: 1 + w, warpgroup w's turn to issue its products; 3 + w,
// warpgroup w's epilogue
constexpr int kSchedBar = 1, kEpiBar = 3;

template <int HD>
constexpr size_t tma_smem_bytes() {
  // 1024 of slack to align the tiles; Q; the K and V stages; the
  // mbarriers (Q's, a full and an empty one a stage)
  return 1024 + (size_t)(kTmaWG * kWgRows + (kTmaKS + kTmaVS) * kWgTK) * HD * 2 +
         8 * (1 + 2 * (kTmaKS + kTmaVS));
}

template <int HD>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ O,
                     float* __restrict__ LSE, int Sq, int Sk, float scale_log2, int causal,
                     int window) {
  static_assert(HD == 256, "the TMA wgmma kernel is hd 256's");
  constexpr int NWG = kTmaWG, TK = kWgTK, KS = kTmaKS, VS = kTmaVS;
  constexpr int BQ = NWG * kWgRows, PK = TK / 16, NS = TK / 2;
  constexpr int OW = 64, NO = HD / 2 / OW;
  constexpr uint32_t KB = TK * HD * 2;  // bytes of a K or V stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [BQ][HD]
  const uint32_t sK = sQ + BQ * HD * 2;                       // [KS][TK][HD]
  const uint32_t sV = sK + KS * KB;                           // [VS][TK][HD]
  const uint32_t bQ = sV + VS * KB;                           // Q landed
  const uint32_t fullK = bQ + 8, emptyK = fullK + 8 * KS;     // a stage landed / freed
  const uint32_t fullV = emptyK + 8 * KS, emptyV = fullV + 8 * VS;
  unsigned char* const qtile = smem_raw + (sQ - raw);

  // the blocks with the most key tiles first (as the mma.sync kernel)
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  const int tile0 = min(first_key(q0, window), kend - 1) / TK;
  const int nt = (kend + TK - 1) / TK - tile0;  // tiles of the block

  if (tid == 0) {
    wg::mbar_init(bQ, 1);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      wg::mbar_init(fullK + 8 * i, 1);
      wg::mbar_init(emptyK + 8 * i, NWG * 4);  // each consumer warp's release
    }
#pragma unroll
    for (int i = 0; i < VS; ++i) {
      wg::mbar_init(fullV + 8 * i, 1);
      wg::mbar_init(emptyV + 8 * i, NWG * 4);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (w == NWG) {
    // the producer: each box one 64-column panel
    wg::reg_dealloc<kProdRegs>();
    if (warp == 0 && lane == 0) {
      wg::mbar_expect(bQ, BQ * HD * 2);
#pragma unroll
      for (int pn = 0; pn < HD / 64; ++pn)
        wg::tma_load_3d(sQ + pn * BQ * 128, &tq, bQ, pn * 64, q0, bh);
      for (int i = 0; i < nt; ++i) {
        const int key = (tile0 + i) * TK, ks = i % KS, vs = i % VS;
        if (i >= KS) wg::mbar_wait(emptyK + 8 * ks, (i / KS - 1) & 1);
        wg::mbar_expect(fullK + 8 * ks, KB);
#pragma unroll
        for (int pn = 0; pn < HD / 64; ++pn)
          wg::tma_load_3d(sK + ks * KB + pn * TK * 128, &tk, fullK + 8 * ks, pn * 64, key, bh);
        if (i >= VS) wg::mbar_wait(emptyV + 8 * vs, (i / VS - 1) & 1);
        wg::mbar_expect(fullV + 8 * vs, KB);
#pragma unroll
        for (int pn = 0; pn < HD / 64; ++pn)
          wg::tma_load_3d(sV + vs * KB + pn * TK * 128, &tv, fullV + 8 * vs, pn * 64, key, bh);
      }
    }
    return;
  }

  // the consumers.  Every warpgroup takes every tile of the block (a tile
  // wholly masked for its rows adds weights that the rows' first visible
  // key scales by exactly 0, or, past the causal diagonal, weighs 0 at a
  // real running max)
  wg::reg_alloc<kConsRegs>();
  const int qw = q0 + kWgRows * w;  // this warpgroup's first row
  const int k_safe = causal ? min(Sk, qw + 1) - TK : Sk - TK;
  const int wlast = window > 0 ? qw + kWgRows - 1 - window : -1;
  // a stage read by this warpgroup's finished products, freed by each warp
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(bar);
  };
  float o[NO][OW];
#pragma unroll
  for (int h = 0; h < NO; ++h)
#pragma unroll
    for (int i = 0; i < OW; ++i) o[h][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows row0 and row0 + 8; l per lane
  float alpha[2];
  uint32_t pa[PK][4];  // the last tile's P
  float s[NS];
  const int row0 = qw + 16 * warp + (lane >> 2);
  const uint32_t qa = sQ + kWgRows * w * 128;  // this warpgroup's rows of the Q tile

  wg::mbar_wait(bQ, 0);
  if (w == 1) wg::bar_arrive(kSchedBar, 2 * 128);  // the first turn is warpgroup 0's
  // the first tile: S, its softmax, its P.  Warpgroup 1's last turn is
  // not waited on, so it does not announce it
  {
    const int k0 = tile0 * TK;
    wg::mbar_wait(fullK, 0);
    wg::bar_sync(kSchedBar + w, 2 * 128);
    wg::fence();
    issue_s<HD, BQ>(s, qa, sK);
    if (w == 0 || nt > 1) wg::bar_arrive(kSchedBar + (w ^ 1), 2 * 128);
    wg::wait<0>();
    wg::hold(s);
    release(emptyK);
    softmax_tile(s, m, l, alpha, scale_log2, k0 > k_safe || k0 <= wlast, k0, row0, lane & 3,
                 Sk, causal, window);
    pack_p(pa, s);
  }
  // then each tile's S with the last tile's O += P·V behind it
  for (int i = 1; i < nt; ++i) {
    const int k0 = (tile0 + i) * TK, ks = i % KS, vs = (i - 1) % VS;
    wg::mbar_wait(fullK + 8 * ks, (i / KS) & 1);
    wg::mbar_wait(fullV + 8 * vs, ((i - 1) / VS) & 1);
    wg::hold(s);
    hold_pa(pa);
    hold_o(o);
    wg::bar_sync(kSchedBar + w, 2 * 128);
    wg::fence();
    issue_s<HD, BQ>(s, qa, sK + ks * KB);
    issue_pv<HD, NO, OW>(o, pa, sV + vs * KB);
    if (w == 0 || i + 1 < nt) wg::bar_arrive(kSchedBar + (w ^ 1), 2 * 128);
    wg::wait<1>();
    wg::hold(s);
    release(emptyK + 8 * ks);
    softmax_tile(s, m, l, alpha, scale_log2, k0 > k_safe || k0 <= wlast, k0, row0, lane & 3,
                 Sk, causal, window);
    // the last tile's P·V is in O: rescale it to this tile's max
    wg::wait<0>();
    hold_o(o);
    hold_pa(pa);
    release(emptyV + 8 * vs);
    rescale_o(o, alpha);
    pack_p(pa, s);
  }
  {
    const int vs = (nt - 1) % VS;
    wg::mbar_wait(fullV + 8 * vs, ((nt - 1) / VS) & 1);
    hold_pa(pa);
    hold_o(o);
    wg::fence();
    issue_pv<HD, NO, OW>(o, pa, sV + vs * KB);
    wg::wait<0>();
    hold_o(o);
  }

  // O / l in bf16, staged through this warpgroup's rows of the Q tile, out
  // in whole 16-byte chunks
  stage_o<HD, BQ>(qtile, o, m, l, kWgRows * w + 16 * warp, q0, Sq,
                  LSE == nullptr ? nullptr : LSE + (long long)bh * Sq, lane);
  wg::bar_sync(kEpiBar + w, 128);
  store_o<HD, BQ, kWgRows, 128>(O + (long long)bh * Sq * HD, qtile, kWgRows * w, q0, Sq,
                                tid & 127);
}

template <int HD>
int launch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
               int Sk, float scale, int causal, int window, cudaStream_t s) {
  constexpr int BQ = kTmaWG * kWgRows;
  CUtensorMap tq, tk, tv;
  int e = tma::tensor_map(&tq, q, HD, Sq, BH, BQ);
  if (e == 0) e = tma::tensor_map(&tk, k, HD, Sk, BH, kWgTK);
  if (e == 0) e = tma::tensor_map(&tv, v, HD, Sk, BH, kWgTK);
  if (e != 0) return e;
  const size_t bytes = tma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_tma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_tma_kernel<HD><<<grid, kTmaThreads, bytes, s>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, Sq, Sk,
                                                       scale * kLog2e, causal, window);
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

// The wgmma kernel of bfloat16 at hd 64 and 256 (q, k, v and out
// bfloat16; shapes and the other arguments as `flash_attention_launch`'s).
// lse: [BH, Sq] float32 as `flash_attention_lse_launch` writes it, or null
// for none; the output is the same bits either way.
extern "C" int flash_attention_wg_launch(const void* q, const void* k, const void* v,
                                         void* out, void* lse, int BH, int Sq, int Sk, int hd,
                                         float scale, int causal, int window, void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || window < 0 || (Sq + kWgRows - 1) / kWgRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (BH == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_wg<64>(q, k, v, out, (float*)lse, BH, Sq, Sk, scale, causal, window, s);
    case 256: return launch_tma<256>(q, k, v, out, (float*)lse, BH, Sq, Sk, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
