// The backward of attention with an online softmax (csrc/flash_attention.cu),
// causal or not, for Hopper (sm_90a), hand-written.
//
// The Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`) has no backward: the reference trains by
// jax.value_and_grad through the jnp form (`_attend`, src/repro/models/
// attention.py).  This is the backward of the port's forward kernel, for
// the LM training step.  Given q, k, v, the forward's output o and its row
// log-sum-exp lse (natural log, of the scaled and masked scores), and the
// output's gradient dO:
//   P = exp(s - lse), s = q·kᵀ·scale (masked: P = 0);
//   D_i = Σ_d dO_id · O_id;            dS = P ⊙ (dO·Vᵀ − D);
//   dV = Pᵀ·dO;  dK = scale·dSᵀ·Q;  dQ = scale·dS·K.
// P is recomputed from q, k and lse: nothing [Sq, Sk]-sized is stored.
// No float atomics anywhere: every launch gives the same bits.
//
// Bound: operations.  Causal, the function needs 5 products of
// 2·BH·hd·(causal pairs) flops (QKᵀ, dO·Vᵀ, PᵀdO, dSᵀQ, dS·K), far above
// the card's flop-per-byte line at the training lengths.  The designs:
// one pass on wgmma (hd 128, and hd 64 causal); dK/dV blocks and dQ blocks
// on wgmma fed by TMA (hd 256, and hd 64 not causal); two kernels on
// mma.sync (hd 16, 32).
//
// bfloat16, hd 128, and hd 64 causal (the LM training path): one pass over
// the keys on wgmma, two launches.
//   1. rowdot: D [BH, Sq] float32, one warp a row; it also zeroes the sync
//      words (a ticket counter and one flag a (bh, 64-row query tile)).
//   2. One block of two warpgroups (256 threads) a (bh, 128-key block);
//      each warpgroup owns 64 keys.  K and V stay in shared memory; the
//      64-row Q and dO tiles the block's keys reach (causal: those from
//      its first key on) come through a two-stage cp.async ring, in the
//      128-byte swizzle wgmma reads (csrc/wgmma.cuh), with lse·log2 e and
//      D beside them.  Per tile a warpgroup forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//      (m64n64k16, both operands in shared memory), P and dS in float32
//      registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as bf16
//      register A operands (m64n{hd}k16; dK and dV stay in registers for
//      the block's life).  dSᵀ also goes to shared memory, and after one
//      barrier each warpgroup forms half the columns of the tile's dQ part,
//      dS·K over all 128 keys (MN-major operands on both sides).
//   So S and dP are formed once: 5 products where the earlier design (a
//   dK/dV kernel and a dQ kernel, both on mma.sync) formed 7.
//   dQ is summed in a fixed order across blocks, FlashAttention-3's
//   deterministic mode: each (bh, query tile) has a flag; the key blocks
//   that reach the tile add their parts highest key block first (its
//   position is top − kb, top the tile's highest reaching block).  A block
//   waits until the flag reads 8·position (each of the 8 warps of every
//   block before it has released), prefetches the parts summed so far by
//   cp.async while its S and dP products run, adds its own in registers
//   and stores the sum with plain stores into a float32 workspace (the
//   wrapper's scratch, after D and the flags; each thread's part as whole
//   16-byte chunks).  Each warp releases the tile (lane 0's release
//   increment after a __syncwarp) one tile later, after its dK product is
//   issued, so that the release's fence finds the stores done.  The
//   first adder stores, the last (key block 0) adds, scales and writes dQ
//   in bf16 itself: no third pass and no zeroing of the workspace.
//   Causal, block kb+1 starts two tiles later than kb and is two tiles
//   ahead on any tile they share, so waits are rare; not causal, every
//   block starts at tile 0 and each waits on the one before.  Blocks
//   take their (bh, key block) from a ticket counter (an integer atomic),
//   bh by bh and the highest key block first: a block only ever waits on
//   a lower ticket, held by a block that is running or done, so the
//   order cannot deadlock whatever order the card starts blocks in (a
//   wait past a second traps).
//   Rows past Sq get lse = +inf (P = 0); keys past Sk are zero-filled, so
//   their dS·K adds nothing to dQ and their dK, dV rows are not stored;
//   causal-masked entries are 0, as the forward's exp(-1e30 − m).
//   Registers at hd 128: dK, dV 64 floats each, S and dP 32 each, dQ's
//   part 32 (about 250 in all, no spill).  Shared memory at hd 128: K, V 32 KB
//   each, two stages of Q and dO 16 KB each, dSᵀ 16 KB, the prefetched
//   dQ parts 32 KB: 178 KB, one block an SM.  What bounds it on an H100
//   (PERF.md §6): the tiles' dQ parts cross L2 twice (read and written
//   back, about 2 GB at the training shape) and the two warpgroups work
//   in step, so the tensor cores idle while both form P and dS.
//   dQ's sum runs in another order than the two-kernel design's (a sum of
//   float32 parts, one a key block), so its last bits differ from it.
//   Not causal, the order is a chain (block kb waits on kb + 1 at every
//   tile), so hd 64 not causal takes the split design below; hd 128 not
//   causal (no model trains it) stays here.
//
// bfloat16, hd 256 (recurrentgemma-2b's local attention, lattn: the one
// place a window trains), on wgmma: rowdot, then one launch
// (`bwd_tma_kernel`) of two kinds of block, dK/dV blocks and dQ blocks.
// Each block is a TMA producer warpgroup (one thread issues the copies,
// its registers lowered by setmaxnreg) and two consumer warpgroups (240
// registers a thread), with mbarriers a stage for landed and freed and
// ex2.approx for exp: the forward's flash_tma_kernel
// (csrc/flash_attention.cu).  At hd 256 one warpgroup cannot hold a key
// block's dK and dV (64 keys × 512 floats: 256 a thread), and one pass
// with dQ summed across key blocks (as at hd 128) would move a float32
// dQ part of 64 × 256 through L2 twice a (key block, query tile): 128 KB
// beside the 64 KB of Q and dO tiles, with room for one stage of those
// (K, V 64 KB, Q and dO 64 KB a stage, Pᵀ, dSᵀ 16 KB, the part 64 KB: 208
// KB of 227).  So dQ has blocks of its own: 7 products where one pass
// forms 5, but no cross-block sum, no workspace and no window refusal.
//   * dkdv_block: a (bh, 64-key block); K and V stay in shared memory,
//     64-row Q and dO tiles come in two stages.  Consumer w forms Sᵀ =
//     K·Qᵀ and dPᵀ = V·dOᵀ for queries 32w..32w+31 of the tile
//     (m64n32k16, both operands K-major), P and dS in float32 registers,
//     and writes Pᵀ and dSᵀ in bf16 into swizzled [64 keys][64 queries]
//     panels; after a barrier it adds Pᵀ·dO and dSᵀ·Q (m64n128k16, A
//     K-major and B MN-major from shared memory) into dV and dK columns
//     128w..128w+127: 64 accumulators of each a thread.  S and dP are
//     formed once for both column halves.  Shared memory: K, V 32 KB
//     each, two stages of Q and dO 32 KB each, Pᵀ and dSᵀ 8 KB each: 209
//     KB.  (Tried on an H100, PERF.md §6: S on one consumer and dP on the
//     other, m64n64 each, P handed over in float32, was 35% slower; the
//     next tile's S and dP issued behind the last tile's dV and dK, with
//     Pᵀ and dSᵀ in two buffers, no faster.)
//   * dq_block: a (bh, 128-row query tile), consumer w owning 64 rows; Q
//     and dO stay in shared memory, 64-key tiles of K come in two stages
//     and of V in one (V is read by dP alone, freed before the tile's
//     dS·K); per tile S = Q·Kᵀ, dP = dO·Vᵀ (m64n64k16), P and dS in
//     float32, dQ += dS·K with dS as bf16 register A operands and K
//     MN-major (two m64n128k16 a k16 step): 128 accumulators a thread.
//     The consumers take turns to issue S and dP (named barriers), so that
//     one's P and dS run under the other's products.  Q and dO 64 KB
//     each, K 2 × 32 KB, V 32 KB: 225 KB.
//   The launch takes the dK/dV blocks first, the longest first, then the
//   dQ blocks, so that these fill the tail the dK/dV blocks leave (4–11%
//   faster than two launches).  One block an SM.  Rows past Sq and keys
//   past Sk are zero-filled by TMA; rows past Sq get lse = +inf (P = 0),
//   keys past Sk are masked.  Every sum runs in one block in a fixed
//   order: the same bits on every launch.
//
// bfloat16, hd 64, not causal (whisper-tiny's encoder self-attention and
// its cross-attention): hd 256's split design at hd 64
// (`bwd_split_kernel`): D (`rowdot64_kernel`), then one launch of dK/dV
// blocks and dQ blocks, each a TMA producer warpgroup and two consumer
// warpgroups (240 registers a thread), mbarriers a stage, ex2.approx.
// Unlike hd 256's, the consumers do not take turns to issue S and dP (2–4%
// slower with turns here, PERF.md §6).  The one-pass kernel's dQ order is
// a chain without a causal
// mask: all 12 key blocks of 1500 keys start at query tile 0, each waits
// on the one above at every tile, and every (key block, tile) moves a
// 16 KB float32 part through L2 twice (226 MB at [24, 1500, 64] against
// the function's 37 MB).  Here every sum runs inside one block: no flags,
// no workspace (the scratch is D alone), 7 products where one pass forms 5.
//   * dkdv_split_block: a (bh, 128-key block), consumer w owning 64 keys;
//     K and V stay in shared memory, 64-row Q and dO tiles come in four
//     stages, and the producer's second warp stages each tile's lse·log2 e
//     and D beside them (read by the consumers from global memory, their
//     latency cost 17%: PERF.md §6).  Per tile Sᵀ = K_w·Qᵀ and dPᵀ =
//     V_w·dOᵀ (m64n64k16, both K-major), P and dS in float32 registers,
//     then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as bf16 register A
//     operands (m64n64k16, dO and Q MN-major): 32 accumulators of each a
//     thread.
//   * dq_split_block: a (bh, 128-row block), consumer w owning 64 rows; Q
//     and dO stay in shared memory and, as bf16 register A operands, in
//     registers (ldmatrix, 5% faster than reading them from shared memory
//     at each product); 64-key tiles of K and V come in four stages; per
//     tile S = Q_w·Kᵀ, dP = dO_w·Vᵀ, dQ += dS·K (K MN-major).
//   The longer kind of block goes first (dK/dV at the encoder's shape, dQ
//   at cross-attention's 448 rows on 1500 keys), so that the other fills
//   the tail.  Shared memory 97 KB, one block an SM (registers).  Keys
//   past Sk and rows past Sq are zero-filled by TMA; rows past Sq get lse
//   = +inf (P = 0); a dQ block's ragged last key tile is masked.
//
// bfloat16, hd 16 and 32: the earlier two-kernel design on mma.sync
// m16n8k16 (csrc/ptx.cuh).  A 32- or 16-column bf16 row is 64 or 32
// bytes, under the 128-byte swizzle line the wgmma path is built on.
// Three launches:
//   * dK/dV: one block per (bh, 64-key tile), 4 warps of 16 keys; K and V
//     stay in shared memory, 32-row Q and dO tiles come through a
//     two-stage ring; per tile Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, P, dS in float32,
//     re-packed to bf16 A fragments, dV += Pᵀ·dO, dK += dSᵀ·Q;
//   * dQ: one block per (bh, 64-row query tile); K and V come in 64-key
//     tiles; S = Q·Kᵀ, dP = dO·Vᵀ, P, dS as above, dQ += dS·K;
//   tiles staged by 16-byte cp.async in the forward's XOR-swizzled layout
//   for ldmatrix.
//
// The window (key j kept for query i when i − window < j ≤ i, the
// forward's mask) is taken at hd 16, 32 and 256 and in float32: a key
// block walks only the query tiles from its first key to its last key +
// window − 1, and a query tile only the key tiles from its first row −
// window + 1 on: the band, O(S·window) work; only the tiles that cross a
// mask edge test it.  bfloat16 at hd 64 and 128 takes no window (the
// window is causal, and causal there is the one-pass path):
// its ordered dQ sum starts at each tile's highest reaching key block and
// ends at block 0, and no model trains a window at those widths, so the
// wrapper refuses a window there.
//
// float32 (the float32 model checks): float32 FMAs, no tensor cores, any
// hd of 16–256, with the window.  256 threads a block, 32 keys (dK/dV) or
// 32 query rows (dQ) a block, tiles of 32 rows in shared memory padded by
// one float a row; a thread forms 4 scores and 4 dP of a 32×32 tile (one
// key, four queries), writes P and dS to shared memory, then owns one row
// and hd/8 columns of the accumulators (32 of each at hd 256).  exp is
// expf (the accurate one): this path is the check.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "ptx.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// D = rowsum(dO ⊙ O), float32, one warp a row; the wgmma path's sync words
// zeroed on the way
// ---------------------------------------------------------------------------

template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ dO, const T* __restrict__ O,
                              float* __restrict__ D, long long rows, int hd,
                              unsigned* __restrict__ sync, long long nsync) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nsync; i += stride)
    sync[i] = 0u;
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(widen(dO[r * hd + d]), widen(O[r * hd + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) D[r] = s;
}

// D for the split route (bf16, hd 64): eight threads a row, each one
// 16-byte chunk of dO and O, summed across the eight by shuffles (the
// one-warp-a-row rowdot reads 2-byte values: 8.6 against 4.1 us at [24,
// 1500, 64], PERF.md §6)
__global__ void rowdot64_kernel(const __nv_bfloat16* __restrict__ dO,
                                const __nv_bfloat16* __restrict__ O, float* __restrict__ D,
                                long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = i >> 3;
  float s = 0.f;
  if (r < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(dO)[i];
    const uint4 b = reinterpret_cast<const uint4*>(O)[i];
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[j]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[j]));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (r < rows && (threadIdx.x & 7) == 0) D[r] = s;
}

// ---------------------------------------------------------------------------
// bfloat16, hd 16 and 32: mma.sync, a dK/dV kernel and a dQ kernel
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps
constexpr int TKB = 64;          // keys of a dK/dV block, 16 a warp
constexpr int TQB = 32;          // query rows of a tile staged by a dK/dV block
constexpr int TQ = 64;           // query rows of a dQ block, 16 a warp
constexpr int TK = 64;           // keys of a tile staged by a dQ block

// is key `key` masked from query `q`: past Sk, after q (causal), or at or
// before q - window
__device__ __forceinline__ bool masked(int key, int q, int Sk, int causal, int window) {
  return key >= Sk || (causal && key > q) || (window > 0 && key <= q - window);
}

// Element offset of the 16-byte chunk `chunk` of row `row` in a [rows][HD]
// bf16 tile, XOR-swizzled within each group of eight rows: the layout of
// csrc/flash_attention.cu.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = HD / 8;  // chunks a row
  if constexpr (C >= 8)
    return (row * C + (chunk ^ (row & 7))) * 8;
  else
    return (row * C + (chunk ^ ((row / (8 / C)) & (C - 1)))) * 8;
}

// A fragment (16 rows × 16 columns kd·16..) of a row-major [rows][HD] tile
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kd, int lane) {
  ptx::ldmatrix_x4(a, ptx::smem_addr(tile + swz<HD>(row0 + (lane & 15), kd * 2 + (lane >> 4))));
}
// B fragments of two n-tiles (n = rows n0..n0+15 of the tile, k = columns
// kd·16..+15): the tile is the product's right operand transposed (X·Tᵀ)
template <int HD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                            int kd, int lane) {
  ptx::ldmatrix_x4(b, ptx::smem_addr(tile + swz<HD>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                                    kd * 2 + ((lane >> 3) & 1))));
}
// B fragments of two n-tiles (n = columns dp·16..+15, k = rows k0..k0+15 of
// the tile): the tile is the product's right operand as it stands (X·T)
template <int HD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                            int dp, int lane) {
  ptx::ldmatrix_x4_trans(b, ptx::smem_addr(tile + swz<HD>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                          dp * 2 + (lane >> 4))));
}

// rows [r0, r0 + rows) of a [S][HD] matrix into a swizzled tile, by
// 16-byte cp.async; rows at or past S are zero-filled
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* tile, const __nv_bfloat16* src, int r0,
                                      int rows, int S, int tid, int nthreads) {
  constexpr int C = HD / 8;
  for (int i = tid; i < rows * C; i += nthreads) {
    const int r = i / C, c = i % C, row = r0 + r;
    const bool ok = row < S;
    ptx::cp_async16(ptx::smem_addr(tile + swz<HD>(r, c)),
                    src + (ok ? (long long)row * HD + c * 8 : 0), ok ? 16 : 0);
  }
}

// acc[16 rows × 8·NT columns] += A (16 rows × 16·KT, C-fragment values in
// `p`, packed to bf16) · tile rows [0, 16·KT) as they stand
template <int HD, int KT>
__device__ __forceinline__ void acc_pv(float (&acc)[HD / 8][4], const float (&p)[2 * KT][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t pa[4] = {ptx::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            ptx::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            ptx::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            ptx::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      load_b_cols<HD>(b, tile, kk * 16, dp, lane);
      ptx::mma_bf16_16816(acc[2 * dp], pa, b[0], b[1]);
      ptx::mma_bf16_16816(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// s[16 rows × 8·NT] = A rows (a warp's 16 rows of `left`) · (rows 0..8·NT
// of `right`)ᵀ
template <int HD, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* left, int row0,
                                       const __nv_bfloat16* right, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    uint32_t a[4];
    load_a<HD>(a, left, row0, kd, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_rows<HD>(b, right, np * 16, kd, lane);
      ptx::mma_bf16_16816(s[2 * np], a, b[0], b[1]);
      ptx::mma_bf16_16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// a warp's 16 rows of a float32 accumulator, times `mul`, to bf16 rows
// row0.. of `out` ([S][HD]); rows at or past S are not written
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[HD / 8][4],
                                           int row0, int S, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long long)row * HD + 2 * t);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      dst[d * 4] = ptx::pack_bf16(acc[d][2 * i] * mul, acc[d][2 * i + 1] * mul);
  }
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return (size_t)(2 * TKB + 4 * TQB) * HD * sizeof(__nv_bfloat16) + 4 * TQB * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                     const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ LSE, const float* __restrict__ Dv,
                     __nv_bfloat16* __restrict__ dK, __nv_bfloat16* __restrict__ dV, int Sq,
                     int Sk, float scale, int causal, int window) {
  constexpr int NT = TQB / 8;  // n-tiles of Sᵀ (8 queries each)
  constexpr int DT = HD / 8;   // n-tiles of dK, dV (8 columns each)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TKB][HD]
  __nv_bfloat16* Vs = Ks + TKB * HD;                                // [TKB][HD]
  __nv_bfloat16* Qs = Vs + TKB * HD;                                // [2][TQB][HD]
  __nv_bfloat16* dOs = Qs + 2 * TQB * HD;                           // [2][TQB][HD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TQB * HD);         // [2][TQB]
  float* Ds = Ls + 2 * TQB;                                         // [2][TQB]

  // the first key tiles see the most queries when causal: they go first
  const int bh = blockIdx.x, k0 = blockIdx.y * TKB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;

  // queries before k0 see none of these keys (causal), nor queries at or
  // past the last key + window (the window)
  const int qstart = causal ? k0 : 0;
  const int qend = window > 0 ? min(Sq, k0 + TKB - 1 + window) : Sq;
  const int nq = qend > qstart ? (qend - qstart + TQB - 1) / TQB : 0;

  stage<HD>(Ks, K + koff * HD, k0, TKB, Sk, tid, kTcThreads);
  stage<HD>(Vs, V + koff * HD, k0, TKB, Sk, tid, kTcThreads);
  auto load_q = [&](int j, int st) {
    const int q0 = qstart + j * TQB;
    stage<HD>(Qs + st * TQB * HD, Q + qoff * HD, q0, TQB, Sq, tid, kTcThreads);
    stage<HD>(dOs + st * TQB * HD, dO + qoff * HD, q0, TQB, Sq, tid, kTcThreads);
    for (int i = tid; i < TQB; i += kTcThreads) {
      const int q = q0 + i;
      Ls[st * TQB + i] = q < Sq ? LSE[qoff + q] * kLog2e : INFINITY;  // P = 0 past Sq
      Ds[st * TQB + i] = q < Sq ? Dv[qoff + q] : 0.f;
    }
  };
  if (nq > 0) load_q(0, 0);
  ptx::cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int key_a = k0 + warp * 16 + g;  // this lane's keys: key_a, key_a + 8

  for (int j = 0; j < nq; ++j) {
    ptx::cp_async_wait<0>();
    __syncthreads();  // tile j landed everywhere; stage (j+1)&1 is free
    if (j + 1 < nq) {
      load_q(j + 1, (j + 1) & 1);
      ptx::cp_async_commit();
    }
    const int st = j & 1, q0 = qstart + j * TQB;
    const __nv_bfloat16* qs = Qs + st * TQB * HD;
    const __nv_bfloat16* dos = dOs + st * TQB * HD;
    const float* ls = Ls + st * TQB;
    const float* ds = Ds + st * TQB;

    float s[NT][4], dp[NT][4];
    scores<HD, NT>(s, Ks, warp * 16, qs, lane);      // Sᵀ = K Qᵀ
    scores<HD, NT>(dp, Vs, warp * 16, dos, lane);    // dPᵀ = V dOᵀ
    // the tile crosses the causal diagonal or the window's far edge
    const bool edge = (causal && k0 + TKB - 1 > q0) ||
                      (window > 0 && q0 + TQB - 1 - window >= k0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        float p = exp2f(s[n][e] * scale_log2 - ls[qi]);
        if (edge && masked(key_a + (e >> 1) * 8, q0 + qi, Sk, causal, window)) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ds[qi]);
      }
    }
    acc_pv<HD, TQB / 16>(dv, s, dos, lane);   // dV += Pᵀ dO
    acc_pv<HD, TQB / 16>(dk, dp, qs, lane);   // dK += dSᵀ Q
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block (nq = 0 issues K, V only)

  store_rows<HD>(dK + koff * HD, dk, k0 + warp * 16, Sk, scale, lane);
  store_rows<HD>(dV + koff * HD, dv, k0 + warp * 16, Sk, 1.f, lane);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * TQ + 4 * TK) * HD * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    dq_bf16_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ LSE, const float* __restrict__ Dv,
                   __nv_bfloat16* __restrict__ dQ, int Sq, int Sk, float scale, int causal,
                   int window) {
  constexpr int NT = TK / 8;  // n-tiles of S (8 keys each)
  constexpr int DT = HD / 8;  // n-tiles of dQ
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][HD]
  __nv_bfloat16* dOs = Qs + TQ * HD;                                // [TQ][HD]
  __nv_bfloat16* Ks = dOs + TQ * HD;                                // [2][TK][HD]
  __nv_bfloat16* Vs = Ks + 2 * TK * HD;                             // [2][TK][HD]

  // the longest causal rows first, so that short blocks fill the tail
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;
  // the key tiles the block's rows reach: from the first row's window
  // (the tile of key q0 - window + 1) to the last row's diagonal (causal)
  const int kend = causal ? min(Sk, q0 + TQ) : Sk;
  const int ntiles = (kend + TK - 1) / TK;
  const int jstart = window > 0 ? max(0, q0 - window + 1) / TK : 0;

  stage<HD>(Qs, Q + qoff * HD, q0, TQ, Sq, tid, kTcThreads);
  stage<HD>(dOs, dO + qoff * HD, q0, TQ, Sq, tid, kTcThreads);
  auto load_kv = [&](int j, int st) {
    stage<HD>(Ks + st * TK * HD, K + koff * HD, j * TK, TK, Sk, tid, kTcThreads);
    stage<HD>(Vs + st * TK * HD, V + koff * HD, j * TK, TK, Sk, tid, kTcThreads);
  };
  if (jstart < ntiles) load_kv(jstart, 0);
  ptx::cp_async_commit();

  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8
  float lse2[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    lse2[i] = row < Sq ? LSE[qoff + row] * kLog2e : INFINITY;  // P = 0 past Sq
    drow[i] = row < Sq ? Dv[qoff + row] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int j = jstart; j < ntiles; ++j) {
    ptx::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < ntiles) {
      load_kv(j + 1, (j + 1 - jstart) & 1);
      ptx::cp_async_commit();
    }
    const int st = (j - jstart) & 1;
    const __nv_bfloat16* ks = Ks + st * TK * HD;
    const __nv_bfloat16* vs = Vs + st * TK * HD;
    float s[NT][4], dp[NT][4];
    scores<HD, NT>(s, Qs, warp * 16, ks, lane);    // S = Q Kᵀ
    scores<HD, NT>(dp, dOs, warp * 16, vs, lane);  // dP = dO Vᵀ
    const int k0 = j * TK;
    // the tile reaches past Sk, crosses the diagonal or the window's edge
    const bool edge = k0 + TK > Sk || (causal && k0 + TK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + TQ - 1 - window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * scale_log2 - lse2[e >> 1]);
        if (edge && masked(k0 + n * 8 + 2 * t + (e & 1), row_a + (e >> 1) * 8, Sk, causal,
                           window))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - drow[e >> 1]);
      }
    }
    acc_pv<HD, TK / 16>(dq, dp, ks, lane);  // dQ += dS K
  }
  store_rows<HD>(dQ + qoff * HD, dq, q0 + warp * 16, Sq, scale, lane);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* D, void* dq, void* dk, void* dv, int BH, int Sq, int Sk, float scale,
                int causal, int window, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t b1 = dkdv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(dkdv_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (e != cudaSuccess) return (int)e;
  dkdv_bf16_kernel<HD><<<dim3(BH, (Sk + TKB - 1) / TKB), kTcThreads, b1, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, D, (bf*)dk, (bf*)dv, Sq,
      Sk, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t b2 = dq_smem_bytes<HD>();
  e = cudaFuncSetAttribute(dq_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)b2);
  if (e != cudaSuccess) return (int)e;
  dq_bf16_kernel<HD><<<dim3(BH, (Sq + TQ - 1) / TQ), kTcThreads, b2, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, D, (bf*)dq, Sq, Sk, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, hd 64 and 128: wgmma, one pass over the keys
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int WQ = 64;           // query rows of a tile
constexpr int WK = 128;          // keys of a block, 64 a warpgroup

// floats of the scratch before the dQ workspace: D [BH, Sq], then the sync
// words (the ticket counter, one flag a (bh, query tile)), padded to 16
// bytes.  The workspace holds a float32 part of dQ a (bh, query tile) in
// the threads' accumulator order: float4 k of thread tid at (k·256 + tid)·4,
// so that each thread moves whole 16-byte chunks and a warp 512 bytes in a
// row
inline long long wg_sync_words(int BH, int Sq) { return 1 + (long long)BH * ((Sq + WQ - 1) / WQ); }
inline long long wg_acc_offset(int BH, int Sq) {
  return ((long long)BH * Sq + wg_sync_words(BH, Sq) + 3) / 4 * 4;
}

template <int HD>
constexpr size_t wg_smem_bytes() {
  // 1024 of slack to align the tiles; K, V; two stages of Q and dO; dSᵀ;
  // the dQ parts read from the workspace; two stages of lse·log2 e and D;
  // the ticket
  return 1024 + (size_t)(2 * WK * HD + 4 * WQ * HD + WK * WQ) * 2 + (size_t)WQ * HD * 4 +
         4 * WQ * 4 + 16;
}

// rows [r0, r0 + R) of a [S][HD] bf16 matrix into an R-row swizzled tile
// at shared address `tile`, by 16-byte cp.async; rows at or past S are
// zero-filled
template <int HD, int R>
__device__ __forceinline__ void stage_sw(uint32_t tile, const __nv_bfloat16* src, int r0, int S,
                                         int tid) {
  constexpr int C = HD / 8;
  static_assert(R * C % kWgThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int k = 0; k < R * C / kWgThreads; ++k) {
    const int i = tid + k * kWgThreads, r = i / C, c = i % C, row = r0 + r;
    const bool ok = row < S;
    ptx::cp_async16(tile + wg::sw128<R>(r, c), src + (ok ? (long long)row * HD + c * 8 : 0),
                    ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                     const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ LSE, const float* __restrict__ Dv,
                     __nv_bfloat16* __restrict__ dQ, __nv_bfloat16* __restrict__ dK,
                     __nv_bfloat16* __restrict__ dV, float* __restrict__ acc,
                     unsigned* __restrict__ sync, int Sq, int Sk, float scale, int causal) {
  static_assert(HD == 64 || HD == 128, "the wgmma path takes hd 64 and 128");
  constexpr int NQ = HD / 2;      // dQ columns of a warpgroup
  constexpr int TILE = WQ * HD * 2;  // bytes of a Q or dO tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sK = ptx::smem_addr(base);  // [WK][HD]
  const uint32_t sV = sK + WK * HD * 2;      // [WK][HD]
  const uint32_t sQ = sV + WK * HD * 2;      // [2][WQ][HD]
  const uint32_t sO = sQ + 2 * TILE;         // [2][WQ][HD]
  const uint32_t sS = sO + 2 * TILE;         // dSᵀ [WK][WQ]
  unsigned char* dSp = base + (sS - sK);
  float4* accS = reinterpret_cast<float4*>(dSp + WK * WQ * 2);  // [NQ / 8][256]
  const uint32_t sA = sS + WK * WQ * 2;
  float* Ls = reinterpret_cast<float*>(accS + WQ * HD / 4);  // [2][WQ] lse·log2 e
  float* Ds = Ls + 2 * WQ;                                   // [2][WQ]
  int* slot = reinterpret_cast<int*>(Ds + 2 * WQ);

  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkb = (Sk + WK - 1) / WK, nq = (Sq + WQ - 1) / WQ;
  // the ticket: bh by bh, the highest key block first
  if (tid == 0) *slot = (int)atomicAdd(sync, 1u);
  __syncthreads();
  const int ticket = *slot;
  const int bh = ticket / nkb, kb = nkb - 1 - ticket % nkb, k0 = kb * WK;
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;
  unsigned* flags = sync + 1 + (long long)bh * nq;
  const float scale_log2 = scale * kLog2e;
  const int jstart = causal ? k0 / WQ : 0;  // queries before k0 see none of these keys

  stage_sw<HD, WK>(sK, K + koff * HD, k0, Sk, tid);
  stage_sw<HD, WK>(sV, V + koff * HD, k0, Sk, tid);
  auto load = [&](int j, int st) {
    const int q0 = j * WQ;
    stage_sw<HD, WQ>(sQ + st * TILE, Q + qoff * HD, q0, Sq, tid);
    stage_sw<HD, WQ>(sO + st * TILE, dO + qoff * HD, q0, Sq, tid);
    if (tid < WQ) {
      const int q = q0 + tid;
      Ls[st * WQ + tid] = q < Sq ? LSE[qoff + q] * kLog2e : INFINITY;  // P = 0 past Sq
      Ds[st * WQ + tid] = q < Sq ? Dv[qoff + q] : 0.f;
    }
  };
  if (jstart < nq) load(jstart, 0);
  ptx::cp_async_commit();

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const int krow = 64 * w + 16 * warp + g;  // this thread's keys: k0 + krow, k0 + krow + 8
  int pending = -1;  // the tile whose dQ part this block stored and has not released

  for (int j = jstart; j < nq; ++j) {
    ptx::cp_async_wait<0>();
    wg::fence_async_shared();
    __syncthreads();  // tile j landed everywhere; the other stage and dSᵀ are free
    if (j + 1 < nq) load(j + 1, (j + 1 - jstart) & 1);
    ptx::cp_async_commit();
    const int st = (j - jstart) & 1, q0 = j * WQ;
    const uint32_t q_s = sQ + st * TILE, o_s = sO + st * TILE;
    // the key blocks that add to this tile's dQ before this one: the
    // highest key block reaching the tile adds first
    const int pos = (causal ? min(nkb - 1, q0 / WK) : nkb - 1) - kb;

    // Sᵀ = K Qᵀ, then dPᵀ = V dOᵀ, over the warpgroup's 64 keys and the
    // tile's 64 queries: two commit groups, so that P is formed while dPᵀ
    // is still on the tensor cores
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::hold(s);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      const uint32_t ko = (kd >> 2) * WK * 128 + 64 * w * 128 + (kd & 3) * 32;
      const uint32_t qo = (kd >> 2) * WQ * 128 + (kd & 3) * 32;
      wg::mma_m64n64k16_ss<0, 0>(s, wg::desc(sK + ko, 16, 1024), wg::desc(q_s + qo, 16, 1024), 1);
    }
    wg::commit();
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      const uint32_t ko = (kd >> 2) * WK * 128 + 64 * w * 128 + (kd & 3) * 32;
      const uint32_t qo = (kd >> 2) * WQ * 128 + (kd & 3) * 32;
      wg::mma_m64n64k16_ss<0, 0>(dp, wg::desc(sV + ko, 16, 1024), wg::desc(o_s + qo, 16, 1024),
                                 1);
    }
    wg::commit();

    // while they run: wait for this tile's turn and prefetch the parts of
    // dQ summed so far
    float* part = acc + ((long long)bh * nq + j) * (WQ * HD);
    if (pos > 0) {
      // the blocks waited on hold lower tickets, so they run or are done;
      // a wait past a second is a fault: trap rather than hang the card
      for (long long spins = 0; wg::ld_acquire(flags + j) != 8u * pos; ++spins) {
        if (spins > (1ll << 26)) __trap();
        __nanosleep(20);
      }
#pragma unroll
      for (int k = 0; k < NQ / 8; ++k)
        ptx::cp_async16(sA + (k * kWgThreads + tid) * 16, part + (k * kWgThreads + tid) * 4, 16);
    }
    ptx::cp_async_commit();

    // Pᵀ = exp(Sᵀ·scale − lse), masked; its bf16 A fragments (k16 step kk
    // = queries 16kk..16kk+15), and dV += Pᵀ dO (B MN-major: the tile's
    // rows are the k) while dPᵀ finishes
    wg::wait<1>();
    wg::hold(s);
    const bool edge = causal && k0 + 64 * w + 63 > q0;
    const float* ls = Ls + st * WQ;
    const float* ds = Ds + st * WQ;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e, qi = 8 * jj + 2 * t + (e & 1);
        float p = exp2f(s[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (edge && k0 + krow + 8 * (e >> 1) > q0 + qi) p = 0.f;
        s[i] = p;
      }
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = ptx::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wg::hold(pa[kk]);
    }
    wg::hold(dv);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = wg::desc(o_s + kk * 2048, WQ * 128, 1024);
      if constexpr (HD == 128)
        wg::mma_m64n128k16_rs<1>(dv, pa[kk], bo, 1);
      else
        wg::mma_m64n64k16_rs<1>(dv, pa[kk], bo, 1);
    }
    wg::commit();

    // dSᵀ = Pᵀ ⊙ (dPᵀ − D): bf16 A fragments, also to shared memory ([WK
    // keys][WQ queries], one swizzled panel); dK += dSᵀ Q
    wg::wait<1>();
    wg::hold(dp);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        dp[i] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sa[kk][r] = ptx::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        const int row = krow + 8 * (r & 1), jj = 2 * kk + (r >> 1);
        *reinterpret_cast<uint32_t*>(dSp + row * 128 + ((jj ^ g) << 4) + 4 * t) = sa[kk][r];
      }
      wg::hold(sa[kk]);
    }
    wg::hold(dk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = wg::desc(q_s + kk * 2048, WQ * 128, 1024);
      if constexpr (HD == 128)
        wg::mma_m64n128k16_rs<1>(dk, sa[kk], bq, 1);
      else
        wg::mma_m64n64k16_rs<1>(dk, sa[kk], bq, 1);
    }
    wg::commit();

    // release the last tile's dQ part, long stored by now, so that lane
    // 0's release waits on nothing (each warp, once its lanes' stores are
    // ordered before lane 0's release)
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) wg::add_release(flags + pending, 1u);
      pending = -1;
    }

    // the tile's dQ part, dS K over the block's 128 keys: this warpgroup's
    // NQ columns (A = dS from dSᵀ, MN-major; B = K, MN-major)
    wg::fence_async_shared();
    __syncthreads();  // both warpgroups' dSᵀ are in shared memory
    float dq[NQ / 2];
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) dq[i] = 0.f;
    wg::hold(dq);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint64_t da = wg::desc(sS + kk * 2048, WK * 128, 1024);
      const uint64_t db = wg::desc(sK + (HD == 128 ? w * WK * 128 : w * 64) + kk * 2048,
                                   WK * 128, 1024);
      if constexpr (HD == 128)
        wg::mma_m64n64k16_ss<1, 1>(dq, da, db, 1);
      else
        wg::mma_m64n32k16_ss<1, 1>(dq, da, db, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::hold(dq);
    wg::hold(dv);
    wg::hold(dk);

    // the ordered add: highest key block first; key block 0 is last and
    // writes dQ = scale·Σ in bf16
    ptx::cp_async_wait<0>();  // this thread's prefetched parts are in
#pragma unroll
    for (int k = 0; k < NQ / 8; ++k) {
      float4 v = make_float4(dq[4 * k], dq[4 * k + 1], dq[4 * k + 2], dq[4 * k + 3]);
      if (pos > 0) {
        const float4 a = accS[k * kWgThreads + tid];
        v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
      }
      if (kb == 0) {
        // v holds (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1)
        const int r = q0 + 16 * warp + g, c = w * NQ + 8 * k + 2 * t;
        if (r < Sq)
          *reinterpret_cast<uint32_t*>(dQ + (qoff + r) * HD + c) =
              ptx::pack_bf16(v.x * scale, v.y * scale);
        if (r + 8 < Sq)
          *reinterpret_cast<uint32_t*>(dQ + (qoff + r + 8) * HD + c) =
              ptx::pack_bf16(v.z * scale, v.w * scale);
      } else {
        __stcg(reinterpret_cast<float4*>(part) + k * kWgThreads + tid, v);
      }
    }
    if (kb != 0) pending = j;
  }
  if (pending >= 0) {
    __syncwarp();
    if (lane == 0) wg::add_release(flags + pending, 1u);
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block

  // dK = scale·Σ dSᵀQ, dV = Σ PᵀdO: rows k0 + krow (+8), bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + krow + 8 * h;
    if (row >= Sk) continue;
    uint32_t* kd = reinterpret_cast<uint32_t*>(dK + (koff + row) * HD + 2 * t);
    uint32_t* vd = reinterpret_cast<uint32_t*>(dV + (koff + row) * HD + 2 * t);
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      kd[jj * 4] = ptx::pack_bf16(dk[4 * jj + 2 * h] * scale, dk[4 * jj + 2 * h + 1] * scale);
      vd[jj * 4] = ptx::pack_bf16(dv[4 * jj + 2 * h], dv[4 * jj + 2 * h + 1]);
    }
  }
}

template <int HD>
int launch_bf16_wg(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, float* d, void* dq, void* dk, void* dv, int BH, int Sq,
                   int Sk, float scale, int causal, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t bytes = wg_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(bwd_wgmma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)BH * ((Sk + WK - 1) / WK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unsigned* sync = reinterpret_cast<unsigned*>(d + (long long)BH * Sq);
  float* acc = d + wg_acc_offset(BH, Sq);
  bwd_wgmma_kernel<HD><<<(unsigned)blocks, kWgThreads, bytes, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, d, (bf*)dq, (bf*)dk,
      (bf*)dv, acc, sync, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, hd 256: wgmma, a dK/dV kernel and a dQ kernel fed by TMA
// ---------------------------------------------------------------------------

constexpr int kHd = 256;
constexpr int kTmaWG = 2;                          // consumer warpgroups
constexpr int kTmaThreads = (kTmaWG + 1) * 128;    // and a producer warpgroup
constexpr int kProdRegs = 24, kConsRegs = 240;     // registers a thread (setmaxnreg)
constexpr int HK = 64;     // keys of a dK/dV block, and of a dQ block's key tile
constexpr int HQ = 64;     // query rows of a dK/dV block's tile, of a dQ consumer
constexpr int HQS = 2;     // stages of a dK/dV block's Q and dO tiles
constexpr int HKS = 2;     // stages of a dQ block's K tiles (one of V)
// named barriers: 1, the dK/dV consumers' Pᵀ / dSᵀ free; 2, written; 3 +
// w, warpgroup w's turn to issue its S and dP (dQ kernel); 5 + w, its
// epilogue
constexpr int kFreeBar = 1, kReadyBar = 2, kSchedBar = 3, kEpiBar = 5;
constexpr uint32_t kTileBytes = 64 * kHd * 2;  // a 64-row bf16 tile of 256 columns

constexpr size_t dkdv_tma_smem_bytes() {
  // 1024 of slack to align the tiles; K, V; the Q and dO stages; Pᵀ, dSᵀ;
  // the mbarriers (K and V's, a full and an empty one a stage)
  return 1024 + (2 + 2 * HQS) * kTileBytes + 2 * HK * HQ * 2 + 8 * (1 + 2 * HQS);
}
constexpr size_t dq_tma_smem_bytes() {
  // 1024 of slack; Q and dO of 128 rows; the K stages and V's one; the
  // mbarriers (Q and dO's, a full and an empty one a K stage and V's)
  return 1024 + (4 + HKS + 1) * kTileBytes + 8 * (1 + 2 * HKS + 2);
}

// a stage read by this warpgroup's finished products, freed by each warp
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(bar);
}

// One block of 64 keys (key block kb) of a (batch, head) bh: the keys'
// dK and dV over the query tiles they reach.  Consumer warpgroup w
// forms Sᵀ and dPᵀ for queries 32w..32w+31 of each 64-row tile, P and dS
// in float32, and writes Pᵀ and dSᵀ in bf16 to shared memory; after a
// barrier it adds Pᵀ·dO and dSᵀ·Q into dV and dK columns 128w..128w+127
// (64 accumulators of each a thread).
__device__ __forceinline__ void dkdv_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                           const CUtensorMap* tv, const CUtensorMap* tdo,
                                           const float* __restrict__ LSE,
                                           const float* __restrict__ Dv,
                                           __nv_bfloat16* __restrict__ dK,
                                           __nv_bfloat16* __restrict__ dV, int Sq, int Sk,
                                           float scale, int causal, int window, int bh, int kb,
                                           unsigned char* smem_raw) {
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sK = raw + ((1024 - (raw & 1023)) & 1023);  // [HK][256]
  const uint32_t sV = sK + kTileBytes;                         // [HK][256]
  const uint32_t sQ = sV + kTileBytes;                         // [HQS][HQ][256]
  const uint32_t sO = sQ + HQS * kTileBytes;                   // [HQS][HQ][256]
  const uint32_t sP = sO + HQS * kTileBytes;                   // Pᵀ [HK keys][HQ queries]
  const uint32_t sS = sP + HK * HQ * 2;                        // dSᵀ [HK][HQ]
  const uint32_t bKV = sS + HK * HQ * 2;                       // K and V landed
  const uint32_t fullQ = bKV + 8, emptyQ = fullQ + 8 * HQS;    // a stage landed / freed
  unsigned char* const base = smem_raw + (sK - raw);

  const int k0 = kb * HK;
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // the query tiles that reach these keys: from k0's (causal) to the one
  // of the last key + window − 1 (the window)
  const int jstart = causal ? k0 / HQ : 0;
  const int qend = window > 0 ? min(Sq, k0 + HK - 1 + window) : Sq;
  const int nt = max(0, (qend + HQ - 1) / HQ - jstart);

  if (tid == 0) {
    wg::mbar_init(bKV, 1);
#pragma unroll
    for (int i = 0; i < HQS; ++i) {
      wg::mbar_init(fullQ + 8 * i, 1);
      wg::mbar_init(emptyQ + 8 * i, kTmaWG * 4);  // each consumer warp's release
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (w == kTmaWG) {
    // the producer: each box one 64-column panel
    wg::reg_dealloc<kProdRegs>();
    if (warp == 0 && lane == 0) {
      wg::mbar_expect(bKV, 2 * kTileBytes);
#pragma unroll
      for (int pn = 0; pn < kHd / 64; ++pn) {
        wg::tma_load_3d(sK + pn * HK * 128, tk, bKV, pn * 64, k0, bh);
        wg::tma_load_3d(sV + pn * HK * 128, tv, bKV, pn * 64, k0, bh);
      }
      for (int i = 0; i < nt; ++i) {
        const int st = i % HQS, q0 = (jstart + i) * HQ;
        if (i >= HQS) wg::mbar_wait(emptyQ + 8 * st, (i / HQS - 1) & 1);
        wg::mbar_expect(fullQ + 8 * st, 2 * kTileBytes);
#pragma unroll
        for (int pn = 0; pn < kHd / 64; ++pn) {
          wg::tma_load_3d(sQ + st * kTileBytes + pn * HQ * 128, tq, fullQ + 8 * st, pn * 64,
                          q0, bh);
          wg::tma_load_3d(sO + st * kTileBytes + pn * HQ * 128, tdo, fullQ + 8 * st, pn * 64,
                          q0, bh);
        }
      }
    }
    return;
  }

  wg::reg_alloc<kConsRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp + g;  // this thread's keys: k0 + kr, k0 + kr + 8
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;
  const float scale_log2 = scale * kLog2e;
  float dk[64], dv[64], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  wg::mbar_wait(bKV, 0);

  for (int i = 0; i < nt; ++i) {
    const int st = i % HQS, qw = (jstart + i) * HQ + 32 * w;  // this warpgroup's first query
    const uint32_t q_s = sQ + st * kTileBytes, o_s = sO + st * kTileBytes;
    // lse·log2 e and D of this thread's 8 queries, qw + 8jj + 2t + e
    float l2[8], dd[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int q = qw + 8 * (c >> 1) + 2 * t + (c & 1);
      l2[c] = q < Sq ? LSE[qoff + q] * kLog2e : INFINITY;  // P = 0 past Sq
      dd[c] = q < Sq ? Dv[qoff + q] : 0.f;
    }
    wg::mbar_wait(fullQ + 8 * st, (i / HQS) & 1);

    // Sᵀ = K Q_wᵀ, then dPᵀ = V dO_wᵀ: the block's 64 keys by the
    // warpgroup's 32 queries, both operands K-major.  Every product of the
    // last tile is done: with a wgmma in flight across the loop's back
    // edge ptxas serialises them (its C7515 note), 9% slower
    wg::hold(s);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < kHd / 16; ++kd) {
      const uint32_t ko = (kd >> 2) * HK * 128 + (kd & 3) * 32;
      const uint32_t qo = (kd >> 2) * HQ * 128 + 32 * w * 128 + (kd & 3) * 32;
      wg::mma_m64n32k16_ss<0, 0>(s, wg::desc(sK + ko, 16, 1024), wg::desc(q_s + qo, 16, 1024),
                                 kd > 0);
    }
    wg::commit();
#pragma unroll
    for (int kd = 0; kd < kHd / 16; ++kd) {
      const uint32_t ko = (kd >> 2) * HK * 128 + (kd & 3) * 32;
      const uint32_t qo = (kd >> 2) * HQ * 128 + 32 * w * 128 + (kd & 3) * 32;
      wg::mma_m64n32k16_ss<0, 0>(dp, wg::desc(sV + ko, 16, 1024), wg::desc(o_s + qo, 16, 1024),
                                 kd > 0);
    }
    wg::commit();

    // the last tile's stage is free.  Released here, once this tile's S
    // and dP are done: released right after the last tile's own products
    // (the next copy then runs beside S and dP) measured 5% slower
    wg::wait<0>();
    wg::hold(s);
    wg::hold(dp);
    if (i > 0) release(emptyQ + 8 * ((i - 1) % HQS), lane);

    // Pᵀ = exp(Sᵀ·scale − lse), 0 where masked: the tile crosses the
    // causal diagonal, the window's far edge, or Sk
    const bool edge = (causal && k0 + HK - 1 > qw) ||
                      (window > 0 && k0 <= qw + 31 - window) || k0 + HK > Sk;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int lc = 2 * (c >> 2) + (c & 1);  // this entry's query, of the 8
      float p = ptx::ex2(fmaf(s[c], scale_log2, -l2[lc]));
      if (edge && masked(k0 + kr + 8 * ((c >> 1) & 1), qw + 8 * (c >> 2) + 2 * t + (c & 1), Sk,
                         causal, window))
        p = 0.f;
      s[c] = p;
    }
    // dSᵀ = Pᵀ ⊙ (dPᵀ − D)
#pragma unroll
    for (int c = 0; c < 16; ++c) dp[c] = s[c] * (dp[c] - dd[2 * (c >> 2) + (c & 1)]);

    // both warpgroups' last dV and dK products are done with Pᵀ and dSᵀ;
    // this warpgroup's 32 query columns of each, bf16, into the swizzled
    // [64 keys][64 queries] panels
    wg::bar_sync(kFreeBar, kTmaWG * 128);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = kr + 8 * h;
        const uint32_t off = row * 128 + (((4 * w + jj) ^ (row & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(base + (sP - sK) + off) =
            ptx::pack_bf16(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(base + (sS - sK) + off) =
            ptx::pack_bf16(dp[4 * jj + 2 * h], dp[4 * jj + 2 * h + 1]);
      }
    wg::fence_async_shared();
    wg::bar_sync(kReadyBar, kTmaWG * 128);

    // dV += Pᵀ dO and dK += dSᵀ Q over the tile's 64 queries, columns
    // 128w.. (A K-major, B MN-major: the tile's rows are the k)
    wg::hold(dk);
    wg::hold(dv);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HQ / 16; ++kk)
      wg::mma_m64n128k16_ss<0, 1>(dv, wg::desc(sP + kk * 32, 16, 1024),
                                  wg::desc(o_s + 2 * w * HQ * 128 + kk * 2048, HQ * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < HQ / 16; ++kk)
      wg::mma_m64n128k16_ss<0, 1>(dk, wg::desc(sS + kk * 32, 16, 1024),
                                  wg::desc(q_s + 2 * w * HQ * 128 + kk * 2048, HQ * 128, 1024), 1);
    wg::commit();
    wg::wait<0>();
    wg::hold(dk);
    wg::hold(dv);
  }

  // dK = scale·Σ dSᵀQ, dV = Σ PᵀdO: rows k0 + kr (+8), columns 128w + 8jj
  // + 2t, bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + kr + 8 * h;
    if (row >= Sk) continue;
    uint32_t* kd = reinterpret_cast<uint32_t*>(dK + (koff + row) * kHd + 128 * w + 2 * t);
    uint32_t* vd = reinterpret_cast<uint32_t*>(dV + (koff + row) * kHd + 128 * w + 2 * t);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      kd[jj * 4] = ptx::pack_bf16(dk[4 * jj + 2 * h] * scale, dk[4 * jj + 2 * h + 1] * scale);
      vd[jj * 4] = ptx::pack_bf16(dv[4 * jj + 2 * h], dv[4 * jj + 2 * h + 1]);
    }
  }
}

// One block of 128 query rows (row block qb) of a (batch, head) bh: dQ
// over the key tiles the rows reach.
// The forward's flash_tma_kernel with dQ in place of O: consumer
// warpgroup w owns rows 64w..64w+63 (Q and dO resident), and per 64-key
// tile forms S = Q Kᵀ and dP = dO Vᵀ, P and dS in float32, and adds dS·K
// (dS as bf16 register A operands, K MN-major) into dQ, 128 accumulators
// a thread; the two take turns to issue S and dP (named barriers 3 + w),
// so that one's P and dS run under the other's products.
__device__ __forceinline__ void dq_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const float* __restrict__ LSE,
                                         const float* __restrict__ Dv,
                                         __nv_bfloat16* __restrict__ dQ, int Sq, int Sk,
                                         float scale, int causal, int window, int bh, int qb,
                                         unsigned char* smem_raw) {
  constexpr int BQ = kTmaWG * HQ;
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [BQ][256]
  const uint32_t sO = sQ + 2 * kTileBytes;                     // [BQ][256]
  const uint32_t sK = sO + 2 * kTileBytes;                     // [HKS][HK][256]
  const uint32_t sV = sK + HKS * kTileBytes;                   // [HK][256]
  const uint32_t bQ = sV + kTileBytes;                         // Q and dO landed
  const uint32_t fullK = bQ + 8, emptyK = fullK + 8 * HKS;     // a stage landed / freed
  const uint32_t fullV = emptyK + 8 * HKS, emptyV = fullV + 8;
  unsigned char* const qtile = smem_raw + (sQ - raw);

  const int q0 = qb * BQ;
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // the key tiles of the block: from its first row's window to its last
  // row's diagonal (causal); at least one (Sk ≥ 1)
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  const int tile0 = min(window > 0 ? max(0, q0 - window + 1) : 0, kend - 1) / HK;
  const int nt = (kend + HK - 1) / HK - tile0;

  if (tid == 0) {
    wg::mbar_init(bQ, 1);
#pragma unroll
    for (int i = 0; i < HKS; ++i) {
      wg::mbar_init(fullK + 8 * i, 1);
      wg::mbar_init(emptyK + 8 * i, kTmaWG * 4);
    }
    wg::mbar_init(fullV, 1);
    wg::mbar_init(emptyV, kTmaWG * 4);
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (w == kTmaWG) {
    wg::reg_dealloc<kProdRegs>();
    if (warp == 0 && lane == 0) {
      wg::mbar_expect(bQ, 4 * kTileBytes);
#pragma unroll
      for (int pn = 0; pn < kHd / 64; ++pn) {
        wg::tma_load_3d(sQ + pn * BQ * 128, tq, bQ, pn * 64, q0, bh);
        wg::tma_load_3d(sO + pn * BQ * 128, tdo, bQ, pn * 64, q0, bh);
      }
      for (int i = 0; i < nt; ++i) {
        const int key = (tile0 + i) * HK, ks = i % HKS;
        if (i >= HKS) wg::mbar_wait(emptyK + 8 * ks, (i / HKS - 1) & 1);
        wg::mbar_expect(fullK + 8 * ks, kTileBytes);
#pragma unroll
        for (int pn = 0; pn < kHd / 64; ++pn)
          wg::tma_load_3d(sK + ks * kTileBytes + pn * HK * 128, tk, fullK + 8 * ks, pn * 64, key,
                          bh);
        if (i >= 1) wg::mbar_wait(emptyV, (i - 1) & 1);
        wg::mbar_expect(fullV, kTileBytes);
#pragma unroll
        for (int pn = 0; pn < kHd / 64; ++pn)
          wg::tma_load_3d(sV + pn * HK * 128, tv, fullV, pn * 64, key, bh);
      }
    }
    return;
  }

  wg::reg_alloc<kConsRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + HQ * w;  // this warpgroup's first row
  const int row0 = qw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const long long qoff = (long long)bh * Sq;
  const float scale_log2 = scale * kLog2e;
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    l2[h] = r < Sq ? LSE[qoff + r] * kLog2e : INFINITY;  // P = 0 past Sq
    dd[h] = r < Sq ? Dv[qoff + r] : 0.f;
  }
  float dq[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[h][i] = 0.f;
  const uint32_t qa = sQ + HQ * w * 128, oa = sO + HQ * w * 128;  // this warpgroup's rows

  wg::mbar_wait(bQ, 0);
  if (w == 1) wg::bar_arrive(kSchedBar, kTmaWG * 128);  // the first turn is warpgroup 0's
  for (int i = 0; i < nt; ++i) {
    const int k0 = (tile0 + i) * HK, ks = i % HKS;
    const uint32_t kt = sK + ks * kTileBytes;
    wg::mbar_wait(fullK + 8 * ks, (i / HKS) & 1);
    wg::mbar_wait(fullV, i & 1);
    // S = Q_w Kᵀ, then dP = dO_w Vᵀ, in this warpgroup's turn (warpgroup
    // 1's last turn is not waited on, so it does not announce it)
    float s[32], dp[32];
    wg::bar_sync(kSchedBar + w, kTmaWG * 128);
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < kHd / 16; ++kd) {
      const uint32_t a = (kd >> 2) * BQ * 128 + (kd & 3) * 32;
      const uint32_t b = (kd >> 2) * HK * 128 + (kd & 3) * 32;
      wg::mma_m64n64k16_ss<0, 0>(s, wg::desc(qa + a, 16, 1024), wg::desc(kt + b, 16, 1024),
                                 kd > 0);
    }
    wg::commit();
#pragma unroll
    for (int kd = 0; kd < kHd / 16; ++kd) {
      const uint32_t a = (kd >> 2) * BQ * 128 + (kd & 3) * 32;
      const uint32_t b = (kd >> 2) * HK * 128 + (kd & 3) * 32;
      wg::mma_m64n64k16_ss<0, 0>(dp, wg::desc(oa + a, 16, 1024), wg::desc(sV + b, 16, 1024),
                                 kd > 0);
    }
    wg::commit();
    if (w == 0 || i + 1 < nt) wg::bar_arrive(kSchedBar + (w ^ 1), kTmaWG * 128);

    // P = exp(S·scale − lse), 0 where masked: the tile crosses the causal
    // diagonal, the window's far edge, or Sk.  The last tile's dQ product
    // was done before S (one queue): its K stage is free
    wg::wait<1>();
    wg::hold(s);
    wg::hold(dq[0]);
    wg::hold(dq[1]);
    if (i > 0) release(emptyK + 8 * ((i - 1) % HKS), lane);
    const bool edge = (causal && k0 + HK - 1 > qw) ||
                      (window > 0 && k0 <= qw + HQ - 1 - window) || k0 + HK > Sk;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float p = ptx::ex2(fmaf(s[c], scale_log2, -l2[(c >> 1) & 1]));
      if (edge && masked(k0 + 8 * (c >> 2) + 2 * t + (c & 1), row0 + 8 * ((c >> 1) & 1), Sk,
                         causal, window))
        p = 0.f;
      s[c] = p;
    }
    wg::wait<0>();
    wg::hold(dp);
    release(emptyV, lane);  // V is read by dP alone
    // dS = P ⊙ (dP − D), as bf16 A fragments (k16 step kk: keys 16kk..)
    uint32_t da[HK / 16][4];
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * kk + 2 * r;
        const float dl = dd[(c >> 1) & 1];
        da[kk][r] = ptx::pack_bf16(s[c] * (dp[c] - dl), s[c + 1] * (dp[c + 1] - dl));
      }
      wg::hold(da[kk]);
    }
    // dQ += dS K: K MN-major (the tile's rows are the k), columns 0..127
    // and 128..255 as two m64n128 products a k16 step
    wg::hold(dq[0]);
    wg::hold(dq[1]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wg::mma_m64n128k16_rs<1>(dq[h], da[kk],
                                 wg::desc(kt + kk * 2048 + h * 2 * HK * 128, HK * 128, 1024), 1);
    wg::commit();
  }
  wg::wait<0>();
  wg::hold(dq[0]);
  wg::hold(dq[1]);

  // dQ·scale in bf16, staged through this warpgroup's rows of the Q tile
  // (its S products are done with them), out in whole 16-byte chunks
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = HQ * w + 16 * warp + g + 8 * hh;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        *reinterpret_cast<uint32_t*>(qtile + wg::sw128<BQ>(r, 16 * h + jj) + 4 * t) =
            ptx::pack_bf16(dq[h][4 * jj + 2 * hh] * scale, dq[h][4 * jj + 2 * hh + 1] * scale);
  }
  wg::bar_sync(kEpiBar + w, 128);
  constexpr int C = kHd / 8;
  const int ltid = tid & 127;
#pragma unroll
  for (int kk = 0; kk < HQ * C / 128; ++kk) {
    const int i = ltid + kk * 128, r = HQ * w + i / C, c = i % C, row = q0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(dQ + (qoff + row) * kHd + c * 8) =
          *reinterpret_cast<const uint4*>(qtile + wg::sw128<BQ>(r, c));
  }
}

// dK/dV blocks (bh, key block), the key blocks with the most query tiles
// first, then dQ blocks (bh, 128-row block), the longest causal rows first:
// one launch, so that the dQ blocks fill the dK/dV blocks' tail
__global__ void __launch_bounds__(kTmaThreads, 1)
    bwd_tma_kernel(const __grid_constant__ CUtensorMap tq64, const __grid_constant__ CUtensorMap tdo64,
                   const __grid_constant__ CUtensorMap tq128,
                   const __grid_constant__ CUtensorMap tdo128, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const float* __restrict__ LSE,
                   const float* __restrict__ Dv, __nv_bfloat16* __restrict__ dQ,
                   __nv_bfloat16* __restrict__ dK, __nv_bfloat16* __restrict__ dV, int BH, int Sq,
                   int Sk, float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nkb = (Sk + HK - 1) / HK, nqb = (Sq + kTmaWG * HQ - 1) / (kTmaWG * HQ);
  const int b = blockIdx.x;
  if (b < BH * nkb) {
    dkdv_block(&tq64, &tk, &tv, &tdo64, LSE, Dv, dK, dV, Sq, Sk, scale, causal, window, b % BH,
               b / BH, smem_raw);
  } else {
    const int b2 = b - BH * nkb, qb = b2 / BH;
    dq_block(&tq128, &tk, &tv, &tdo128, LSE, Dv, dQ, Sq, Sk, scale, causal, window, b2 % BH,
             causal ? nqb - 1 - qb : qb, smem_raw);
  }
}

int launch_bf16_tma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* D, void* dq, void* dk, void* dv, int BH,
                    int Sq, int Sk, float scale, int causal, int window, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (Sq == 0) {  // no query reaches a key: dK = dV = 0
    const cudaError_t e = cudaMemsetAsync(dk, 0, (size_t)BH * Sk * kHd * sizeof(bf), s);
    return (int)(e != cudaSuccess ? e
                                  : cudaMemsetAsync(dv, 0, (size_t)BH * Sk * kHd * sizeof(bf), s));
  }
  CUtensorMap tq64, tdo64, tq128, tdo128, tk, tv;
  int e = tma::tensor_map(&tq64, q, kHd, Sq, BH, HQ);
  if (e == 0) e = tma::tensor_map(&tdo64, dout, kHd, Sq, BH, HQ);
  if (e == 0) e = tma::tensor_map(&tq128, q, kHd, Sq, BH, kTmaWG * HQ);
  if (e == 0) e = tma::tensor_map(&tdo128, dout, kHd, Sq, BH, kTmaWG * HQ);
  if (e == 0) e = tma::tensor_map(&tk, k, kHd, Sk, BH, HK);
  if (e == 0) e = tma::tensor_map(&tv, v, kHd, Sk, BH, HK);
  if (e != 0) return e;
  const size_t bytes = dkdv_tma_smem_bytes() > dq_tma_smem_bytes() ? dkdv_tma_smem_bytes()
                                                                    : dq_tma_smem_bytes();
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)BH * ((Sk + HK - 1) / HK + (Sq + kTmaWG * HQ - 1) / (kTmaWG * HQ));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_tma_kernel<<<(unsigned)blocks, kTmaThreads, bytes, s>>>(tq64, tdo64, tq128, tdo128, tk, tv,
                                                              lse, D, (bf*)dq, (bf*)dk, (bf*)dv, BH,
                                                              Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, hd 64, not causal: wgmma, dK/dV blocks and dQ blocks fed by TMA
// ---------------------------------------------------------------------------

constexpr int FK = 128;   // keys of a dK/dV block, 64 a consumer
constexpr int FQ = 64;    // query rows of a dK/dV block's tile, of a dQ consumer; keys of a dQ tile
constexpr int FQS = 4;    // stages of a dK/dV block's Q and dO tiles
constexpr int FKS = 4;    // stages of a dQ block's K and V tiles
constexpr uint32_t kTile64 = 64 * 64 * 2;  // a 64-row bf16 tile of 64 columns: one panel

constexpr size_t split_smem_bytes() {
  // 1024 of slack to align the tiles; the resident pair (K and V of 128
  // rows, or Q and dO of 128 rows); the stages of the streamed pair; the
  // mbarriers (the resident pair's, a full and an empty one a stage); a
  // dK/dV block's lse·log2 e and D a stage
  return 1024 + (4 + 2 * (FQS > FKS ? FQS : FKS)) * kTile64 +
         8 * (1 + 2 * (FQS > FKS ? FQS : FKS)) + 2 * FQS * FQ * 4;
}

// One block of 128 keys (key block kb) of a (batch, head) bh: the keys'
// dK and dV over every query tile.  Consumer warpgroup w owns keys
// 64w..64w+63: per 64-row tile it forms Sᵀ = K_w Qᵀ and dPᵀ = V_w dOᵀ
// (m64n64k16, both operands K-major), P and dS in float32
// registers, and adds Pᵀ·dO and dSᵀ·Q (Pᵀ and dSᵀ as bf16 register A
// operands, dO and Q MN-major) into dV and dK: 32 accumulators of each a
// thread.  Keys past Sk are zero-filled and their rows are not stored;
// rows past Sq get lse = +inf (P = 0), so no entry is masked.
__device__ __forceinline__ void dkdv_split_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                                 const CUtensorMap* tv, const CUtensorMap* tdo,
                                                 const float* __restrict__ LSE,
                                                 const float* __restrict__ Dv,
                                                 __nv_bfloat16* __restrict__ dK,
                                                 __nv_bfloat16* __restrict__ dV, int Sq, int Sk,
                                                 float scale, int bh, int kb,
                                                 unsigned char* smem_raw) {
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sK = raw + ((1024 - (raw & 1023)) & 1023);  // [FK][64]
  const uint32_t sV = sK + 2 * kTile64;                        // [FK][64]
  const uint32_t sQ = sV + 2 * kTile64;                        // [FQS][FQ][64]
  const uint32_t sO = sQ + FQS * kTile64;                      // [FQS][FQ][64]
  const uint32_t bKV = sO + FQS * kTile64;                     // K and V landed
  const uint32_t fullQ = bKV + 8, emptyQ = fullQ + 8 * FQS;    // a stage landed / freed
  // lse·log2 e and D of each stage's 64 queries
  float* const Ls = reinterpret_cast<float*>(smem_raw + (emptyQ + 8 * FQS - raw));
  float* const Ds = Ls + FQS * FQ;

  const int k0 = kb * FK, nt = (Sq + FQ - 1) / FQ;
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  if (tid == 0) {
    wg::mbar_init(bKV, 1);
#pragma unroll
    for (int i = 0; i < FQS; ++i) {
      wg::mbar_init(fullQ + 8 * i, 2);  // the TMA's and the row values'
      wg::mbar_init(emptyQ + 8 * i, kTmaWG * 4);  // each consumer warp's release
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (w == kTmaWG) {
    wg::reg_dealloc<kProdRegs>();
    if (warp == 1) {
      const long long qoff = (long long)bh * Sq;
      for (int i = 0; i < nt; ++i) {
        const int st = i % FQS;
        if (i >= FQS) wg::mbar_wait(emptyQ + 8 * st, (i / FQS - 1) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = i * FQ + lane + 32 * h;
          Ls[st * FQ + lane + 32 * h] = q < Sq ? LSE[qoff + q] * kLog2e : INFINITY;
          Ds[st * FQ + lane + 32 * h] = q < Sq ? Dv[qoff + q] : 0.f;
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(fullQ + 8 * st);
      }
    }
    if (warp == 0 && lane == 0) {
      wg::mbar_expect(bKV, 4 * kTile64);
      wg::tma_load_3d(sK, tk, bKV, 0, k0, bh);
      wg::tma_load_3d(sV, tv, bKV, 0, k0, bh);
      for (int i = 0; i < nt; ++i) {
        const int st = i % FQS;
        if (i >= FQS) wg::mbar_wait(emptyQ + 8 * st, (i / FQS - 1) & 1);
        wg::mbar_expect(fullQ + 8 * st, 2 * kTile64);
        wg::tma_load_3d(sQ + st * kTile64, tq, fullQ + 8 * st, 0, i * FQ, bh);
        wg::tma_load_3d(sO + st * kTile64, tdo, fullQ + 8 * st, 0, i * FQ, bh);
      }
    }
    return;
  }

  wg::reg_alloc<kConsRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int kr = 64 * w + 16 * warp + g;  // this thread's keys: k0 + kr, k0 + kr + 8
  const long long koff = (long long)bh * Sk;
  const float scale_log2 = scale * kLog2e;
  const uint32_t kw = sK + 64 * w * 128, vw = sV + 64 * w * 128;  // this warpgroup's keys
  float dk[32], dv[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  wg::mbar_wait(bKV, 0);

  for (int i = 0; i < nt; ++i) {
    const int st = i % FQS;
    const uint32_t q_s = sQ + st * kTile64, o_s = sO + st * kTile64;
    wg::mbar_wait(fullQ + 8 * st, (i / FQS) & 1);
    // lse·log2 e and D of this thread's 16 queries, 8j + 2t + e
    float l2[16], dd[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(Ls + st * FQ + 8 * j + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(Ds + st * FQ + 8 * j + 2 * t);
      l2[2 * j] = a.x, l2[2 * j + 1] = a.y, dd[2 * j] = b.x, dd[2 * j + 1] = b.y;
    }

    // Sᵀ = K_w Qᵀ, then dPᵀ = V_w dOᵀ (the consumers do not take turns
    // here: turns measured 2–4% slower, PERF.md §6)
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
      wg::mma_m64n64k16_ss<0, 0>(s, wg::desc(kw + kd * 32, 16, 1024),
                                 wg::desc(q_s + kd * 32, 16, 1024), kd > 0);
    wg::commit();
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
      wg::mma_m64n64k16_ss<0, 0>(dp, wg::desc(vw + kd * 32, 16, 1024),
                                 wg::desc(o_s + kd * 32, 16, 1024), kd > 0);
    wg::commit();

    // Pᵀ = exp(Sᵀ·scale − lse); its bf16 A fragments (k16 step kk =
    // queries 16kk..16kk+15), and dV += Pᵀ dO while dPᵀ finishes
    wg::wait<1>();
    wg::hold(s);
#pragma unroll
    for (int c = 0; c < 32; ++c)
      s[c] = ptx::ex2(fmaf(s[c], scale_log2, -l2[2 * (c >> 2) + (c & 1)]));
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = ptx::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wg::hold(pa[kk]);
    }
    wg::hold(dv);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64k16_rs<1>(dv, pa[kk], wg::desc(o_s + kk * 2048, FQ * 128, 1024), 1);
    wg::commit();

    // dSᵀ = Pᵀ ⊙ (dPᵀ − D); dK += dSᵀ Q
    wg::wait<1>();
    wg::hold(dp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * kk + 2 * r, lc = 2 * (c >> 2);
        sa[kk][r] = ptx::pack_bf16(s[c] * (dp[c] - dd[lc]), s[c + 1] * (dp[c + 1] - dd[lc + 1]));
      }
      wg::hold(sa[kk]);
    }
    wg::hold(dk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64k16_rs<1>(dk, sa[kk], wg::desc(q_s + kk * 2048, FQ * 128, 1024), 1);
    wg::commit();
    // every product of the tile is done before the next: with a wgmma in
    // flight across the loop's back edge ptxas serialises them (C7515)
    wg::wait<0>();
    wg::hold(dk);
    wg::hold(dv);
    release(emptyQ + 8 * st, lane);
  }

  // dK = scale·Σ dSᵀQ, dV = Σ PᵀdO: rows k0 + kr (+8), bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + kr + 8 * h;
    if (row >= Sk) continue;
    uint32_t* kd = reinterpret_cast<uint32_t*>(dK + (koff + row) * 64 + 2 * t);
    uint32_t* vd = reinterpret_cast<uint32_t*>(dV + (koff + row) * 64 + 2 * t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      kd[jj * 4] = ptx::pack_bf16(dk[4 * jj + 2 * h] * scale, dk[4 * jj + 2 * h + 1] * scale);
      vd[jj * 4] = ptx::pack_bf16(dv[4 * jj + 2 * h], dv[4 * jj + 2 * h + 1]);
    }
  }
}

// One block of 128 query rows (row block qb) of a (batch, head) bh: dQ
// over every 64-key tile.  Consumer warpgroup w owns rows 64w..64w+63 (Q
// and dO resident, their bf16 A fragments loaded once into registers) and
// per tile forms S = Q_w Kᵀ and dP = dO_w Vᵀ (m64n64k16, K K-major), P and
// dS in float32, and adds dS·K (dS as bf16 register A operands, K
// MN-major) into dQ: 32 accumulators a thread.
// Keys past Sk are masked in the last tile (zero-filled K rows would add
// nothing, but P there is exp(−lse), unbounded).
__device__ __forceinline__ void dq_split_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                               const CUtensorMap* tv, const CUtensorMap* tdo,
                                               const float* __restrict__ LSE,
                                               const float* __restrict__ Dv,
                                               __nv_bfloat16* __restrict__ dQ, int Sq, int Sk,
                                               float scale, int bh, int qb,
                                               unsigned char* smem_raw) {
  constexpr int BQ = kTmaWG * FQ;
  const uint32_t raw = ptx::smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [BQ][64]
  const uint32_t sO = sQ + 2 * kTile64;                        // [BQ][64]
  const uint32_t sK = sO + 2 * kTile64;                        // [FKS][FQ][64]
  const uint32_t sV = sK + FKS * kTile64;                      // [FKS][FQ][64]
  const uint32_t bQ = sV + FKS * kTile64;                      // Q and dO landed
  const uint32_t full = bQ + 8, empty = full + 8 * FKS;        // a stage landed / freed
  unsigned char* const qtile = smem_raw + (sQ - raw);

  const int q0 = qb * BQ, nt = (Sk + FQ - 1) / FQ;
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  if (tid == 0) {
    wg::mbar_init(bQ, 1);
#pragma unroll
    for (int i = 0; i < FKS; ++i) {
      wg::mbar_init(full + 8 * i, 1);
      wg::mbar_init(empty + 8 * i, kTmaWG * 4);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (w == kTmaWG) {
    wg::reg_dealloc<kProdRegs>();
    if (warp == 0 && lane == 0) {
      wg::mbar_expect(bQ, 4 * kTile64);
      wg::tma_load_3d(sQ, tq, bQ, 0, q0, bh);
      wg::tma_load_3d(sO, tdo, bQ, 0, q0, bh);
      for (int i = 0; i < nt; ++i) {
        const int st = i % FKS;
        if (i >= FKS) wg::mbar_wait(empty + 8 * st, (i / FKS - 1) & 1);
        wg::mbar_expect(full + 8 * st, 2 * kTile64);
        wg::tma_load_3d(sK + st * kTile64, tk, full + 8 * st, 0, i * FQ, bh);
        wg::tma_load_3d(sV + st * kTile64, tv, full + 8 * st, 0, i * FQ, bh);
      }
    }
    return;
  }

  wg::reg_alloc<kConsRegs>();
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + FQ * w + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const long long qoff = (long long)bh * Sq;
  const float scale_log2 = scale * kLog2e;
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    l2[h] = r < Sq ? LSE[qoff + r] * kLog2e : INFINITY;  // P = 0 past Sq
    dd[h] = r < Sq ? Dv[qoff + r] : 0.f;
  }
  float dq[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  wg::mbar_wait(bQ, 0);
  // Q_w and dO_w as the A fragments of S and dP, each warp's 16 rows
  uint32_t qf[4][4], of[4][4];
  {
    const int row = FQ * w + 16 * warp + (lane & 15);
#pragma unroll
    for (int kd = 0; kd < 4; ++kd) {
      const uint32_t off = row * 128 + (((2 * kd + (lane >> 4)) ^ (row & 7)) << 4);
      ptx::ldmatrix_x4(qf[kd], sQ + off);
      ptx::ldmatrix_x4(of[kd], sO + off);
    }
  }
  for (int i = 0; i < nt; ++i) {
    const int st = i % FKS, k0 = i * FQ;
    const uint32_t kt = sK + st * kTile64, vt = sV + st * kTile64;
    wg::mbar_wait(full + 8 * st, (i / FKS) & 1);
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
      wg::mma_m64n64k16_rs<0>(s, qf[kd], wg::desc(kt + kd * 32, 16, 1024), kd > 0);
    wg::commit();
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
      wg::mma_m64n64k16_rs<0>(dp, of[kd], wg::desc(vt + kd * 32, 16, 1024), kd > 0);
    wg::commit();

    // P = exp(S·scale − lse).  The last tile's dQ product was done before
    // S (one queue): its stage is free
    wg::wait<1>();
    wg::hold(s);
    wg::hold(dq);
    if (i > 0) release(empty + 8 * ((i - 1) % FKS), lane);
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = ptx::ex2(fmaf(s[c], scale_log2, -l2[(c >> 1) & 1]));
    if (k0 + FQ > Sk) {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (k0 + 8 * (c >> 2) + 2 * t + (c & 1) >= Sk) s[c] = 0.f;
    }
    wg::wait<0>();
    wg::hold(dp);
    // dS = P ⊙ (dP − D), as bf16 A fragments (k16 step kk: keys 16kk..)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * kk + 2 * r;
        const float dl = dd[(c >> 1) & 1];
        da[kk][r] = ptx::pack_bf16(s[c] * (dp[c] - dl), s[c + 1] * (dp[c + 1] - dl));
      }
      wg::hold(da[kk]);
    }
    // dQ += dS K: K MN-major (the tile's rows are the k)
    wg::hold(dq);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64k16_rs<1>(dq, da[kk], wg::desc(kt + kk * 2048, FQ * 128, 1024), 1);
    wg::commit();
  }
  wg::wait<0>();
  wg::hold(dq);

  // dQ·scale in bf16, staged through this warpgroup's rows of the Q tile
  // (its S products are done with them), out in whole 16-byte chunks
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = FQ * w + 16 * warp + g + 8 * h;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<uint32_t*>(qtile + wg::sw128<BQ>(r, jj) + 4 * t) =
          ptx::pack_bf16(dq[4 * jj + 2 * h] * scale, dq[4 * jj + 2 * h + 1] * scale);
  }
  wg::bar_sync(kEpiBar + w, 128);
  const int ltid = tid & 127;
#pragma unroll
  for (int kk = 0; kk < FQ * 8 / 128; ++kk) {
    const int i = ltid + kk * 128, r = FQ * w + i / 8, c = i % 8, row = q0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(dQ + (qoff + row) * 64 + c * 8) =
          *reinterpret_cast<const uint4*>(qtile + wg::sw128<BQ>(r, c));
  }
}

// whether the launch takes its dQ blocks first: the longer kind of block
// goes first, so that the shorter fills the tail (a dK/dV tile is four
// products a consumer, a dQ tile three)
__device__ __forceinline__ bool split_dq_first(int Sq, int Sk) {
  return 3 * ((Sk + FQ - 1) / FQ) > 4 * ((Sq + FQ - 1) / FQ);
}

// dK/dV blocks (bh, 128-key block) and dQ blocks (bh, 128-row block) in
// one launch, the longer kind first
__global__ void __launch_bounds__(kTmaThreads, 1)
    bwd_split_kernel(const __grid_constant__ CUtensorMap tq64,
                     const __grid_constant__ CUtensorMap tdo64,
                     const __grid_constant__ CUtensorMap tq128,
                     const __grid_constant__ CUtensorMap tdo128,
                     const __grid_constant__ CUtensorMap tk128,
                     const __grid_constant__ CUtensorMap tv128,
                     const __grid_constant__ CUtensorMap tk64,
                     const __grid_constant__ CUtensorMap tv64, const float* __restrict__ LSE,
                     const float* __restrict__ Dv, __nv_bfloat16* __restrict__ dQ,
                     __nv_bfloat16* __restrict__ dK, __nv_bfloat16* __restrict__ dV, int BH,
                     int Sq, int Sk, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nkv = BH * ((Sk + FK - 1) / FK), nq = BH * ((Sq + 2 * FQ - 1) / (2 * FQ));
  int b = blockIdx.x;
  bool kv;
  if (split_dq_first(Sq, Sk)) {
    kv = b >= nq;
    if (kv) b -= nq;
  } else {
    kv = b < nkv;
    if (!kv) b -= nkv;
  }
  if (kv)
    dkdv_split_block(&tq64, &tk128, &tv128, &tdo64, LSE, Dv, dK, dV, Sq, Sk, scale, b % BH, b / BH,
                     smem_raw);
  else
    dq_split_block(&tq128, &tk64, &tv64, &tdo128, LSE, Dv, dQ, Sq, Sk, scale, b % BH, b / BH,
                   smem_raw);
}

int launch_bf16_split(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* D, void* dq, void* dk, void* dv, int BH,
                      int Sq, int Sk, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (Sq == 0) {  // no query reaches a key: dK = dV = 0
    const cudaError_t e = cudaMemsetAsync(dk, 0, (size_t)BH * Sk * 64 * sizeof(bf), s);
    return (int)(e != cudaSuccess ? e : cudaMemsetAsync(dv, 0, (size_t)BH * Sk * 64 * sizeof(bf), s));
  }
  CUtensorMap tq64, tdo64, tq128, tdo128, tk128, tv128, tk64, tv64;
  int e = tma::tensor_map(&tq64, q, 64, Sq, BH, FQ);
  if (e == 0) e = tma::tensor_map(&tdo64, dout, 64, Sq, BH, FQ);
  if (e == 0) e = tma::tensor_map(&tq128, q, 64, Sq, BH, 2 * FQ);
  if (e == 0) e = tma::tensor_map(&tdo128, dout, 64, Sq, BH, 2 * FQ);
  if (e == 0) e = tma::tensor_map(&tk128, k, 64, Sk, BH, FK);
  if (e == 0) e = tma::tensor_map(&tv128, v, 64, Sk, BH, FK);
  if (e == 0) e = tma::tensor_map(&tk64, k, 64, Sk, BH, FQ);
  if (e == 0) e = tma::tensor_map(&tv64, v, 64, Sk, BH, FQ);
  if (e != 0) return e;
  const size_t bytes = split_smem_bytes();
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((Sk + FK - 1) / FK + (Sq + 2 * FQ - 1) / (2 * FQ));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_split_kernel<<<(unsigned)blocks, kTmaThreads, bytes, s>>>(
      tq64, tdo64, tq128, tdo128, tk128, tv128, tk64, tv64, lse, D, (bf*)dq, (bf*)dk, (bf*)dv, BH,
      Sq, Sk, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int BR = 32;  // rows of a staged tile (keys or queries), and of a block

template <int HD>
constexpr size_t f32_smem_floats() {
  return (size_t)4 * BR * (HD + 1) + 2 * BR * (BR + 1) + 2 * BR;
}

// rows [r0, r0 + BR) of a [S][HD] float32 matrix into a tile with padded
// rows; rows at or past S are zero-filled
template <int HD>
__device__ __forceinline__ void stage_f32(float* tile, const float* src, int r0, int S, int tid) {
  for (int i = tid; i < BR * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = r0 + r;
    tile[r * (HD + 1) + c] = row < S ? src[(long long)row * HD + c] : 0.f;
  }
}

// the 32×32 tile of P and dS, P ⊙ (dP − D): thread (key kc = tid % 32,
// queries qr = tid / 32 + 8i) forms 4 entries; Ps/Ss are [query][key]
template <int HD>
__device__ __forceinline__ void f32_tile(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* Ls, const float* Dd,
                                         float* Ps, float* Ss, int q0, int k0, int Sk,
                                         float scale, int causal, int window, int tid) {
  constexpr int LD = HD + 1;
  const int kc = tid & 31, qr = tid >> 5;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float kv = Ks[kc * LD + d], vv = Vs[kc * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qr + 8 * i;
      s[i] = fmaf(Qs[qi * LD + d], kv, s[i]);
      dp[i] = fmaf(dOs[qi * LD + d], vv, dp[i]);
    }
  }
  const int key = k0 + kc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = qr + 8 * i;
    float p = expf(s[i] * scale - Ls[qi]);
    if (masked(key, q0 + qi, Sk, causal, window)) p = 0.f;
    Ps[qi * (BR + 1) + kc] = p;
    Ss[qi * (BR + 1) + kc] = p * (dp[i] - Dd[qi]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dkdv_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, const float* __restrict__ dO,
                    const float* __restrict__ LSE, const float* __restrict__ Dv,
                    float* __restrict__ dK, float* __restrict__ dV, int Sq, int Sk, float scale,
                    int causal, int window) {
  constexpr int LD = HD + 1, CPT = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* dOs = Qs + BR * LD;
  float* Ps = dOs + BR * LD;    // [BR][BR + 1]
  float* Ss = Ps + BR * (BR + 1);
  float* Ls = Ss + BR * (BR + 1);
  float* Dd = Ls + BR;
  const int bh = blockIdx.x, k0 = blockIdx.y * BR, tid = threadIdx.x;
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;
  stage_f32<HD>(Ks, K + koff * HD, k0, Sk, tid);
  stage_f32<HD>(Vs, V + koff * HD, k0, Sk, tid);
  const int kr = tid >> 3, c0 = tid & 7;  // accumulator row and first column
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = 0.f;
  // the query tiles that reach these keys: from k0 (causal) to the last
  // key + window - 1 (the window)
  const int qend = window > 0 ? min(Sq, k0 + BR - 1 + window) : Sq;
  for (int q0 = causal ? k0 : 0; q0 < qend; q0 += BR) {
    __syncthreads();  // the previous tile's reads are done
    stage_f32<HD>(Qs, Q + qoff * HD, q0, Sq, tid);
    stage_f32<HD>(dOs, dO + qoff * HD, q0, Sq, tid);
    if (tid < BR) {
      const int q = q0 + tid;
      Ls[tid] = q < Sq ? LSE[qoff + q] : INFINITY;  // P = 0 past Sq
      Dd[tid] = q < Sq ? Dv[qoff + q] : 0.f;
    }
    __syncthreads();
    f32_tile<HD>(Qs, dOs, Ks, Vs, Ls, Dd, Ps, Ss, q0, k0, Sk, scale, causal, window, tid);
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BR; ++qq) {
      const float p = Ps[qq * (BR + 1) + kr], ds = Ss[qq * (BR + 1) + kr];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dv[c] = fmaf(p, dOs[qq * LD + c0 + 8 * c], dv[c]);
        dk[c] = fmaf(ds, Qs[qq * LD + c0 + 8 * c], dk[c]);
      }
    }
  }
  const int key = k0 + kr;
  if (key < Sk) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dK[(koff + key) * HD + c0 + 8 * c] = dk[c] * scale;
      dV[(koff + key) * HD + c0 + 8 * c] = dv[c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dq_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, const float* __restrict__ dO,
                  const float* __restrict__ LSE, const float* __restrict__ Dv,
                  float* __restrict__ dQ, int Sq, int Sk, float scale, int causal,
                  int window) {
  constexpr int LD = HD + 1, CPT = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BR * LD;
  float* Ps = Vs + BR * LD;
  float* Ss = Ps + BR * (BR + 1);
  float* Ls = Ss + BR * (BR + 1);
  float* Dd = Ls + BR;
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const long long qoff = (long long)bh * Sq, koff = (long long)bh * Sk;
  stage_f32<HD>(Qs, Q + qoff * HD, q0, Sq, tid);
  stage_f32<HD>(dOs, dO + qoff * HD, q0, Sq, tid);
  if (tid < BR) {
    const int q = q0 + tid;
    Ls[tid] = q < Sq ? LSE[qoff + q] : INFINITY;
    Dd[tid] = q < Sq ? Dv[qoff + q] : 0.f;
  }
  const int qr = tid >> 3, c0 = tid & 7;
  float dq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq[c] = 0.f;
  // the key tiles the rows reach: from the first row's window on, to the
  // last row's diagonal (causal)
  const int kend = causal ? min(Sk, q0 + BR) : Sk;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / BR * BR : 0;
  for (int k0 = kbeg; k0 < kend; k0 += BR) {
    __syncthreads();
    stage_f32<HD>(Ks, K + koff * HD, k0, Sk, tid);
    stage_f32<HD>(Vs, V + koff * HD, k0, Sk, tid);
    __syncthreads();
    f32_tile<HD>(Qs, dOs, Ks, Vs, Ls, Dd, Ps, Ss, q0, k0, Sk, scale, causal, window, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BR; ++kk) {
      const float ds = Ss[qr * (BR + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) dq[c] = fmaf(ds, Ks[kk * LD + c0 + 8 * c], dq[c]);
    }
  }
  const int row = q0 + qr;
  if (row < Sq) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) dQ[(qoff + row) * HD + c0 + 8 * c] = dq[c] * scale;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* D, void* dq, void* dk, void* dv, int BH, int Sq, int Sk, float scale,
               int causal, int window, cudaStream_t s) {
  const size_t bytes = f32_smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dkdv_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dkdv_f32_kernel<HD><<<dim3(BH, (Sk + BR - 1) / BR), kThreads, bytes, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, D, (float*)dk,
      (float*)dv, Sq, Sk, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_f32_kernel<HD><<<dim3(BH, (Sq + BR - 1) / BR), kThreads, bytes, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, D, (float*)dq,
      Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

// whether a launch takes the one-pass kernel, whose scratch holds the sync
// words and the dQ workspace after D, or the split route
inline bool one_pass(int dtype, int hd, int causal) {
  return dtype == 1 && (hd == 128 || (hd == 64 && causal));
}
inline bool split_route(int dtype, int hd, int causal) {
  return dtype == 1 && hd == 64 && !causal;
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* D, void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
           float scale, int causal, int window, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, dout, lse, D, dq, dk, dv, BH, Sq, Sk, scale, causal, window,
                          s);
  if constexpr (HD == 64 || HD == 128) {
    if (window > 0) return (int)cudaErrorInvalidValue;  // the wrapper refuses it first
    if (split_route(1, HD, causal))
      return launch_bf16_split(q, k, v, dout, lse, D, dq, dk, dv, BH, Sq, Sk, scale, s);
    return launch_bf16_wg<HD>(q, k, v, dout, lse, D, dq, dk, dv, BH, Sq, Sk, scale, causal, s);
  } else if constexpr (HD == kHd) {
    return launch_bf16_tma(q, k, v, dout, lse, D, dq, dk, dv, BH, Sq, Sk, scale, causal, window,
                           s);
  } else {
    return launch_bf16<HD>(q, k, v, dout, lse, D, dq, dk, dv, BH, Sq, Sk, scale, causal, window,
                           s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// q, o, dout, dq: [BH, Sq, hd]; k, v, dk, dv: [BH, Sk, hd]; lse: [BH, Sq]
// float32 as flash_attention_lse_launch writes it.  The scratch d (float32,
// overwritten) holds D [BH, Sq]; for the one-pass kernel (bfloat16 at hd
// 128, and at hd 64 causal) it goes on with the sync words (1 +
// BH·ceil(Sq/64) of 32 bits), padded to 16 bytes, then the dQ workspace [BH,
// ceil(Sq/64), 64·hd]: BH·Sq + 1 + BH·ceil(Sq/64) rounded up to a multiple
// of 4, plus BH·ceil(Sq/64)·64·hd floats in all.  All contiguous, bfloat16
// ones and d 16-byte aligned.  hd ∈ {16, 32, 64, 128, 256}.  window > 0
// keeps key j for query i only when j > i - window (bfloat16 at hd 64 and
// 128 take none).  Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                                          const void* v, const void* o, const void* lse,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* d, int BH, int Sq, int Sk, int hd, float scale,
                                          int causal, int window, void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || window < 0 || (Sq + BR - 1) / BR > 65535 ||
      (Sk + BR - 1) / BR > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
                     (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)d) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (BH == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)BH * Sq;
  const long long nsync = one_pass(dtype, hd, causal) ? wg_sync_words(BH, Sq) : 0;
  unsigned* sync = reinterpret_cast<unsigned*>((float*)d + rows);
  if (split_route(dtype, hd, causal)) {
    const long long blocks = rows > 0 ? (rows * 8 + 255) / 256 : 1;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rowdot64_kernel<<<(unsigned)blocks, 256, 0, s>>>((const __nv_bfloat16*)dout,
                                                      (const __nv_bfloat16*)o, (float*)d, rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    const int warps = 8;
    const long long blocks = rows > 0 ? (rows + warps - 1) / warps : 1;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      rowdot_kernel<float><<<(unsigned)blocks, warps * 32, 0, s>>>(
          (const float*)dout, (const float*)o, (float*)d, rows, hd, sync, nsync);
    else
      rowdot_kernel<__nv_bfloat16><<<(unsigned)blocks, warps * 32, 0, s>>>(
          (const __nv_bfloat16*)dout, (const __nv_bfloat16*)o, (float*)d, rows, hd, sync, nsync);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const float* L = (const float*)lse;
  float* D = (float*)d;
  const int w = window;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, dout, L, D, dq, dk, dv, BH, Sq, Sk, scale, causal, w, s);
    case 32: return launch<32>(dtype, q, k, v, dout, L, D, dq, dk, dv, BH, Sq, Sk, scale, causal, w, s);
    case 64: return launch<64>(dtype, q, k, v, dout, L, D, dq, dk, dv, BH, Sq, Sk, scale, causal, w, s);
    case 128:
      return launch<128>(dtype, q, k, v, dout, L, D, dq, dk, dv, BH, Sq, Sk, scale, causal, w, s);
    case 256:
      return launch<256>(dtype, q, k, v, dout, L, D, dq, dk, dv, BH, Sq, Sk, scale, causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
