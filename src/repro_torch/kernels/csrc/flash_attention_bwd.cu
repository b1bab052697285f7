// Hand-written Hopper (sm_90a) backward of B6 (flash_attention.cu): the
// gradients dq, dk, dv of causal / sliding-window GQA attention, float32,
// from the forward's output o and its per-row log-sum-exp.
//
// Replaces no Pallas kernel: the JAX package trains through the plain jnp
// attention of its models (layers._sdpa) and lets XLA differentiate it,
// while the port routes the training forward through B6 on the card, so
// the gradient needs a kernel of its own.  It computes autograd's
// gradient of the function B6 computes (ref.flash_attention_ref):
//
//   s = (q·kᵀ)·scale,  p = exp(s - lse) on visible pairs, 0 elsewhere
//   Di = Σ_d dO·o                    (pre-pass, one warp per row)
//   dv_j = Σ_i p_ij dO_i,  dp = dO·vᵀ,  ds = p ∘ (dp - Di)
//   dq_i = scale · Σ_j ds_ij k_j,  dk_j = scale · Σ_i ds_ij q_i
//   with the kv head j of query head h = g·group + i summed over its group.
//
// Three launches a backward: the Di pre-pass, a dK/dV kernel and a dQ
// kernel.  Each output element is written by exactly one thread, with no
// atomics, so two backwards on the same inputs give the same bits.
//
// What bounds it on this card: operations.  ≈ 10·B·H·D FLOPs per visible
// (query, key) pair (s, dp, dv, dk, dq): at [1, 16, 8, 4096, 128] 1.72e11
// FLOPs, 1.04 ms by 3xTF32 at 495 TFLOP/s (2.56 ms on the FP32 pipes);
// q, k, v, o, dO, dq, dk, dv are 0.1 GB, 0.03 ms.  The two kernels
// recompute s and dp, 14·D FLOPs a pair.
//
// Design (every float32 product 3xTF32: hi·hi + hi·lo + lo·hi):
//   * Two kinds of product.  Those over the head dimension (s and dp in
//     both kernels) run on mma.sync m16n8k8 from a stationary operand in
//     shared memory (tf32_mma.cuh's split on the fly).  Those over the
//     sequence (dv += pᵀ·dO, dk += dsᵀ·q, dq += ds·k) run on wgmma
//     m64nDk8 by warpgroups: A is p or ds straight from the mma.sync
//     accumulators in registers (split there), B is the streamed tile
//     with N = D; their [64, D] sums live in wgmma accumulators.  wgmma
//     reads a .tf32 B operand only K-major, here [D][rows of the tile], so
//     the streamed tiles are stored transposed, with their low parts.
//     Putting s and dp on wgmma too would need the stationary operand's
//     low part and the streamed tile in its natural layout as well, which
//     at D = 128 leaves no room for two stages; with N = 16 its A reads
//     would also bind on shared-memory bandwidth.
//   * CTA: two consumer warpgroups and a producer warpgroup (384
//     threads, one CTA an SM: 8 warps issue tensor work, against 4
//     before); the producers hand registers to the consumers with
//     setmaxnreg (56 and 224 a thread: without it a 384-thread block
//     gets 168 a thread, and 288 threads got 168 too, the dK/dV
//     consumers spilling).  A CTA owns 64 rows, keys for dK/dV (of one
//     (batch, kv head); it walks the group's heads and the query tiles of
//     BT = 16 rows that see them), queries for dQ (of one (batch, head);
//     the key tiles of 16 rows they see); warp w of each warpgroup owns
//     rows 16w .. 16w + 15.  The two warpgroups take alternate tiles, each
//     with its own accumulators, summed at the end through shared memory
//     in a fixed order (warpgroup 0's, then 1's: no atomics), so one
//     warpgroup's wgmma runs while the other's mma.sync does.  Heaviest
//     CTAs launch first.  (Measured on an H100 against the others: 128-row
//     CTAs, both warpgroups on one tile, were 6% faster at S = 4096 and
//     47% slower at S = 128; a tile's mma.sync overlapped with the wgmma
//     of the tile before in the same warpgroup, slower at both; staging
//     the producers' loads through cp.async slots, or splitting the
//     stationary operand once, within 3%.)
//   * The producer warps stage each tile: they load 16 rows (4 rows × 8
//     columns a warp load, 32-byte pieces), write them transposed into a
//     ring stage (raw, read by the tensor cores as its top 19 bits, and
//     the exact low part x - trunc(x)), fence them for the async proxy
//     and arrive on the stage's `full` mbarrier; the consumer warps of
//     the tile's warpgroup wait on it and, once their wgmma has
//     completed, arrive on `empty`.
//   * The transposed tile [D][16]: element (d, r) at (d / 8)·SBO + (r' /
//     4)·LBO + (d % 8)·4 + r' % 4 floats, with r' the row's k position:
//     rows 2t, 2t + 1 of each 8 go to t and t + 4, so the columns 2t,
//     2t + 1 a thread holds in an mma.sync accumulator are exactly the k
//     = t, t + 4 of the wgmma A fragment (no shuffle).  LBO = 144 bytes
//     (a core matrix and 16 bytes) puts the two k chunks 4 banks apart:
//     the mma.sync B loads of s and dp from the same arrays hit 32 banks.
//   * Shared memory at D = 128 (227 KB a block; a stationary row is D + 8
//     floats, conflict-free 8-byte fragment loads):
//       dK/dV: k, v 2 × 64 × 136 × 4 = 69,632 B; a stage qᵀ, qᵀ lo, dOᵀ,
//              dOᵀ lo 4 × 9,216 B + lse, Di 128 B = 36,992 B; 4 stages;
//              128 B of barriers: 217,728 B.
//       dQ:    q, dO 69,632 B; a stage kᵀ, kᵀ lo, vᵀ 27,648 B; 4 stages;
//              180,352 B.
//     D = 80 and 64 take 4 stages too.
//   * Tiles and warps skip work no visible pair reaches; masked pairs take
//     p = 0.  A warp without visible pairs still joins its warpgroup's
//     wgmma (with zero fragments) and releases the stage.
//   * expf and IEEE arithmetic, not the fast intrinsics.
//
// Value width: v, o, dO, dv have DV columns, q, k, dq, dk D.  The GQA
// instances have DV = D; the MLA instances do not.  (D, DV) = (96, 64)
// is minicpm3-4b's: s = q·kᵀ runs 12 mma.sync k-steps and dp = dO·vᵀ 8,
// dv takes wgmma m64n64k8 and dk, dq m64n96k8; the stationary v / dO rows
// are DV + 8 floats and the streamed dOᵀ / vᵀ tiles DV / 8 groups.  At
// (96, 64) the dK/dV kernel takes 137,856 B of shared memory and the dQ
// kernel 118,912 B (4 stages each).
//
// (D, DV) = (96, 96) is phi-3-vision-4.2b's (GQA, head dim 96): s and dp
// run 12 k-steps each, dv, dk and dq take wgmma m64n96k8; a dK/dV
// consumer thread holds dk and dv at 48 + 48 = 96 accumulator registers.
// By Shape<96, 96> 4 stages fit: 164,480 B for dK/dV, 136,320 B for dQ.
//
// (D, DV) = (192, 128) is deepseek-v2's (qk_nope 128 + qk_rope 64, v
// 128): s runs 24 k-steps and dp 16, dk and dq take wgmma m64n192k8 and
// dv m64n128k8.  Shared memory fits 3 stages: 224,768 B for dK/dV,
// 196,736 B for dQ.  A dK/dV consumer thread holds dk [64 × 192] and dv
// [64 × 128] of its warpgroup as wgmma accumulators, 96 + 64 = 160
// registers of the 224 setmaxnreg gives it (128 at (128, 128)); ptxas
// -v reports no spill for it, and 8 bytes of stack (4 spilled bytes) for
// the dQ kernel.  So the instance keeps the one-pass design.
//
// Layout: q, o, dO, dq are [B, H, S, D] and k, v, dk, dv [B, Hkv, T, D]
// through (batch, head, sequence) element strides with the head dimension
// contiguous (the model's [B, S, H, D] activations as views); every row
// start is 16-byte aligned (the wrapper checks).  lse and the Di scratch
// are [B, H, S] contiguous.
//
// Plain C interface for ctypes: the entry returns the first
// cudaGetLastError() of its three launches; nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int CONSUMER_WARPS = 8;                    // two warpgroups
constexpr int PRODUCER_WARPS = 4;                    // a third one
constexpr int THREADS = 32 * (CONSUMER_WARPS + PRODUCER_WARPS);
// registers a thread after the producers hand theirs to the consumers:
// 128 × 56 + 256 × 224 = 64,512 of the SM's 65,536
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int BR = 64;       // rows a CTA owns: keys (dK/dV), queries (dQ)
constexpr int BT = 16;       // rows of a streamed tile: queries, keys
constexpr int DOT_WARPS = 8; // Di pre-pass: rows per block
constexpr int SMEM_LIMIT = 232448;
constexpr int BARRIER_BYTES = 128;        // full and empty, up to 8 stages
constexpr int LBO_F = 36;                 // the k step's two core matrices
constexpr int SBO_F = (BT / 4) * LBO_F;   // groups of 8 d rows

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

template <int D, int DV>
struct Shape {
  static constexpr int PS = D + 8;                   // stationary q / k row, floats
  static constexpr int PSV = DV + 8;                 // stationary v / dO row
  static constexpr int TL = (D / 8) * SBO_F;         // a transposed q / k tile
  static constexpr int TLV = (DV / 8) * SBO_F;       // a transposed dO / v tile
  static constexpr int STATIONARY = BR * (PS + PSV); // [BR][PS] and [BR][PSV]
  static constexpr int KV_STAGE = 2 * TL + 2 * TLV + 2 * BT;  // qᵀ, lo, dOᵀ, lo, lse, Di
  static constexpr int DQ_STAGE = 2 * TL + TLV;      // kᵀ, lo, vᵀ
  static constexpr int stages(int stage) {
    const int n = (SMEM_LIMIT - BARRIER_BYTES - 4 * STATIONARY) / (4 * stage);
    return n > 4 ? 4 : n;
  }
  static constexpr int KV_STAGES = stages(KV_STAGE);
  static constexpr int DQ_STAGES = stages(DQ_STAGE);
  static constexpr int KV_BYTES = BARRIER_BYTES + 4 * (STATIONARY + KV_STAGES * KV_STAGE);
  static constexpr int DQ_BYTES = BARRIER_BYTES + 4 * (STATIONARY + DQ_STAGES * DQ_STAGE);
  static_assert(KV_STAGES >= 2 && DQ_STAGES >= 2, "two stages at least");
  static_assert(KV_BYTES <= SMEM_LIMIT && DQ_BYTES <= SMEM_LIMIT, "shared memory");
  // the warpgroups' final sums pass through the ring
  static_assert(64 * (D + DV) <= KV_STAGES * KV_STAGE && 64 * D <= DQ_STAGES * DQ_STAGE,
                "the ring holds the pair sums");
};

// rows [r0, r0 + n) of W floats of one (batch, head) into shared memory
// rows of RS floats with 16-byte cp.async copies by every thread of the
// CTA; rows at or past `limit` are zero-filled
template <int W, int RS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int r0, int n,
                                          int limit, int tid) {
  constexpr int CH = W / 4;  // 16-byte pieces per row
  for (int i = tid; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const int s = r0 + r;
    const bool in = s < limit;
    tc::cp_async16(dst + r * RS + c,
                   src + (in ? (long long)s * ss : 0) + c, in);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// split A fragment of k step kk from 16 rows of a [*, PS] shared array
template <int PS>
__device__ __forceinline__ void a_rows(const float* m, int kk, int g, int t4,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 x = ld2(m + g * PS + 8 * kk + 2 * t4);
  const float2 y = ld2(m + (g + 8) * PS + 8 * kk + 2 * t4);
  tc::split4(x.x, y.x, x.y, y.y, big, small);
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int T_len,
                                        int window) {
  return qp < S && kp < T_len && kp <= qp && (window <= 0 || qp - kp < window);
}

// float offset of (d, row r) in a transposed tile [D][BT] (see the note)
__device__ __forceinline__ int tl_off(int d, int r) {
  const int rk = (r & 8) | ((r & 7) >> 1) | ((r & 1) << 2);
  return (d >> 3) * SBO_F + (rk >> 2) * LBO_F + (d & 7) * 4 + (rk & 3);
}

// The producer warpgroup's copy of BT rows [r0, r0 + BT) of x (DX
// columns) and y (DY columns) (one (batch, head) each, row strides xs, ys)
// into transposed tiles: x_raw and x_lo, y_raw and, unless null, y_lo.
// Rows at or past `limit` are zeros.  Producer warp pw takes the column
// groups pw, pw + 4, ...; its lane (e, r4) loads column 8·group + e of
// rows 8c + 2·r4 + parity, so a warp load is 4 rows × 32 bytes and a warp
// store one core matrix.
template <int DX, int DY>
__device__ __forceinline__ void stage_rows(float* x_raw, float* x_lo, const float* x,
                                           long long xs, float* y_raw, float* y_lo,
                                           const float* y, long long ys, int r0, int limit,
                                           int pw, int lane) {
  constexpr int NGX = DX / 8, NGY = DY / 8;
  constexpr int NG = NGX > NGY ? NGX : NGY;
  constexpr int NU = 4 * ((NG + PRODUCER_WARPS - 1) / PRODUCER_WARPS);  // units a warp
  const int e = lane & 7, r4 = lane >> 3;
  float vx[NU], vy[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int cp = u & 3, dg = pw + PRODUCER_WARPS * (u >> 2);
    const int row = r0 + 8 * (cp >> 1) + 2 * r4 + (cp & 1);
    vx[u] = row < limit && dg < NGX ? x[(long long)row * xs + 8 * dg + e] : 0.f;
    vy[u] = row < limit && dg < NGY ? y[(long long)row * ys + 8 * dg + e] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int cp = u & 3, dg = pw + PRODUCER_WARPS * (u >> 2);
    const int off = dg * SBO_F + cp * LBO_F + e * 4 + r4;
    if (dg < NGX) {
      x_raw[off] = vx[u];
      x_lo[off] = vx[u] - __uint_as_float(__float_as_uint(vx[u]) & 0xffffe000u);
    }
    if (dg < NGY) {
      y_raw[off] = vy[u];
      if (y_lo != nullptr)
        y_lo[off] = vy[u] - __uint_as_float(__float_as_uint(vy[u]) & 0xffffe000u);
    }
  }
}

// wgmma B descriptor of k step j (rows 8j .. 8j + 7) of a transposed tile
__device__ __forceinline__ uint64_t tile_desc(const float* tile, int j) {
  return tc::wgmma_desc(tile + 2 * LBO_F * j, 4 * LBO_F, 4 * SBO_F);
}

// acc += a·b for one k step, 3xTF32: the small terms first
template <int D>
__device__ __forceinline__ void wgmma3(float (&acc)[D / 2], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint64_t b_raw,
                                       uint64_t b_lo) {
  tc::wgmma<D>(acc, as, b_raw);
  tc::wgmma<D>(acc, ab, b_lo);
  tc::wgmma<D>(acc, ab, b_raw);
}

// acc of warpgroup 0 += acc of warpgroup 1, in that order: warpgroup 1
// stores its accumulators (thread j's element i at red[128·i + j], the
// same fragment position in both), a named barrier over the 256 consumer
// threads, warpgroup 0 adds them; red holds 64·D floats of shared memory
// no tile uses any more (both warpgroups are past their last tile at the
// first barrier)
template <int R>
__device__ __forceinline__ void pair_sum(float (&acc)[R], float* red, int wg) {
  const int j = threadIdx.x & 127;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) red[128 * i + j] = acc[i];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += red[128 * i + j];
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) {
      tc::mbar_init(&full[s], 32 * PRODUCER_WARPS);  // the producers' threads
      tc::mbar_init(&empty[s], CONSUMER_WARPS / 2);  // a lane of each warp of
                                                      // the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Di[row] = Σ_d dO·o, one warp per row of [B, H, S]
__global__ void __launch_bounds__(32 * DOT_WARPS)
flash_bwd_dot_kernel(const float* __restrict__ o,
                     const float* __restrict__ dO, float* __restrict__ di,
                     int H, int S, int D, Strides os, Strides dos,
                     long long rows) {
  const long long row =
      (long long)blockIdx.x * DOT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / S;
  const int i = (int)(row % S), b = (int)(bh / H), h = (int)(bh % H);
  const float* op = o + b * os.b + h * os.h + i * os.s;
  const float* dp = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += dp[d] * op[d];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) di[row] = acc;
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int group, int S,
                      int T_len, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, int window,
                      float scale) {
  using L = Shape<D, DV>;
  constexpr int PS = L::PS, PSV = L::PSV, NS = L::KV_STAGES;
  // k-steps of s (over D) and dp (over DV); with DV = D one loop runs both
  constexpr int KK = D / 8, KKV = DV / 8, KMAX = KK > KKV ? KK : KKV;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  float* sk = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  float* sv = sk + BR * PS;
  float* ring = sv + BR * PSV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Hkv = H / group;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BR;  // earliest (heaviest) key tiles first

  // query tiles that see some key of this CTA, for each head of the group
  const int qt_lo = k0 / BT;
  const int q_hi = window > 0 ? min(S, k0 + BR - 1 + window) : S;
  const int n_qt = max(0, (q_hi + BT - 1) / BT - qt_lo);
  const int total = group * n_qt;

  init_barriers(full, empty, NS);
  load_rows<D, PS>(sk, k + b * ks.b + hk * ks.h, ks.s, k0, BR, T_len, tid);
  load_rows<DV, PSV>(sv, v + b * vs.b + hk * vs.h, vs.s, k0, BR, T_len, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = warp - CONSUMER_WARPS;
    for (int idx = 0; idx < total; ++idx) {
      const int s = idx % NS;
      tc::mbar_wait(&empty[s], ((idx / NS) & 1) ^ 1);
      const int h = hk * group + idx / n_qt;
      const int q0 = (qt_lo + idx % n_qt) * BT;
      float* st = ring + s * L::KV_STAGE;
      stage_rows<D, DV>(st, st + L::TL, q + b * qs.b + h * qs.h, qs.s, st + 2 * L::TL,
                        st + 2 * L::TL + L::TLV, dO + b * dos.b + h * dos.h, dos.s, q0, S,
                        pw, lane);
      if (pw == 0 && lane < BT) {
        const bool in = q0 + lane < S;
        const long long row = ((long long)b * H + h) * S + q0 + lane;
        st[2 * L::TL + 2 * L::TLV + lane] = in ? lse[row] : 0.f;
        st[2 * L::TL + 2 * L::TLV + BT + lane] = in ? di[row] : 0.f;
      }
      tc::fence_proxy_async();
      tc::mbar_arrive(&full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 16 * (warp & 3);  // this warp's first key
  const float* skw = sk + (kw0 - k0) * PS;
  const float* svw = sv + (kw0 - k0) * PSV;
  float adk[D / 2], adv[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) adv[i] = 0.f;

  // warpgroup wg takes the tiles wg, wg + 2, ...
  for (int idx = wg; idx < total; idx += 2) {
    const int s = idx % NS;
    tc::mbar_wait(&full[s], (idx / NS) & 1);
    const int q0 = (qt_lo + idx % n_qt) * BT;
    // does any query of the tile see a key of this CTA, of this warp?
    const bool wg_on = k0 < T_len && q0 + BT - 1 >= k0 &&
                       !(window > 0 && q0 - (k0 + BR - 1) >= window);
    const bool warp_on = kw0 < T_len && q0 + BT - 1 >= kw0 &&
                         !(window > 0 && q0 - (kw0 + 15) >= window);
    if (wg_on) {
      const float* sq = ring + s * L::KV_STAGE;
      const float* sqlo = sq + L::TL;
      const float* sdo = sq + 2 * L::TL;
      const float* sdolo = sdo + L::TLV;
      const float* sl = sdo + 2 * L::TLV;
      const float* sdi = sl + BT;
      uint32_t pb[2][4], ps[2][4], db[2][4], ds[2][4];
      if (warp_on) {
        // sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, [16 keys, BT queries] per warp
        float sc[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < KMAX; ++kk) {
          // (the width that sets KMAX takes every step: no test)
          const bool on_s = KK == KMAX || kk < KK, on_dp = KKV == KMAX || kk < KKV;
          uint32_t kb[4], ks_[4], vb[4], vs_[4];
          if (on_s) a_rows<PS>(skw, kk, g, t4, kb, ks_);
          if (on_dp) a_rows<PSV>(svw, kk, g, t4, vb, vs_);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = tl_off(8 * kk + 2 * t4, 8 * j + g);
            if (on_s) tc::mma3<false>(sc[j], kb, ks_, sq[o], sq[o + 4]);
            if (on_dp) tc::mma3<false>(dp[j], vb, vs_, sdo[o], sdo[o + 4]);
          }
        }
        // element e of sc[j]: key kw0 + g + 8·(e >> 1), query q0 + 8j + 2t
        // + (e & 1); sc becomes pᵀ and dp becomes dsᵀ, split as the wgmma
        // A fragments of k steps j
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kw0 + g + 8 * (e >> 1);
            const int qi = 8 * j + 2 * t4 + (e & 1);
            const float p = visible(q0 + qi, kp, S, T_len, window)
                                ? expf(sc[j][e] * scale - sl[qi])
                                : 0.f;
            sc[j][e] = p;
            dp[j][e] = p * (dp[j][e] - sdi[qi]);
          }
          tc::split4(sc[j][0], sc[j][2], sc[j][1], sc[j][3], pb[j], ps[j]);
          tc::split4(dp[j][0], dp[j][2], dp[j][1], dp[j][3], db[j], ds[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pb[j][e] = ps[j][e] = db[j][e] = ds[j][e] = 0u;
      }
      // dv += pᵀ·dO and dk += dsᵀ·q on the warpgroup's tensor cores
      tc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wgmma3<DV>(adv, pb[j], ps[j], tile_desc(sdo, j), tile_desc(sdolo, j));
        wgmma3<D>(adk, db[j], ds[j], tile_desc(sq, j), tile_desc(sqlo, j));
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(adv);
      tc::fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[s]);  // this stage is consumed
  }

  // the two warpgroups' sums, warpgroup 0's first (through the ring,
  // which every tile has left)
  float* red = ring;
  pair_sum(adk, red, wg);
  pair_sum(adv, red + 64 * D, wg);
  if (wg == 1) return;
  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kw0 + g + 8 * r;
    if (kp >= T_len) continue;
#pragma unroll
    for (int n = 0; n < KMAX; ++n) {
      if (KK == KMAX || n < KK)
        *reinterpret_cast<float2*>(dkb + kp * dks.s + 8 * n + 2 * t4) =
            make_float2(adk[4 * n + 2 * r] * scale, adk[4 * n + 2 * r + 1] * scale);
      if (KKV == KMAX || n < KKV)
        *reinterpret_cast<float2*>(dvb + kp * dvs.s + 8 * n + 2 * t4) =
            make_float2(adv[4 * n + 2 * r], adv[4 * n + 2 * r + 1]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int H, int group, int S, int T_len, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    int window, float scale) {
  using L = Shape<D, DV>;
  constexpr int PS = L::PS, PSV = L::PSV, NS = L::DQ_STAGES;
  constexpr int KK = D / 8, KKV = DV / 8, KMAX = KK > KKV ? KK : KKV;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  float* sq = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  float* sdo = sq + BR * PS;
  float* ring = sdo + BR * PSV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  // heaviest (latest) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int k_hi = min(T_len, min(S, q0 + BR));
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BT, total = max(0, (k_hi + BT - 1) / BT - t_lo);

  init_barriers(full, empty, NS);
  load_rows<D, PS>(sq, q + b * qs.b + h * qs.h, qs.s, q0, BR, S, tid);
  load_rows<DV, PSV>(sdo, dO + b * dos.b + h * dos.h, dos.s, q0, BR, S, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = warp - CONSUMER_WARPS;
    const float* kb = k + b * ks.b + hk * ks.h;
    const float* vb = v + b * vs.b + hk * vs.h;
    for (int idx = 0; idx < total; ++idx) {
      const int s = idx % NS;
      tc::mbar_wait(&empty[s], ((idx / NS) & 1) ^ 1);
      float* st = ring + s * L::DQ_STAGE;
      stage_rows<D, DV>(st, st + L::TL, kb, ks.s, st + 2 * L::TL, nullptr, vb, vs.s,
                        (t_lo + idx) * BT, T_len, pw, lane);
      tc::fence_proxy_async();
      tc::mbar_arrive(&full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 16 * (warp & 3);    // this warp's first query
  const float* sqw = sq + (r0 - q0) * PS;
  const float* sdow = sdo + (r0 - q0) * PSV;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lr[r] = row < S ? lse[(long long)bh * S + row] : 0.f;
    dr[r] = row < S ? di[(long long)bh * S + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // warpgroup wg takes the tiles wg, wg + 2, ...
  for (int idx = wg; idx < total; idx += 2) {
    const int s = idx % NS;
    tc::mbar_wait(&full[s], (idx / NS) & 1);
    const int kt0 = (t_lo + idx) * BT;
    // does a query of this CTA, of this warp, see a key of the tile?
    const bool wg_on = q0 < S && kt0 <= q0 + BR - 1 &&
                       !(window > 0 && q0 - (kt0 + BT - 1) >= window);
    const bool warp_on = r0 < S && kt0 <= r0 + 15 &&
                         !(window > 0 && r0 - (kt0 + BT - 1) >= window);
    if (wg_on) {
      const float* skt = ring + s * L::DQ_STAGE;
      const float* sklo = skt + L::TL;
      const float* svt = skt + 2 * L::TL;
      uint32_t ab[2][4], as[2][4];
      if (warp_on) {
        // s = q·kᵀ and dp = dO·vᵀ, [16 queries, BT keys] per warp
        float sc[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < KMAX; ++kk) {
          const bool on_s = KK == KMAX || kk < KK, on_dp = KKV == KMAX || kk < KKV;
          uint32_t qb_[4], qs_[4], ob[4], os_[4];
          if (on_s) a_rows<PS>(sqw, kk, g, t4, qb_, qs_);
          if (on_dp) a_rows<PSV>(sdow, kk, g, t4, ob, os_);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = tl_off(8 * kk + 2 * t4, 8 * j + g);
            if (on_s) tc::mma3<false>(sc[j], qb_, qs_, skt[o], skt[o + 4]);
            if (on_dp) tc::mma3<false>(dp[j], ob, os_, svt[o], svt[o + 4]);
          }
        }
        // element e of sc[j]: query r0 + g + 8·(e >> 1), key kt0 + 8j + 2t
        // + (e & 1); it becomes ds, split as the A fragment of k step j
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + g + 8 * (e >> 1);
            const int kp = kt0 + 8 * j + 2 * t4 + (e & 1);
            const float p = visible(qp, kp, S, T_len, window)
                                ? expf(sc[j][e] * scale - lr[e >> 1])
                                : 0.f;
            sc[j][e] = p * (dp[j][e] - dr[e >> 1]);
          }
          tc::split4(sc[j][0], sc[j][2], sc[j][1], sc[j][3], ab[j], as[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ab[j][e] = as[j][e] = 0u;
      }
      // dq += ds·k on the warpgroup's tensor cores
      tc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) wgmma3<D>(acc, ab[j], as[j], tile_desc(skt, j), tile_desc(sklo, j));
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[s]);  // this stage is consumed
  }

  pair_sum(acc, ring, wg);  // the two warpgroups' sums
  if (wg == 1) return;
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + g + 8 * r;
    if (qp >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dqb + qp * dqs.s + 8 * n + 2 * t4) =
          make_float2(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
  }
}

struct Args {
  const float *q, *k, *v, *o, *dO, *lse;
  float *di, *dq, *dk, *dv;
  int B, H, Hkv, S, T_len, window;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <int D, int DV>
int launch(const Args& a, cudaStream_t stream) {
  using L = Shape<D, DV>;
  const float scale = (float)(1.0 / sqrt((double)D));  // the forward's
  const int group = a.H / a.Hkv;
  const long long rows = (long long)a.B * a.H * a.S;
  flash_bwd_dot_kernel<<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS),
                         32 * DOT_WARPS, 0, stream>>>(
      a.o, a.dO, a.di, a.H, a.S, DV, a.os, a.dos, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv = flash_bwd_dkdv_kernel<D, DV>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::KV_BYTES);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.B * a.Hkv, (a.T_len + BR - 1) / BR), THREADS, L::KV_BYTES,
       stream>>>(a.q, a.k, a.v, a.dO, a.lse, a.di, a.dk, a.dv, a.H, group,
                 a.S, a.T_len, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
                 a.window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto qk = flash_bwd_dq_kernel<D, DV>;
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::DQ_BYTES);
  if (err != cudaSuccess) return err;
  qk<<<dim3(a.B * a.H, (a.S + BR - 1) / BR), THREADS, L::DQ_BYTES, stream>>>(
      a.q, a.k, a.v, a.dO, a.lse, a.di, a.dq, a.H, group, a.S, a.T_len, a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0], out[1]: the dK/dV and the dQ CTAs of head dimensions (D, DV)
// that one SM of the current card holds at once (the occupancy
// calculator, with each kernel's dynamic shared memory); out[2], out[3]:
// those bytes
int flash_bwd_ctas_per_sm(int D, int DV, void* out) {
  int* o = static_cast<int*>(out);
  const auto query = [o](auto kv, auto qk, int kv_bytes, int dq_bytes) {
    cudaError_t e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kv_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kv, THREADS, kv_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[1], qk, THREADS, dq_bytes);
    o[2] = kv_bytes;
    o[3] = dq_bytes;
    return static_cast<int>(e);
  };
#define BWD_CASE(DD, VV)                                                                \
  if (D == DD && DV == VV)                                                              \
    return query(flash_bwd_dkdv_kernel<DD, VV>, flash_bwd_dq_kernel<DD, VV>,            \
                 Shape<DD, VV>::KV_BYTES, Shape<DD, VV>::DQ_BYTES);
  BWD_CASE(64, 64)
  BWD_CASE(80, 80)
  BWD_CASE(96, 96)
  BWD_CASE(128, 128)
  BWD_CASE(96, 64)
  BWD_CASE(192, 128)
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

// float32 only.  q, dq [B, H, S, D], o, dO [B, H, S, DV], k, dk [B, Hkv,
// T, D] and v, dv [B, Hkv, T, DV] through (batch, head, sequence) element
// strides, the head dimension contiguous, every row start 16-byte
// aligned (the wrapper checks); lse (the forward's) and di (scratch) [B,
// H, S] contiguous.  Causal; window > 0 adds the sliding window.  Returns
// cudaErrorInvalidValue for a (D, DV) without an instance ((64, 64), (80,
// 80), (96, 96), (128, 128), (96, 64), (192, 128)).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const void* lse,
                        void* di, void* dq, void* dk, void* dv, int B, int H,
                        int Hkv, int S, int T_len, int D, int DV, long long qsb,
                        long long qsh, long long qss, long long ksb,
                        long long ksh, long long kss, long long vsb,
                        long long vsh, long long vss, long long osb,
                        long long osh, long long oss, long long dosb,
                        long long dosh, long long doss, long long dqsb,
                        long long dqsh, long long dqss, long long dksb,
                        long long dksh, long long dkss, long long dvsb,
                        long long dvsh, long long dvss, int window,
                        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || T_len <= 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(o),
               static_cast<const float*>(dO), static_cast<const float*>(lse),
               static_cast<float*>(di),       static_cast<float*>(dq),
               static_cast<float*>(dk),       static_cast<float*>(dv),
               B, H, Hkv, S, T_len, window,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, {dosb, dosh, doss}, {dqsb, dqsh, dqss},
               {dksb, dksh, dkss}, {dvsb, dvsh, dvss}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && DV == 64) return launch<64, 64>(a, st);
  if (D == 80 && DV == 80) return launch<80, 80>(a, st);
  if (D == 96 && DV == 96) return launch<96, 96>(a, st);
  if (D == 128 && DV == 128) return launch<128, 128>(a, st);
  if (D == 96 && DV == 64) return launch<96, 64>(a, st);
  if (D == 192 && DV == 128) return launch<192, 128>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
