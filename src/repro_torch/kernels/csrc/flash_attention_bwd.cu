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
// (query, key) pair (s twice, dp twice, dv, dk, dq): at [1, 16, 8, 4096,
// 128] 1.72e11 FLOPs, 1.04 ms by 3xTF32 at 495 TFLOP/s (2.56 ms on the
// FP32 pipes); q, k, v, o, dO, dq, dk, dv are 0.1 GB, 0.03 ms.
//
// Route: the forward's 3xTF32 mma.sync m16n8k8 fragments (tf32_mma.cuh),
// which keep float32 accuracy.  A simple design first (wgmma and TMA are
// later work):
//   * dK/dV: one CTA of 4 warps per (b, kv head, 64-key tile); each warp
//     owns 16 keys, holds its dk and dv [16, D] accumulators in registers,
//     and walks the group's query heads and the query tiles (32 rows) that
//     see its keys: sᵀ = k·qᵀ and dpᵀ = v·dOᵀ with k and v as the A
//     operands from shared memory, then pᵀ and dsᵀ go from the accumulator
//     layout to the A fragment in registers (the forward's P·V
//     permutation) for dv += pᵀ·dO and dk += dsᵀ·q.  q, dO, lse and Di
//     stream through a two-stage cp.async ring.  The GQA group is summed
//     inside the CTA, so no atomics.  Earliest key tiles (the heaviest
//     under the causal mask) launch first.
//   * dQ: one CTA of 4 warps per (b, head, 64-query tile), the forward's
//     shape: q and dO in shared memory, k and v tiles (64 rows) in a
//     two-stage ring; s and dp per warp, ds = p(dp - Di) in registers and
//     straight into dq += ds·k.
//   * Tiles and warps skip work no visible pair reaches, as in the
//     forward; masked pairs take p = 0.
//   * Every shared row is D + 8 floats (8-byte fragment loads along d hit
//     32 banks; the column reads of the dv/dk/dq products take a 2-way
//     conflict).  Shared memory at D = 128: dK/dV 136 KB, dQ 204 KB,
//     opted in with cudaFuncSetAttribute.
//   * expf and IEEE arithmetic, not the fast intrinsics.
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

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // rows a CTA owns: keys (dK/dV), queries (dQ)
constexpr int BT = 64;          // dQ: key rows per streamed tile
constexpr int BQT = 32;         // dK/dV: query rows per streamed tile
constexpr int DOT_WARPS = 8;    // Di pre-pass: rows per block

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

template <int D>
struct Shape {
  static constexpr int PS = D + 8;  // shared row stride, floats
  // dQ: q, dO [BR] rows, then two stages of k, v [BT] rows
  static constexpr int DQ_STAGE = 2 * BT * PS;
  static constexpr int DQ_BYTES = (2 * BR * PS + 2 * DQ_STAGE) * 4;
  // dK/dV: k, v [BR] rows, then two stages of q, dO [BQT] rows, lse, Di
  static constexpr int KV_STAGE = 2 * BQT * PS + 2 * BQT;
  static constexpr int KV_BYTES = (2 * BR * PS + 2 * KV_STAGE) * 4;
};

// rows [r0, r0 + n) of one (batch, head) into shared memory with 16-byte
// cp.async copies; rows at or past `limit` are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int r0, int n,
                                          int limit, int tid) {
  constexpr int CH = D / 4;  // 16-byte pieces per row
  for (int i = tid; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const int s = r0 + r;
    const bool in = s < limit;
    tc::cp_async16(dst + r * Shape<D>::PS + c,
                   src + (in ? (long long)s : 0) * ss + c, in);
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

template <int D>
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
  using L = Shape<D>;
  constexpr int PS = L::PS, KK = D / 8, ND = D / 8, NJ = BQT / 8;
  extern __shared__ __align__(16) float sm[];
  float* sk = sm;
  float* sv = sm + BR * PS;
  float* ring = sv + BR * PS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int Hkv = H / group;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BR;  // earliest (heaviest) key tiles first
  const int kw0 = k0 + 16 * warp;  // this warp's first key

  // query tiles that see some key of this tile, for each head of the group
  const int qt_lo = k0 / BQT;
  const int q_hi = window > 0 ? min(S, k0 + BR - 1 + window) : S;
  const int n_qt = max(0, (q_hi + BQT - 1) / BQT - qt_lo);
  const int total = group * n_qt;

  auto load_tile = [&](int idx) {
    const int h = hk * group + idx / n_qt;
    const int q0 = (qt_lo + idx % n_qt) * BQT;
    float* st = ring + (idx & 1) * L::KV_STAGE;
    load_rows<D>(st, q + b * qs.b + h * qs.h, qs.s, q0, BQT, S, tid);
    load_rows<D>(st + BQT * PS, dO + b * dos.b + h * dos.h, dos.s, q0, BQT, S,
                 tid);
    if (tid < BQT) {
      const bool in = q0 + tid < S;
      const long long row = ((long long)b * H + h) * S + q0 + tid;
      st[2 * BQT * PS + tid] = in ? lse[row] : 0.f;
      st[2 * BQT * PS + BQT + tid] = in ? di[row] : 0.f;
    }
  };

  load_rows<D>(sk, k + b * ks.b + hk * ks.h, ks.s, k0, BR, T_len, tid);
  load_rows<D>(sv, v + b * vs.b + hk * vs.h, vs.s, k0, BR, T_len, tid);
  if (total > 0) load_tile(0);
  tc::cp_async_commit();

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  const float* skw = sk + 16 * warp * PS;
  const float* svw = sv + 16 * warp * PS;
  for (int idx = 0; idx < total; ++idx) {
    if (idx + 1 < total) load_tile(idx + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile idx has landed (and the k, v rows)
    __syncthreads();

    const float* sq = ring + (idx & 1) * L::KV_STAGE;
    const float* sdo = sq + BQT * PS;
    const float* sl = sq + 2 * BQT * PS;
    const float* sdi = sl + BQT;
    const int q0 = (qt_lo + idx % n_qt) * BQT;
    // does any query of this tile see any key of this warp?
    const bool skip = kw0 >= T_len || q0 + BQT - 1 < kw0 ||
                      (window > 0 && q0 - (kw0 + 15) >= window);
    if (!skip) {
      // sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, [16 keys, BQT queries] per warp
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t kb[4], ks_[4], vb[4], vs_[4];
        a_rows<PS>(skw, kk, g, t4, kb, ks_);
        a_rows<PS>(svw, kk, g, t4, vb, vs_);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 qv = ld2(sq + (8 * j + g) * PS + 8 * kk + 2 * t4);
          tc::mma3<false>(s[j], kb, ks_, qv.x, qv.y);
          const float2 dv2 = ld2(sdo + (8 * j + g) * PS + 8 * kk + 2 * t4);
          tc::mma3<false>(dp[j], vb, vs_, dv2.x, dv2.y);
        }
      }
      // element e of s[j]: key kw0 + g + 8·(e >> 1), query q0 + 8j + 2t +
      // (e & 1); s becomes pᵀ and dp becomes dsᵀ
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kw0 + g + 8 * (e >> 1);
          const int qi = 8 * j + 2 * t4 + (e & 1);
          const float p = visible(q0 + qi, kp, S, T_len, window)
                              ? expf(s[j][e] * scale - sl[qi])
                              : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sdi[qi]);
        }
      // dv += pᵀ·dO and dk += dsᵀ·q: the k index t / t+4 of the mma is
      // query 2t / 2t+1 of the n-tile, which the thread holds
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4], db[4], ds[4];
        tc::split4(s[j][0], s[j][2], s[j][1], s[j][3], pb, ps);
        tc::split4(dp[j][0], dp[j][2], dp[j][1], dp[j][3], db, ds);
        const float* o0 = sdo + (8 * j + 2 * t4) * PS + g;
        const float* q0p = sq + (8 * j + 2 * t4) * PS + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          tc::mma3<false>(adv[n], pb, ps, o0[8 * n], o0[PS + 8 * n]);
          tc::mma3<false>(adk[n], db, ds, q0p[8 * n], q0p[PS + 8 * n]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kw0 + g + 8 * r;
    if (kp >= T_len) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dkb + kp * dks.s + 8 * n + 2 * t4) =
          make_float2(adk[n][2 * r] * scale, adk[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvb + kp * dvs.s + 8 * n + 2 * t4) =
          make_float2(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int H, int group, int S, int T_len, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    int window, float scale) {
  using L = Shape<D>;
  constexpr int PS = L::PS, KK = D / 8, ND = D / 8, NJ = BT / 8;
  extern __shared__ __align__(16) float sm[];
  float* sq = sm;
  float* sdo = sm + BR * PS;
  float* ring = sdo + BR * PS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  // heaviest (latest) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int r0 = q0 + 16 * warp;  // this warp's first query row

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int k_hi = min(T_len, min(S, q0 + BR));
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BT, t_hi = (k_hi + BT - 1) / BT;

  load_rows<D>(sq, q + b * qs.b + h * qs.h, qs.s, q0, BR, S, tid);
  load_rows<D>(sdo, dO + b * dos.b + h * dos.h, dos.s, q0, BR, S, tid);
  if (t_lo < t_hi) {
    load_rows<D>(ring, kb, ks.s, t_lo * BT, BT, T_len, tid);
    load_rows<D>(ring + BT * PS, vb, vs.s, t_lo * BT, BT, T_len, tid);
  }
  tc::cp_async_commit();

  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lr[r] = row < S ? lse[(long long)bh * S + row] : 0.f;
    dr[r] = row < S ? di[(long long)bh * S + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float* sqw = sq + 16 * warp * PS;
  const float* sdow = sdo + 16 * warp * PS;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BT;
    if (t + 1 < t_hi) {
      float* nxt = ring + ((t + 1 - t_lo) & 1) * L::DQ_STAGE;
      load_rows<D>(nxt, kb, ks.s, k0 + BT, BT, T_len, tid);
      load_rows<D>(nxt + BT * PS, vb, vs.s, k0 + BT, BT, T_len, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();

    const float* skt = ring + ((t - t_lo) & 1) * L::DQ_STAGE;
    const float* svt = skt + BT * PS;
    const bool skip = r0 >= S || k0 > r0 + 15 ||
                      (window > 0 && k0 + BT - 1 <= r0 - window);
    if (!skip) {
      // s = q·kᵀ and dp = dO·vᵀ, [16 queries, BT keys] per warp
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t qb_[4], qs_[4], ob[4], os_[4];
        a_rows<PS>(sqw, kk, g, t4, qb_, qs_);
        a_rows<PS>(sdow, kk, g, t4, ob, os_);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv = ld2(skt + (8 * j + g) * PS + 8 * kk + 2 * t4);
          tc::mma3<false>(s[j], qb_, qs_, kv.x, kv.y);
          const float2 vv = ld2(svt + (8 * j + g) * PS + 8 * kk + 2 * t4);
          tc::mma3<false>(dp[j], ob, os_, vv.x, vv.y);
        }
      }
      // element e of s[j]: query r0 + g + 8·(e >> 1), key k0 + 8j + 2t +
      // (e & 1); s becomes ds
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + g + 8 * (e >> 1);
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const float p = visible(qp, kp, S, T_len, window)
                              ? expf(s[j][e] * scale - lr[e >> 1])
                              : 0.f;
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      // dq += ds·k: the k index t / t+4 is key 2t / 2t+1 of the n-tile
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ab[4], as[4];
        tc::split4(s[j][0], s[j][2], s[j][1], s[j][3], ab, as);
        const float* k0p = skt + (8 * j + 2 * t4) * PS + g;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          tc::mma3<false>(acc[n], ab, as, k0p[8 * n], k0p[PS + 8 * n]);
      }
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();

  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + g + 8 * r;
    if (qp >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(dqb + qp * dqs.s + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

struct Args {
  const float *q, *k, *v, *o, *dO, *lse;
  float *di, *dq, *dk, *dv;
  int B, H, Hkv, S, T_len, window;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  using L = Shape<D>;
  const float scale = (float)(1.0 / sqrt((double)D));  // the forward's
  const int group = a.H / a.Hkv;
  const long long rows = (long long)a.B * a.H * a.S;
  flash_bwd_dot_kernel<<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS),
                         32 * DOT_WARPS, 0, stream>>>(
      a.o, a.dO, a.di, a.H, a.S, D, a.os, a.dos, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv = flash_bwd_dkdv_kernel<D>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::KV_BYTES);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.B * a.Hkv, (a.T_len + BR - 1) / BR), THREADS, L::KV_BYTES,
       stream>>>(a.q, a.k, a.v, a.dO, a.lse, a.di, a.dk, a.dv, a.H, group,
                 a.S, a.T_len, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
                 a.window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto qk = flash_bwd_dq_kernel<D>;
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

// float32 only.  q, o, dO, dq [B, H, S, D] and k, v, dk, dv [B, Hkv, T, D]
// through (batch, head, sequence) element strides, the head dimension
// contiguous, every row start 16-byte aligned (the wrapper checks); lse
// (the forward's) and di (scratch) [B, H, S] contiguous.  Causal; window
// > 0 adds the sliding window.  Returns cudaErrorInvalidValue for a D
// without an instance (64, 80, 128).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const void* lse,
                        void* di, void* dq, void* dk, void* dv, int B, int H,
                        int Hkv, int S, int T_len, int D, long long qsb,
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
  switch (D) {
    case 64:
      return launch<64>(a, st);
    case 80:
      return launch<80>(a, st);
    case 128:
      return launch<128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
