// Hand-written Hopper (sm_90a) backward of B7 (wkv6.cu): the gradients of
// one layer's chunked RWKV-6 WKV6 scan, as a chunk-parallel pass around a
// scan of the dS carry.
//
// Replaces no Pallas kernel: the JAX package trains through the plain jnp
// scan of src/repro/models/rwkv6.py:100 _wkv_chunked and lets XLA
// differentiate it, while the port routes the training forward through B7
// on the card, so the gradient needs kernels of its own.  It
// differentiates the chunked, clamped form that B7 and
// ref.wkv6_chunk_plain compute (for one (b, h) and a chunk of Q' tokens,
// with c the inclusive cumsum of log w, ce = c - log w, cl = c[Q'-1],
// mid = cl / 2):
//
//   RD = r·e^{clip(ce - mid, ±40)}   KG = k·e^{clip(mid - c, ±40)}
//   RS = r·e^{max(ce, -80)}          KE = k·e^{max(cl - c, -80)}
//   A  = RD·KGᵀ on j < t, 0 elsewhere;  diag_t = Σ_a r·u·k
//   y  = A·v + diag·v + RS·S_in;     S_out = e^{max(cl, -80)}·S_in + KEᵀ·v
//
// Given dy and dS_out (the carry from the next chunk; dS_final or zeros
// for the last), each chunk's gradients are
//
//   dA = dy·vᵀ on j < t     dv = Aᵀ·dy + KE·dS_out + diag·dy
//   dRD = dA·KG             dKG = dAᵀ·RD
//   dRS = dy·S_inᵀ          dKE = v·dS_outᵀ
//   dS_in = RSᵀ·dy + e^{max(cl, -80)}·dS_out
//   dr = dRD·e^{..} + dRS·e^{..} + (Σ_n dy·v)·u·k, dk likewise, du summed
//   over tokens, chunks, then b; each clamp passes its exponent's gradient
//   x = dRD·RD (and so on) only where it does not bite (torch.clamp's
//   rule, bounds inclusive), mid's and cl's gradients are summed over the
//   chunk, d(log w) is the suffix sum of dc minus dce, and dw = d(log w) /
//   w (torch.log's backward).
//
// Only the carry is sequential, and it enters linearly: dS_in_c =
// e^{max(cl_c, -80)} ⊙rows dS_out_c + P_c with P_c = RS_cᵀ·dy_c, which
// needs only the chunk's r, w and dy.  Every other term needs only the
// chunk's own inputs, the state it started from (the forward writes it,
// S_chunks [B, H, C, K, K]) and its dS_out.  So one layer's call is four
// kernels, all on the current stream:
//
//   1. wkv6_bwd_carry_kernel<K> (grid B·H·C): P_c [K, K] into a scratch
//      [B, H, C, K, K] and e^{max(cl_c, -80)} [B, H, C, K]; the cumsum is
//      the forward's quad-shuffle scan, P_c one 3xTF32 product.
//   2. wkv6_bwd_scan_kernel<K> (a thread per entry of B·H·K·K): from the
//      last chunk to the first, dS_out_c (the running carry) is written in
//      place of P_c, then carry <- e^{max(cl_c, -80)}·carry + P_c; the
//      last carry is dS_in.  Sixteen chunks' loads in flight.
//   3. wkv6_bwd_chunk_kernel<K>: a persistent grid (the occupancy
//      calculator's CTAs: one of 512 threads an SM, 213 KB of shared
//      memory at K = 64) over the B·H·C chunk tiles; each tile's r, k, v,
//      w, dy, S_in and dS_out arrive by 16-byte cp.async, the next tile's
//      issued as soon as this one's products have read theirs.  The eight
//      products (Aᵀ, dA, dv's two, dRD, dKG, dRS, dKE) run on 3xTF32
//      mma.sync m16n8k8 (tf32_mma.cuh), as B7's forward does, each of the
//      16 warps on 16 rows and a quarter of the columns, the big and the
//      correction products in separate accumulators; the triangular ones
//      skip the tiles and k steps that are zero.  The per-channel work
//      (the cumsum, then dr, dk, the clamp terms and dw) runs with the
//      lanes along the channels (every row access coalesced) and each
//      warp on a block of tokens: sums inside a block in registers, across
//      blocks through shared memory in block order.  A thread keeps its
//      block's r, k, w and cumsum in registers from the factors to dw, so
//      nothing is read twice from the card's memory.  du's partial of the
//      tile goes to [B, H, C, K].
//   4. wkv6_bwd_du_kernel<K> (grid H): du = Σ_b Σ_c of the partials, over
//      chunks, then b, in order.
//
// No atomics: every sum has a fixed order, so two launches give the same
// bits.
//
// What bounds it on this card: bytes.  At [1, 4096, 64, 64] with chunk 64
// the data needs 0.67 GB (r, k, v, w, dy and the chunk states in; dr, dk,
// dv, dw out), 0.20 ms at 3.35 TB/s; this design moves about 1.15 GB (the
// scratch written, read and written again by the scan, read once more;
// r, w, dy read twice), 0.34 ms.  Its 14 GFLOP of products (42 GFLOP of
// TF32 tensor operations at 3xTF32) take 0.08 ms at 495 TFLOP/s.  The
// design it replaces walked the 64 chunks of a (b, h) in order on one SM
// (64 CTAs for 132 SMs) with the products as FP32 FMAs from shared
// memory: 3.7 ms.
//
// Layout: r, k, v, w [B, S, H, K] through (batch, token, head) element
// strides with the channel contiguous, dy through its own, dr, dk, dv, dw
// through a third set; every row start 16-byte aligned (the wrapper
// checks).  u [H, K], S_chunks and the scratch contiguous.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launches; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;          // the carry, scan kernels
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_THREADS = 512;    // the chunk kernel
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int MQ = 64;  // the longest chunk
constexpr float LC = 40.0f;

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -LC), LC));
}
__device__ __forceinline__ float floor_exp(float x) {
  return expf(fmaxf(x, -2.f * LC));
}
__device__ __forceinline__ bool in_clip(float x) {
  return x >= -LC && x <= LC;
}

// elements (i, k) and (i, k + 1) of an operand in shared memory: with
// KFAST at p[i·s + k] (one 8-byte load), else at p[k·s + i]
template <bool KFAST>
__device__ __forceinline__ float2 pair(const float* p, int s, int i, int k) {
  if constexpr (KFAST) {
    return *reinterpret_cast<const float2*>(p + i * s + k);
  } else {
    return make_float2(p[k * s + i], p[(k + 1) * s + i]);
  }
}

// One warp: c[i] (the 16 × 8 tile at rows m0.., columns n0 + 8i..) +=
// Σ_{k0 <= x < k1} A(row, x)·B(x, col) in 3xTF32, k0 and k1 multiples of
// 8; A(i, x) = pair<AK>(A, as, i, x), B(x, j) = pair<BK>(Bm, bs, j, x).
// Tiles whose bit in `live` is clear are not computed (known zeros).  The
// k index of each 8-wide step is permuted as in tf32_mma.cuh: fragment
// k = t, t + 4 is the physical 2t, 2t + 1 in A and B alike.  The big·big
// products and the correction terms sum in separate accumulators (two
// dependent chains a tile, not one), added at the end.
template <int NT, bool AK, bool BK>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* A, int as, int m0,
                                        const float* Bm, int bs, int n0, int k0, int k1,
                                        unsigned live, int g, int t4) {
  float cs[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) cs[i][e] = 0.f;
#pragma unroll 2
  for (int ks = k0; ks < k1; ks += 8) {
    uint32_t ab[4], asl[4];
    const float2 x = pair<AK>(A, as, m0 + g, ks + 2 * t4);
    const float2 y = pair<AK>(A, as, m0 + g + 8, ks + 2 * t4);
    tc::split4(x.x, y.x, x.y, y.y, ab, asl);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if ((live >> i) & 1u) {
        const float2 b = pair<BK>(Bm, bs, n0 + 8 * i + g, ks + 2 * t4);
        tc::mma3<false>(c[i], cs[i], ab, asl, b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] += cs[i][e];
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// c's tiles to a row-major [.][s] array in shared memory (8-byte stores)
template <int NT>
__device__ __forceinline__ void store_tiles(const float (&c)[NT][4], float* p, int s, int m0,
                                            int n0, int g, int t4) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = n0 + 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(p + (m0 + g) * s + col) = make_float2(c[i][0], c[i][1]);
    *reinterpret_cast<float2*>(p + (m0 + g + 8) * s + col) = make_float2(c[i][2], c[i][3]);
  }
}

// The cumsum over tokens of channel a's log w, from w[t·s + a] in shared
// memory (0 past Qc), held by LPC lanes: lane seg = lane % LPC holds
// tokens LPC·j + seg.  By shuffles: a scan inside each step of LPC tokens,
// independent across steps, then a running carry (at LPC = 4 B7's
// forward's quad scan, bit for bit).  Fills lw and cc (the inclusive
// cumsum) and returns the chunk's total cl.
template <int LPC>
__device__ __forceinline__ float lane_cumsum(const float* wv, int s, int a, int Qc, int seg,
                                             float (&lw)[MQ / LPC], float (&cc)[MQ / LPC]) {
#pragma unroll
  for (int j = 0; j < MQ / LPC; ++j) {
    const int t = LPC * j + seg;
    lw[j] = t < Qc ? logf(wv[t * s + a]) : 0.f;
    float x = lw[j];
#pragma unroll
    for (int o = 1; o < LPC; o <<= 1) {
      const float p = __shfl_up_sync(0xffffffffu, x, o, LPC);
      if (seg >= o) x += p;
    }
    cc[j] = x;
  }
  float carry = 0.f;
#pragma unroll
  for (int j = 0; j < MQ / LPC; ++j) {
    const float tot = __shfl_sync(0xffffffffu, cc[j], LPC - 1, LPC);
    cc[j] = carry + cc[j];
    carry += tot;
  }
  return carry;
}

// ---- 1. the chunk-local carry terms P_c = RS_cᵀ·dy_c and e^{max(cl, -80)}

template <int K>
struct CarrySmem {
  static constexpr int XS = K + 8;   // w, r [MQ][K]: A-operand rows
  static constexpr int YS = K + 4;   // dy [MQ][K]: the B operand by rows
  static constexpr int TS = MQ + 8;  // RSᵀ [K][MQ]
  static constexpr int W = 0, R = W + MQ * XS, DY = R + MQ * XS, RST = DY + MQ * YS,
                       FLOATS = RST + K * TS;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

template <int K>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_carry_kernel(const float* __restrict__ r, const float* __restrict__ w,
                      const float* __restrict__ dy, float* __restrict__ P,
                      float* __restrict__ ecl, int H, int S_len, int Q, int C,
                      long long sb, long long ss, long long sh, long long yb,
                      long long ys, long long yh) {
  using L = CarrySmem<K>;
  constexpr int CR = K / 4;                 // 16-byte pieces a row
  constexpr int MT = K / 16;                // m-tiles of P
  constexpr int NSPLIT = WARPS / MT;        // warps on one m-tile
  constexpr int NT = K / 8 / NSPLIT;        // n-tiles a warp
  static_assert(MT * NSPLIT == WARPS && NT >= 1, "the warp map of P");
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long tile = blockIdx.x, bh = tile / C;
  const int ci = static_cast<int>(tile % C), b = static_cast<int>(bh / H),
            h = static_cast<int>(bh % H);
  const int c0 = ci * Q, Qc = min(Q, S_len - c0);
  const long long ib = b * sb + h * sh, iy = b * yb + h * yh;
  for (int i = tid; i < MQ * CR; i += THREADS) {
    const int t = i / CR, col = (i % CR) * 4;
    const bool in = t < Qc;
    const long long row = in ? c0 + t : 0;
    tc::cp_async16(sm + L::W + t * L::XS + col, w + ib + row * ss + col, in);
    tc::cp_async16(sm + L::R + t * L::XS + col, r + ib + row * ss + col, in);
    tc::cp_async16(sm + L::DY + t * L::YS + col, dy + iy + row * ys + col, in);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  {
    constexpr int LPC = THREADS / K;  // lanes a channel
    const int a = tid / LPC, seg = tid % LPC;
    float lw[MQ / LPC], cc[MQ / LPC];
    const float cl = lane_cumsum<LPC>(sm + L::W, L::XS, a, Qc, seg, lw, cc);
    if (seg == 0) ecl[tile * K + a] = floor_exp(cl);
#pragma unroll
    for (int j = 0; j < MQ / LPC; ++j) {
      const int t = LPC * j + seg;
      sm[L::RST + a * L::TS + t] = sm[L::R + t * L::XS + a] * floor_exp(cc[j] - lw[j]);
    }
  }
  __syncthreads();

  const int m0 = 16 * (warp / NSPLIT), n0 = (warp % NSPLIT) * 8 * NT;
  float c[NT][4];
  zero(c);
  warp_mm<NT, true, false>(c, sm + L::RST, L::TS, m0, sm + L::DY, L::YS, n0, 0,
                           (Qc + 7) / 8 * 8, ~0u, g, t4);
  float* out = P + tile * K * K;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = n0 + 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(out + (m0 + g) * K + col) = make_float2(c[i][0], c[i][1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * K + col) = make_float2(c[i][2], c[i][3]);
  }
}

// ---- 2. the carry scan, last chunk first; dS_out_c replaces P_c

template <int K>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_scan_kernel(float* __restrict__ P, const float* __restrict__ ecl,
                     const float* __restrict__ dS_final, float* __restrict__ dS_in, int C,
                     long long n) {
  constexpr int KK = K * K, DEPTH = 16;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / KK;
  const int e = static_cast<int>(i % KK), a = e / K;
  float* p = P + bh * C * KK + e;
  const float* el = ecl + bh * C * K + a;
  float carry = dS_final != nullptr ? dS_final[i] : 0.f;
  float pc[DEPTH], ec[DEPTH];
  int c0 = C - 1;
  for (; c0 >= DEPTH - 1; c0 -= DEPTH) {  // DEPTH chunks' loads in flight
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      pc[u] = p[static_cast<long long>(c0 - u) * KK];
      ec[u] = el[static_cast<long long>(c0 - u) * K];
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      p[static_cast<long long>(c0 - u) * KK] = carry;
      carry = ec[u] * carry + pc[u];
    }
  }
  if (c0 >= 0) {  // the last c0 + 1 < DEPTH chunks, their loads in flight too
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (u <= c0) {
        pc[u] = p[static_cast<long long>(c0 - u) * KK];
        ec[u] = el[static_cast<long long>(c0 - u) * K];
      }
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (u <= c0) {
        p[static_cast<long long>(c0 - u) * KK] = carry;
        carry = ec[u] * carry + pc[u];
      }
    }
  }
  dS_in[i] = carry;
}

// ---- 3. the chunk-parallel gradients, a persistent grid over the tiles

// Shared-memory layout in floats.  The seven inputs of a tile (W, R, KY
// are then overwritten in place by KE, RD, KG), the [MQ][MQ] products and
// dRS; at the end of the products the slots AT, DA, DAT take dRD, dKG,
// dKE for the per-channel pass.  BT and PART hold the per-channel passes'
// sums of each block of tokens ([blocks][K]: the log-decay totals; then
// mid's, cl's, du's and dc's).  Rows 16-byte aligned for cp.async.
template <int K>
struct ChunkSmem {
  static constexpr int XS = K + 8;   // [MQ][K] and [K][K]
  static constexpr int TS = MQ + 8;  // [MQ][MQ]
  static constexpr int QX = MQ * XS, KX = K * XS, QT = MQ * TS;
  static constexpr int W = 0, R = W + QX, KY = R + QX, V = KY + QX, DY = V + QX,
                       ST = DY + QX, DS = ST + KX, AT = DS + KX, DA = AT + QT,
                       DAT = DA + QT, DRS = DAT + QT, U = DRS + QX, DIAG = U + K,
                       DDIAG = DIAG + MQ, DECL = DDIAG + MQ, BT = DECL + K,
                       PART = BT + CHUNK_THREADS, FLOATS = PART + 4 * CHUNK_THREADS;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

struct Tile {
  int b, h, ci, c0, Qc;
  long long bh;
};

__device__ __forceinline__ Tile tile_of(long long tile, int H, int C, int S_len, int Q) {
  Tile x;
  x.bh = tile / C;
  x.ci = static_cast<int>(tile % C);
  x.b = static_cast<int>(x.bh / H);
  x.h = static_cast<int>(x.bh % H);
  x.c0 = x.ci * Q;
  x.Qc = min(Q, S_len - x.c0);
  return x;
}

// issues the cp.async copies of one tile's inputs (rows past Qc zero-filled)
template <int K>
__device__ __forceinline__ void load_tile(float* sm, const Tile& x, const float* r,
                                          const float* k, const float* v, const float* w,
                                          const float* dy, const float* S_chunks,
                                          const float* dS_out, int C, long long sb,
                                          long long ss, long long sh, long long yb,
                                          long long ys, long long yh, int tid) {
  using L = ChunkSmem<K>;
  constexpr int CR = K / 4;
  const long long ib = x.b * sb + x.h * sh, iy = x.b * yb + x.h * yh;
  for (int i = tid; i < MQ * CR; i += CHUNK_THREADS) {
    const int t = i / CR, col = (i % CR) * 4, o = t * L::XS + col;
    const bool in = t < x.Qc;
    const long long row = in ? x.c0 + t : 0, gi = ib + row * ss + col;
    tc::cp_async16(sm + L::W + o, w + gi, in);
    tc::cp_async16(sm + L::R + o, r + gi, in);
    tc::cp_async16(sm + L::KY + o, k + gi, in);
    tc::cp_async16(sm + L::V + o, v + gi, in);
    tc::cp_async16(sm + L::DY + o, dy + iy + row * ys + col, in);
  }
  const long long kk = (x.bh * C + x.ci) * K * K;
  for (int i = tid; i < K * CR; i += CHUNK_THREADS) {
    const int a = i / CR, col = (i % CR) * 4, o = a * L::XS + col;
    tc::cp_async16(sm + L::ST + o, S_chunks + kk + a * K + col, true);
    tc::cp_async16(sm + L::DS + o, dS_out + kk + a * K + col, true);
  }
}


template <int K>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
wkv6_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ S_chunks,
                      const float* __restrict__ dy, const float* __restrict__ dS_out,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du_part, int H, int S_len, int Q, int C,
                      long long n_tiles, long long sb, long long ss, long long sh,
                      long long yb, long long ys, long long yh, long long gb,
                      long long gs, long long gh) {
  using L = ChunkSmem<K>;
  constexpr int XS = L::XS, TS = L::TS;
  constexpr int NTQ = MQ / 32;  // n-tiles a warp of a [MQ][MQ] product
  constexpr int NTK = K / 32;   // n-tiles a warp of a [MQ][K] product
  constexpr int LPC = CHUNK_THREADS / K;  // lanes a channel, Σ_n S_in·dS_out
  constexpr int TPT = CHUNK_THREADS / MQ; // lanes a token, per-token sums
  constexpr int CHW = K / 32;             // warps across the channels
  constexpr int NB = CHUNK_WARPS / CHW;   // blocks of tokens, per-channel passes
  constexpr int TB = MQ / NB;             // tokens a block
  static_assert(K % 32 == 0 && K <= MQ && CHUNK_WARPS == 16 && LPC <= 32 && TPT <= 32 &&
                    NB * TB == MQ,
                "the warp map");
  extern __shared__ __align__(16) float sm[];
  float *W = sm + L::W, *R = sm + L::R, *KY = sm + L::KY, *V = sm + L::V,
        *DY = sm + L::DY, *ST = sm + L::ST, *DS = sm + L::DS, *AT = sm + L::AT,
        *DA = sm + L::DA, *DAT = sm + L::DAT, *DRS = sm + L::DRS, *U = sm + L::U,
        *DIAG = sm + L::DIAG, *DDIAG = sm + L::DDIAG, *DECL = sm + L::DECL,
        *BT = sm + L::BT, *PART = sm + L::PART;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // every product: this warp's 16 rows and a quarter of the columns
  const int m0 = 16 * (warp >> 2), nq = (warp & 3) * (MQ / 4), nk = (warp & 3) * (K / 4);
  // the per-channel passes: channel ca (lanes along the channels, so every
  // row access is coalesced), tokens t0 .. t0 + TB - 1 of block tb
  const int ca = (warp % CHW) * 32 + lane, tb = warp / CHW, t0 = tb * TB;

  if (blockIdx.x < n_tiles)
    load_tile<K>(sm, tile_of(blockIdx.x, H, C, S_len, Q), r, k, v, w, dy, S_chunks, dS_out,
                 C, sb, ss, sh, yb, ys, yh, tid);
  tc::cp_async_commit();

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile x = tile_of(tile, H, C, S_len, Q);
    const int Qc = x.Qc, kq = (Qc + 7) / 8 * 8;
    tc::cp_async_wait<0>();
    __syncthreads();  // the inputs are in; the previous tile is done

    // ---- per token: diag = Σ r·u·k, ddiag = Σ dy·v (TPT lanes a token);
    // per channel: Σ_n S_in·dS_out (LPC lanes a channel)
    {
      const int t = tid / TPT, part = tid % TPT;
      float dg = 0.f, ddg = 0.f;
#pragma unroll 4
      for (int a = part; a < K; a += TPT) {
        dg += R[t * XS + a] * __ldg(u + x.h * K + a) * KY[t * XS + a];
        ddg += DY[t * XS + a] * V[t * XS + a];
      }
#pragma unroll
      for (int o = 1; o < TPT; o <<= 1) {
        dg += __shfl_xor_sync(0xffffffffu, dg, o);
        ddg += __shfl_xor_sync(0xffffffffu, ddg, o);
      }
      if (part == 0) {
        DIAG[t] = dg;
        DDIAG[t] = ddg;
      }
      const int da = tid / LPC, q = tid % LPC;
      float s = 0.f;
#pragma unroll 4
      for (int n = q; n < K; n += LPC) s += ST[da * XS + n] * DS[da * XS + n];
#pragma unroll
      for (int o = 1; o < LPC; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (q == 0) DECL[da] = s;
      if (tid < K) U[tid] = __ldg(u + x.h * K + tid);
    }
    __syncthreads();

    // ---- the cumsum of log w over the chunk (each block's own, then the
    // totals of the blocks before it) and the factors, in place: RD over
    // r, KG over k, KE over w.  The block's r, k, w, its cumsum cc and cl
    // stay in registers for the per-channel pass at the end.
    float rv[TB], kv[TB], wv[TB], cc[TB], cl = 0.f;
    {
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int o = (t0 + j) * XS + ca;
        const bool in = t0 + j < Qc;
        wv[j] = in ? W[o] : 1.f;
        rv[j] = R[o];
        kv[j] = KY[o];
        run += in ? logf(wv[j]) : 0.f;
        cc[j] = run;
      }
      BT[tb * K + ca] = run;
    }
    __syncthreads();
    {
      float pre = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float tot = BT[b * K + ca];
        if (b < tb) pre += tot;
        cl += tot;
      }
      const float mid = 0.5f * cl;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int o = (t0 + j) * XS + ca;
        cc[j] = pre + cc[j];
        const float lw = t0 + j < Qc ? logf(wv[j]) : 0.f;
        const float c = cc[j], ce = c - lw, rr = rv[j], kk = kv[j];
        R[o] = rr * clip_exp(ce - mid);
        KY[o] = kk * clip_exp(mid - c);
        W[o] = kk * floor_exp(cl - c);
      }
    }
    __syncthreads();

    // ---- Aᵀ [j][t] = KG·RDᵀ where t > j; dA [t][j] = dy·vᵀ where j < t
    // (also as dAᵀ [j][t]); tiles wholly on the zero side are skipped
    {
      unsigned up = 0, lo = 0;
#pragma unroll
      for (int i = 0; i < NTQ; ++i) {
        up |= (nq + 8 * i + 7 > m0 ? 1u : 0u) << i;
        lo |= (nq + 8 * i < m0 + 15 ? 1u : 0u) << i;
      }
      float c[NTQ][4];
      zero(c);
      warp_mm<NTQ, true, true>(c, KY, XS, m0, R, XS, nq, 0, K, up, g, t4);
#pragma unroll
      for (int i = 0; i < NTQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1), col = nq + 8 * i + 2 * t4 + (e & 1);
          if (col <= row) c[i][e] = 0.f;
        }
      store_tiles(c, AT, TS, m0, nq, g, t4);
      zero(c);
      warp_mm<NTQ, true, true>(c, DY, XS, m0, V, XS, nq, 0, K, lo, g, t4);
#pragma unroll
      for (int i = 0; i < NTQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1), col = nq + 8 * i + 2 * t4 + (e & 1);
          if (col >= row) c[i][e] = 0.f;
          DAT[col * TS + row] = c[i][e];
        }
      store_tiles(c, DA, TS, m0, nq, g, t4);
    }
    __syncthreads();

    // ---- dv = Aᵀ·dy + KE·dS_out + diag·dy (to the card's memory); dRS to
    // shared memory; dKE, dRD, dKG kept in registers.  Aᵀ is zero for t <=
    // j and dA for j >= t, so their k ranges start or end at the rows.
    float cke[NTK][4], crd[NTK][4], ckg[NTK][4];
    zero(cke);
    zero(crd);
    zero(ckg);
    if (m0 < Qc) {
      float c[NTK][4];
      zero(c);
      warp_mm<NTK, true, false>(c, AT, TS, m0, DY, XS, nk, m0, kq, ~0u, g, t4);
      warp_mm<NTK, true, false>(c, W, XS, m0, DS, XS, nk, 0, K, ~0u, g, t4);
      const long long ig = x.b * gb + x.h * gh;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = m0 + g + 8 * hf;
        if (j >= Qc) continue;
        const float dg = DIAG[j];
#pragma unroll
        for (int i = 0; i < NTK; ++i) {
          const int n = nk + 8 * i + 2 * t4;
          const float2 yy = *reinterpret_cast<const float2*>(DY + j * XS + n);
          *reinterpret_cast<float2*>(dv + ig + (long long)(x.c0 + j) * gs + n) =
              make_float2(c[i][2 * hf] + dg * yy.x, c[i][2 * hf + 1] + dg * yy.y);
        }
      }
      zero(c);
      warp_mm<NTK, true, true>(c, DY, XS, m0, ST, XS, nk, 0, K, ~0u, g, t4);
      store_tiles(c, DRS, XS, m0, nk, g, t4);
      warp_mm<NTK, true, true>(cke, V, XS, m0, DS, XS, nk, 0, K, ~0u, g, t4);
      warp_mm<NTK, true, false>(crd, DA, TS, m0, KY, XS, nk, 0, min(m0 + 16, kq), ~0u, g,
                                t4);
      warp_mm<NTK, true, false>(ckg, DAT, TS, m0, R, XS, nk, m0, kq, ~0u, g, t4);
    } else {
      float c[NTK][4];
      zero(c);
      store_tiles(c, DRS, XS, m0, nk, g, t4);
    }
    __syncthreads();  // every read of the inputs and of Aᵀ, dA, dAᵀ is done

    // ---- dRD, dKG, dKE over Aᵀ, dA, dAᵀ; the next tile starts loading
    store_tiles(crd, AT, TS, m0, nk, g, t4);
    store_tiles(ckg, DA, TS, m0, nk, g, t4);
    store_tiles(cke, DAT, TS, m0, nk, g, t4);
    if (tile + gridDim.x < n_tiles)
      load_tile<K>(sm, tile_of(tile + gridDim.x, H, C, S_len, Q), r, k, v, w, dy, S_chunks,
                   dS_out, C, sb, ss, sh, yb, ys, yh, tid);
    tc::cp_async_commit();
    __syncthreads();

    // ---- per channel, a block of tokens a thread: dr, dk, the clamp
    // terms; mid's, cl's, du's and dc's sums over the blocks; d(log w) as
    // dcl + the dc of the later blocks + a suffix sum inside the block; dw
    {
      const long long ig = x.b * gb + x.h * gh;
      const int a = ca;
      float dce[TB], dc[TB];
      const float mid = 0.5f * cl, uu = U[a];
      float dmid = 0.f, ske = 0.f, dua = 0.f, dct = 0.f;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int t = t0 + j;
        dce[j] = dc[j] = 0.f;
        if (t >= Qc) continue;
        const long long off = static_cast<long long>(x.c0 + t);
        const float rr = rv[j], kk = kv[j];
        const float c = cc[j], ce = c - logf(wv[j]);
        const float aRD = ce - mid, aKG = mid - c, aKE = cl - c;
        const float eRD = clip_exp(aRD), eKG = clip_exp(aKG), eRS = floor_exp(ce),
                    eKE = floor_exp(aKE);
        const float drd = AT[t * TS + a], dkg = DA[t * TS + a], drs = DRS[t * XS + a],
                    dke = DAT[t * TS + a], dd = DDIAG[t];
        dr[ig + off * gs + a] = drd * eRD + drs * eRS + dd * uu * kk;
        dk[ig + off * gs + a] = dkg * eKG + dke * eKE + dd * rr * uu;
        const float xRD = in_clip(aRD) ? drd * (rr * eRD) : 0.f;
        const float xKG = in_clip(aKG) ? dkg * (kk * eKG) : 0.f;
        const float xRS = ce >= -2.f * LC ? drs * (rr * eRS) : 0.f;
        const float xKE = aKE >= -2.f * LC ? dke * (kk * eKE) : 0.f;
        dce[j] = xRD + xRS;
        dc[j] = dce[j] - xKG - xKE;
        dmid += xKG - xRD;
        ske += xKE;
        dua += dd * rr * kk;
        dct += dc[j];
      }
      PART[(0 * NB + tb) * K + a] = dmid;
      PART[(1 * NB + tb) * K + a] = ske;
      PART[(2 * NB + tb) * K + a] = dua;
      PART[(3 * NB + tb) * K + a] = dct;
      __syncthreads();
      float dmidt = 0.f, sket = 0.f, duat = 0.f, post = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        dmidt += PART[(0 * NB + b) * K + a];
        sket += PART[(1 * NB + b) * K + a];
        duat += PART[(2 * NB + b) * K + a];
      }
#pragma unroll
      for (int b = NB - 1; b > 0; --b)
        if (b > tb) post += PART[(3 * NB + b) * K + a];
      // d(log w)_t = dcl + Σ_{s >= t} dc_s - dce_t
      float run = sket + (cl >= -2.f * LC ? DECL[a] * floor_exp(cl) : 0.f) + 0.5f * dmidt;
      run += post;
#pragma unroll
      for (int j = TB - 1; j >= 0; --j) {
        run += dc[j];
        const int t = t0 + j;
        if (t < Qc) dw[ig + static_cast<long long>(x.c0 + t) * gs + a] = (run - dce[j]) / wv[j];
      }
      if (tb == 0) du_part[tile * K + a] = duat;
    }
  }
}

// ---- 4. du [H, K]: the tiles' partials summed over chunks, then over b

template <int K>
__global__ void __launch_bounds__(K)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
                   int C) {
  const int h = blockIdx.x, a = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = du_part + ((long long)b * H + h) * C * K + a;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += p[(long long)c * K];
    acc = b == 0 ? s : acc + s;
  }
  du[h * K + a] = acc;
}

// CTAs of the chunk kernel the current card holds at once (cached per
// device), after its shared-memory opt-in
template <int K>
cudaError_t chunk_grid(int* grid) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  constexpr int bytes = ChunkSmem<K>::BYTES;
  e = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_carry_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CarrySmem<K>::BYTES);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wkv6_bwd_chunk_kernel<K>,
                                                      CHUNK_THREADS, bytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  if (dev < 64) cached[dev] = *grid;
  return cudaSuccess;
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* S_chunks, const float* dy, const float* dS_final, float* dr,
           float* dk, float* dv, float* dw, float* du, float* dS_in, float* P, float* ecl,
           float* du_part, int B, int H, int S_len, int Q, long long sb, long long ss,
           long long sh, long long yb, long long ys, long long yh, long long gb,
           long long gs, long long gh, cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = chunk_grid<K>(&grid);
  if (e != cudaSuccess) return e;
  const int C = (S_len + Q - 1) / Q;
  const long long n_tiles = static_cast<long long>(B) * H * C;
  wkv6_bwd_carry_kernel<K><<<static_cast<unsigned>(n_tiles), THREADS, CarrySmem<K>::BYTES,
                             stream>>>(r, w, dy, P, ecl, H, S_len, Q, C, sb, ss, sh, yb, ys,
                                       yh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long n = static_cast<long long>(B) * H * K * K;
  wkv6_bwd_scan_kernel<K><<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0,
                            stream>>>(P, ecl, dS_final, dS_in, C, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int chunk_ctas = static_cast<int>(n_tiles < grid ? n_tiles : grid);
  wkv6_bwd_chunk_kernel<K><<<chunk_ctas, CHUNK_THREADS, ChunkSmem<K>::BYTES, stream>>>(
      r, k, v, w, u, S_chunks, dy, P, dr, dk, dv, dw, du_part, H, S_len, Q, C, n_tiles, sb,
      ss, sh, yb, ys, yh, gb, gs, gh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv6_bwd_du_kernel<K><<<H, K, 0, stream>>>(du_part, du, B, H, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r/k/v/w [B, S, H, K] through (sb, ss, sh), dy through (yb, ys, yh), dr,
// dk, dv, dw through (gb, gs, gh), element strides over (batch, token,
// head) with the channel contiguous, every row start 16-byte aligned.
// u [H, K]; S_chunks [B, H, C, K, K] (the forward's, C = ceil(S / Q));
// dS_final [B, H, K, K] or null (zeros); du [H, K]; dS_in [B, H, K, K];
// the scratch P [B, H, C, K, K], ecl [B, H, C, K] and du_part [B, H, C,
// K] float32; all contiguous.  Chunks of Q tokens (1..64), the last one
// ragged.  Four launches on `stream`.  Returns cudaErrorInvalidValue for
// a K without an instance (32, 64) or Q outside 1..64.
int wkv6_seq_bwd(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* S_chunks, const void* dy,
                 const void* dS_final, void* dr, void* dk, void* dv, void* dw, void* du,
                 void* dS_in, void* P, void* ecl, void* du_part, int B, int H, int S_len,
                 int Q, int K, long long sb, long long ss, long long sh, long long yb,
                 long long ys, long long yh, long long gb, long long gs, long long gh,
                 void* stream) {
  if (B <= 0 || H <= 0 || S_len <= 0 || Q <= 0 || Q > MQ) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u), *cp = static_cast<const float*>(S_chunks),
              *yp = static_cast<const float*>(dy), *fp = static_cast<const float*>(dS_final);
  float *drp = static_cast<float*>(dr), *dkp = static_cast<float*>(dk),
        *dvp = static_cast<float*>(dv), *dwp = static_cast<float*>(dw),
        *dup = static_cast<float*>(du), *dsp = static_cast<float*>(dS_in),
        *pp = static_cast<float*>(P), *ep = static_cast<float*>(ecl),
        *dpp = static_cast<float*>(du_part);
  if (K == 32)
    return launch<32>(rp, kp, vp, wp, up, cp, yp, fp, drp, dkp, dvp, dwp, dup, dsp, pp, ep,
                      dpp, B, H, S_len, Q, sb, ss, sh, yb, ys, yh, gb, gs, gh, st);
  if (K == 64)
    return launch<64>(rp, kp, vp, wp, up, cp, yp, fp, drp, dkp, dvp, dwp, dup, dsp, pp, ep,
                      dpp, B, H, S_len, Q, sb, ss, sh, yb, ys, yh, gb, gs, gh, st);
  return cudaErrorInvalidValue;
}

// out[0]: CTAs of the chunk kernel an SM holds, out[1] its dynamic shared
// memory in bytes, out[2] the carry kernel's shared memory in bytes, at
// this K (32, 64)
int wkv6_bwd_resources(int K, void* out) {
  int* o = static_cast<int*>(out);
  int grid = 0, sms = 0, dev = 0;
  cudaError_t e = K == 32 ? chunk_grid<32>(&grid)
                  : K == 64 ? chunk_grid<64>(&grid)
                            : cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  o[0] = grid / sms;
  o[1] = K == 32 ? ChunkSmem<32>::BYTES : ChunkSmem<64>::BYTES;
  o[2] = K == 32 ? CarrySmem<32>::BYTES : CarrySmem<64>::BYTES;
  return cudaSuccess;
}

}  // extern "C"
