// Hand-written Hopper (sm_90a) kernel for the chunked RWKV-6 WKV6 scan of
// one layer's prompt: every chunk of every (batch, head) in ONE launch,
// with the [K, K] state kept on chip from the first chunk to the last
// (models/rwkv6.py:_wkv_chunked calls it once per layer).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:
// wkv6_chunk_pallas (_wkv_chunk_kernel), which is one step of the scan body
// of the JAX model's rwkv6._wkv_chunked; this kernel runs that whole scan.
// For one (batch, head) and each chunk of Q tokens (the last one may hold
// Q' < Q), with r/k/v/w [Q, K], u [K] and the carried state S [K, K]:
//
//   c    = inclusive cumsum of log w along the chunk;   ce = c - log w
//   mid  = ½·c[Q-1]
//   A    = (r·e^{clip(ce - mid, ±40)}) · (k·e^{clip(mid - c, ±40)})ᵀ, j < t
//   y    = A·v + (Σ_k r·u·k)·v + (r·e^{max(ce, -80)})·S
//   S   <- e^{max(c[Q-1], -80)}·S + (k·e^{max(c[Q-1] - c, -80)})ᵀ·v
//
// The cumsum, mid and the clamps are local to each chunk.  A ragged last
// chunk is computed over its Q' tokens: its rows past Q' are read as
// r = k = v = 0 and log w = 0, which is exactly the JAX pad (w = 1, zeros).
//
// What bounds it on this card: bytes.  At rwkv6-7b's layer [B=4, S=512,
// H=64, K=64] r, k, v, w and y are 5 × 33.5 MB and S0, S_final 2 × 4.2 MB:
// 176 MB, 52.6 µs at 3.35 TB/s, against 3.2 GFLOP of products, 48 µs on
// the FP32 pipes.  The kernel it replaces ran once per chunk (8 launches a
// layer), re-read and re-wrote the state each time and computed one output
// per thread with two shared-memory loads per FMA: 0.86 ms a layer.
//
// Design:
//   * Grid B·H: one CTA owns one (b, h) and all K value columns (256 CTAs
//     at rwkv6-7b's shape).  Splitting the columns over two CTAs was
//     measured slower (PERF.md): the decay factors and the [Q, Q]
//     scores, most of a CTA's time, would run twice, and the smaller
//     footprint still fits only one CTA per SM.
//   * The state [K, K] is read from S0 once, stays in shared memory
//     across all chunks, and is written to S_final once.
//   * Prefetch: as soon as the decay factors of chunk c are built, chunk
//     c + 1's r, k, w, v [Q, K] tiles start loading with 16-byte cp.async
//     copies, while chunk c's products run.
//   * The four products run on the tensor cores (mma.sync m16n8k8 TF32
//     with the 3xTF32 split of tf32_mma.cuh, which keeps float32
//     accuracy): A = r_dec·k_growᵀ over its 20 lower 16 × 8 tiles, then
//     per warp 16 tokens × K/2 columns of y = A·v and r_state·S, and 16
//     channels × K/2 columns of k_endᵀ·v.  On the FP32 pipes the same
//     products were bound by shared-memory loads (two vector loads per 16
//     FMAs); an mma fragment carries 1024 multiply-adds per six loads.
//     A's entries on and above the diagonal are set to exactly 0 (the
//     model's where: an entry above the diagonal, whose clipped factors
//     may overflow, never reaches y).
//   * Parallel cumsum: 4 lanes per channel hold interleaved tokens; each
//     step of 4 tokens is a quad scan by shuffles, independent across
//     steps, then a running carry; spread over all warps.
//   * logf / expf, not the fast intrinsics; y sums as the JAX expression,
//     (A·v + diag·v) + r_state·S.
//   * Layout: r/k/v/w are read and y written through (batch, token, head)
//     element strides with the channel contiguous, so the model's
//     [B, S, H, K] buffers go in and come out with no copy.  u [H, K], S0
//     and S_final [B, H, K, K] are contiguous.  The wrapper checks that
//     every input row start is 16-byte aligned.
//   * Shared memory: 200 KB at K = 64 (one CTA of 256 threads per SM), opted in with cudaFuncSetAttribute.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MQ = 64;  // the longest chunk
constexpr float LOG_CLAMP = 40.0f;

// Shared-memory layout in floats.  Row strides are picked for the mma
// fragment loads: ≡ 8 (mod 32) where a fragment reads two neighbours of a
// row (8-byte loads, A operands and B = Mᵀ), ≡ 4 (mod 16) where it reads
// one element of two neighbouring rows (B = M); all keep rows 16-byte
// aligned for the cp.async copies.
template <int K>
struct Smem {
  static constexpr int XS = K + 8;    // raw r / k / w and r_dec, k_grow, r_state
  static constexpr int VS = K + 4;    // raw v, v and the state
  static constexpr int TS = MQ + 8;   // A [t][j] and k_endᵀ [a][t]
  static constexpr int X_R = 0, X_K = X_R + MQ * XS, X_W = X_K + MQ * XS,
                       X_V = X_W + MQ * XS, RD = X_V + MQ * VS,
                       KG = RD + MQ * XS, RS = KG + MQ * XS,
                       KET = RS + MQ * XS, AM = KET + K * TS,
                       V = AM + MQ * TS, ST = V + MQ * VS, DIAG = ST + K * VS,
                       ECL = DIAG + MQ, U = ECL + K, FLOATS = U + K;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

// chunk [c0, c0 + Qc) of one (b, h), all K channels of r, k, w and v;
// rows past Qc are zero-filled
template <int K>
__device__ __forceinline__ void load_chunk(float* sm, const float* r,
                                           const float* k, const float* w,
                                           const float* v, long long ss,
                                           int c0, int Qc, int tid) {
  using L = Smem<K>;
  constexpr int CR = K / 4;  // 16-byte pieces per row
  for (int i = tid; i < MQ * CR; i += THREADS) {
    const int t = i / CR, col = (i % CR) * 4;
    const bool in = t < Qc;
    const long long off = (in ? (long long)(c0 + t) : 0) * ss + col;
    tc::cp_async16(sm + L::X_R + t * L::XS + col, r + off, in);
    tc::cp_async16(sm + L::X_K + t * L::XS + col, k + off, in);
    tc::cp_async16(sm + L::X_W + t * L::XS + col, w + off, in);
    tc::cp_async16(sm + L::X_V + t * L::VS + col, v + off, in);
  }
}

// split A fragment of a k step from a row-major [m][k] array: rows m0 + g
// and m0 + g + 8, columns 8·ks + 2t, + 1
__device__ __forceinline__ void a_frag(const float* m, int stride, int m0,
                                       int ks, int g, int t4,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 x = *reinterpret_cast<const float2*>(
      m + (m0 + g) * stride + 8 * ks + 2 * t4);
  const float2 y = *reinterpret_cast<const float2*>(
      m + (m0 + g + 8) * stride + 8 * ks + 2 * t4);
  tc::split4(x.x, y.x, x.y, y.y, big, small);
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_seq_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ S0,
                float* __restrict__ y, float* __restrict__ S_out,
                float* __restrict__ S_chunks, int H, int S_len, int Q,
                long long sb, long long ss, long long sh, long long yb,
                long long ys, long long yh) {
  using L = Smem<K>;
  constexpr int NT = K / 16;             // n-tiles of 8 per warp (two halves)
  static_assert(K % 16 == 0 && K <= MQ && MQ == 64 &&
                    WARPS == 8,
                "tile shapes and the warp map of A");
  extern __shared__ __align__(16) float sm[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long ib = b * sb + h * sh;
  const float *rb = r + ib, *kb = k + ib, *wb = w + ib, *vb = v + ib;
  float* yo = y + b * yb + h * yh;
  // y and S: this warp's 16 rows (tokens for y, channels for S) and its
  // half of the K columns
  const int mt = warp >> 1, nh = (warp & 1) * 8 * NT;

  load_chunk<K>(sm, rb, kb, wb, vb, ss, 0, min(Q, S_len), tid);
  tc::cp_async_commit();
  const float* s0 = S0 + (long long)bh * K * K;
  for (int i = tid; i < K * K; i += THREADS)
    sm[L::ST + (i / K) * L::VS + i % K] = s0[i];
  for (int i = tid; i < K; i += THREADS) sm[L::U + i] = u[h * K + i];

  const int n_chunks = (S_len + Q - 1) / Q;
  for (int c0 = 0; c0 < S_len; c0 += Q) {
    const int Qc = min(Q, S_len - c0);
    const int ksq = (Qc + 7) / 8;  // k steps over this chunk's tokens
    tc::cp_async_wait<0>();
    __syncthreads();
    // training calls: the chunk's incoming state, for the backward (the
    // state is next written after the barrier that ends its reads)
    if (S_chunks != nullptr) {
      float* sc = S_chunks + ((long long)bh * n_chunks + c0 / Q) * K * K;
      for (int i = tid; i < K * K; i += THREADS)
        sc[i] = sm[L::ST + (i / K) * L::VS + i % K];
    }

    // ---- cumulative log-decay and the decay factors ----
    // lane: channel a = 8·warp + lane/4 (+ 64 i), tokens 4j + lane%4; each
    // step of 4 tokens is a quad scan, then a running carry
    const int seg = lane & 3;
    for (int a = 8 * warp + (lane >> 2); a < K; a += 8 * WARPS) {
      float lw[MQ / 4], cc[MQ / 4];
#pragma unroll
      for (int j = 0; j < MQ / 4; ++j) {
        const int t = 4 * j + seg;
        lw[j] = t < Qc ? logf(sm[L::X_W + t * L::XS + a]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < MQ / 4; ++j) {
        float x = lw[j];
        const float p = __shfl_up_sync(0xffffffffu, x, 1, 4);
        cc[j] = seg >= 1 ? x + p : x;
      }
#pragma unroll
      for (int j = 0; j < MQ / 4; ++j) {
        const float p = __shfl_up_sync(0xffffffffu, cc[j], 2, 4);
        if (seg >= 2) cc[j] += p;
      }
      float carry = 0.f;
#pragma unroll
      for (int j = 0; j < MQ / 4; ++j) {
        const float tot = __shfl_sync(0xffffffffu, cc[j], 3, 4);
        cc[j] = carry + cc[j];
        carry += tot;
      }
      const float cl = carry, mid = 0.5f * cl;
      if (seg == 0) sm[L::ECL + a] = expf(fmaxf(cl, -2.f * LOG_CLAMP));
#pragma unroll
      for (int j = 0; j < MQ / 4; ++j) {
        const int t = 4 * j + seg;
        const float c = cc[j], ce = c - lw[j];
        const float rr = sm[L::X_R + t * L::XS + a];
        const float kk = sm[L::X_K + t * L::XS + a];
        sm[L::RD + t * L::XS + a] =
            rr * expf(fminf(fmaxf(ce - mid, -LOG_CLAMP), LOG_CLAMP));
        sm[L::RS + t * L::XS + a] = rr * expf(fmaxf(ce, -2.f * LOG_CLAMP));
        sm[L::KG + t * L::XS + a] =
            kk * expf(fminf(fmaxf(mid - c, -LOG_CLAMP), LOG_CLAMP));
        sm[L::KET + a * L::TS + t] =
            kk * expf(fmaxf(cl - c, -2.f * LOG_CLAMP));
      }
    }
    // bonus diagonal Σ_k (r·u)·k per token: 4 lanes per token
    {
      constexpr int PER = K / 4;
      const int t = tid >> 2, part = tid & 3;
      float acc = 0.f;
      for (int a = part * PER; a < (part + 1) * PER; ++a)
        acc += sm[L::X_R + t * L::XS + a] * sm[L::U + a] *
               sm[L::X_K + t * L::XS + a];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) sm[L::DIAG + t] = acc;
    }
    for (int i = tid; i < MQ * K; i += THREADS)
      sm[L::V + (i / K) * L::VS + i % K] =
          sm[L::X_V + (i / K) * L::VS + i % K];
    __syncthreads();

    // ---- the raw tiles are consumed: start loading the next chunk ----
    if (c0 + Q < S_len)
      load_chunk<K>(sm, rb, kb, wb, vb, ss, c0 + Q, min(Q, S_len - c0 - Q),
                    tid);
    tc::cp_async_commit();

    // ---- A = r_dec·k_growᵀ over the lower 16 × 8 tiles, j < t kept ----
    // warp w: token rows 16·mt (mt = 3 - w/2) and half of their 2·mt + 2
    // tiles, all at once (one split A fragment per k step, independent
    // accumulator chains)
    {
      const int amt = 3 - (warp >> 1), nj = amt + 1;
      const int m0 = 16 * amt, j0 = (warp & 1) * nj;
      if (m0 < Qc) {
        float c[4][4], cc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][e] = cc[i][e] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < K / 8; ++ks) {
          uint32_t ab[4], as[4];
          a_frag(sm + L::RD, L::XS, m0, ks, g, t4, ab, as);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < nj) {
              const float2 kg = *reinterpret_cast<const float2*>(
                  sm + L::KG + (8 * (j0 + i) + g) * L::XS + 8 * ks + 2 * t4);
              tc::mma3<false>(c[i], cc[i], ab, as, kg.x, kg.y);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= nj) break;
          const int jn = j0 + i;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + g + 8 * (e >> 1);
            const int col = 8 * jn + 2 * t4 + (e & 1);
            // the model's where: j < t only
            c[i][e] = col >= row ? 0.f : c[i][e] + cc[i][e];
          }
          *reinterpret_cast<float2*>(sm + L::AM + (m0 + g) * L::TS + 8 * jn +
                                     2 * t4) = make_float2(c[i][0], c[i][1]);
          *reinterpret_cast<float2*>(sm + L::AM + (m0 + g + 8) * L::TS +
                                     8 * jn + 2 * t4) =
              make_float2(c[i][2], c[i][3]);
        }
      }
    }
    __syncthreads();

    // ---- y = (A·v + diag·v) + r_state·S for 16 tokens × 8·NT columns and
    // S' = k_endᵀ·v for 16 channels × 8·NT columns, in one loop over the
    // k steps: up to 3·NT independent accumulator chains ----
    const int m0 = 16 * mt;
    const bool y_mine = m0 < Qc, s_mine = m0 < K;
    const int kj = min(2 * mt + 2, ksq);  // A is zero past the diagonal
    float y1[NT][4], y2[NT][4], sn[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) y1[i][e] = y2[i][e] = sn[i][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < MQ / 8; ++ks) {
      const float* v0 = sm + L::V + (8 * ks + 2 * t4) * L::VS + nh + g;
      if (y_mine && ks < kj) {
        uint32_t ab[4], as[4];
        a_frag(sm + L::AM, L::TS, m0, ks, g, t4, ab, as);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          tc::mma3<false>(y1[i], ab, as, v0[8 * i], v0[L::VS + 8 * i]);
      }
      if (y_mine && ks < K / 8) {
        uint32_t ab[4], as[4];
        a_frag(sm + L::RS, L::XS, m0, ks, g, t4, ab, as);
        const float* s0p = sm + L::ST + (8 * ks + 2 * t4) * L::VS + nh + g;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          tc::mma3<false>(y2[i], ab, as, s0p[8 * i], s0p[L::VS + 8 * i]);
      }
      if (s_mine && ks < ksq) {
        uint32_t ab[4], as[4];
        a_frag(sm + L::KET, L::TS, m0, ks, g, t4, ab, as);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          tc::mma3<false>(sn[i], ab, as, v0[8 * i], v0[L::VS + 8 * i]);
      }
    }
    if (y_mine) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = m0 + g + 8 * hf;
        if (t >= Qc) continue;
        const float dg = sm[L::DIAG + t];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int n = nh + 8 * i + 2 * t4;
          const float2 vv =
              *reinterpret_cast<const float2*>(sm + L::V + t * L::VS + n);
          const float o0 = (y1[i][2 * hf] + dg * vv.x) + y2[i][2 * hf];
          const float o1 = (y1[i][2 * hf + 1] + dg * vv.y) + y2[i][2 * hf + 1];
          *reinterpret_cast<float2*>(yo + (long long)(c0 + t) * ys + n) =
              make_float2(o0, o1);
        }
      }
    }
    if (s_mine) {  // S <- e^{max(c_last, -80)}·S + k_endᵀ·v
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int a = m0 + g + 8 * hf;
        const float e = sm[L::ECL + a];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int n = nh + 8 * i + 2 * t4;
          const float2 sv =
              *reinterpret_cast<const float2*>(sm + L::ST + a * L::VS + n);
          sn[i][2 * hf] = e * sv.x + sn[i][2 * hf];
          sn[i][2 * hf + 1] = e * sv.y + sn[i][2 * hf + 1];
        }
      }
    }
    __syncthreads();  // every read of S is done
    if (s_mine) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int a = 16 * mt + g + 8 * hf;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          *reinterpret_cast<float2*>(sm + L::ST + a * L::VS + nh + 8 * i +
                                     2 * t4) =
              make_float2(sn[i][2 * hf], sn[i][2 * hf + 1]);
      }
    }
  }
  __syncthreads();
  float* so = S_out + (long long)bh * K * K;
  for (int i = tid; i < K * K; i += THREADS)
    so[i] = sm[L::ST + (i / K) * L::VS + i % K];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* S0, float* y, float* S_out,
           float* S_chunks, int B, int H, int S_len, int Q, long long sb,
           long long ss, long long sh, long long yb, long long ys,
           long long yh, cudaStream_t stream) {
  constexpr int bytes = Smem<K>::BYTES;
  auto kern = wkv6_seq_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * H, THREADS, bytes, stream>>>(r, k, v, w, u, S0, y, S_out,
                                         S_chunks, H, S_len, Q, sb, ss, sh,
                                         yb, ys, yh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r/k/v/w [B, S, H, K] through element strides (sb, ss, sh) over (batch,
// token, head), the channel contiguous, every row start 16-byte aligned;
// y likewise through (yb, ys, yh).  u [H, K], S0 and S_out [B, H, K, K]
// contiguous.  Chunks of Q tokens (1..64), the last one ragged.  S_chunks,
// when not null, receives each chunk's incoming state, [B, H, C, K, K]
// float32 contiguous with C = ceil(S / Q) (the backward's input; the serve
// path passes null).  Returns cudaErrorInvalidValue for a K without an
// instance (32, 64) or Q outside 1..64.
int wkv6_seq_fwd(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* S0, void* y, void* S_out,
                 void* S_chunks, int B,
                 int H, int S_len, int Q, int K, long long sb,
                 long long ss, long long sh, long long yb, long long ys,
                 long long yh, void* stream) {
  if (B <= 0 || H <= 0 || S_len <= 0 || Q <= 0 || Q > MQ)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *sp = static_cast<const float*>(S0);
  float *yp = static_cast<float*>(y), *op = static_cast<float*>(S_out),
        *cp = static_cast<float*>(S_chunks);
  if (K == 32)
    return launch<32>(rp, kp, vp, wp, up, sp, yp, op, cp, B, H, S_len, Q, sb,
                      ss, sh, yb, ys, yh, st);
  if (K == 64)
    return launch<64>(rp, kp, vp, wp, up, sp, yp, op, cp, B, H, S_len, Q, sb,
                      ss, sh, yb, ys, yh, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
