// Hand-written Hopper (sm_90a) backward of B7 (wkv6.cu): the gradients of
// one layer's chunked RWKV-6 WKV6 scan, every chunk of every (batch, head)
// in ONE launch, the dS carry kept on chip from the last chunk to the
// first.
//
// Replaces no Pallas kernel: the JAX package trains through the plain jnp
// scan of rwkv6._wkv_chunked and lets XLA differentiate it, while the port
// routes the training forward through B7 on the card, so the gradient
// needs a kernel of its own.  It differentiates the chunked, clamped form
// that B7 and ref.wkv6_chunk_plain compute (for one (b, h) and a chunk of
// Q' tokens, with c the inclusive cumsum of log w, ce = c - log w,
// cl = c[Q'-1], mid = cl / 2):
//
//   RD = r·e^{clip(ce - mid, ±40)}   KG = k·e^{clip(mid - c, ±40)}
//   RS = r·e^{max(ce, -80)}          KE = k·e^{max(cl - c, -80)}
//   A  = RD·KGᵀ on j < t, 0 elsewhere;  diag_t = Σ_a r·u·k
//   y  = A·v + diag·v + RS·S_in;     S_out = e^{max(cl, -80)}·S_in + KEᵀ·v
//
// Given dy and dS_out (the carry from the next chunk; dS_final or zeros
// for the last), each chunk computes
//
//   dA = dy·vᵀ on j < t     dv = Aᵀ·dy + diag·dy + KE·dS_out
//   dRD = dA·KG             dKG = dAᵀ·RD
//   dRS = dy·S_inᵀ          dKE = v·dS_outᵀ
//   dS_in = RSᵀ·dy + e^{max(cl, -80)}·dS_out
//   dr = dRD·e^{..} + dRS·e^{..} + (Σ_n dy·v)·u·k, dk likewise, du as
//   per-(b, h) partials; then each clamp passes its exponent's gradient
//   x = dRD·RD (and so on) only where it does not bite (torch.clamp's
//   rule, bounds inclusive), mid's and cl's gradients are summed over the
//   chunk, d(log w) is the reverse cumsum of dc minus dce, and
//   dw = d(log w) / w (torch.log's backward).
//
// The state each chunk started from is not recomputed: the forward writes
// it (S_chunks [B, H, C, K, K]) when it is called for training.
//
// What bounds it on this card: operations on the FP32 pipes.  Eight
// [64, 64] products a chunk at K = 64 (2·8·64³ = 4.2 MFLOP): at rwkv6-7b's
// [2, 128, 64, 64] with chunk 64, 1.07 GFLOP, 16 µs at 67 TFLOP/s; its
// bytes (r, k, v, w, dy in, dr, dk, dv, dw out, the chunk states) are
// 33.6 MB, 10 µs.
//
// Design (a simple, correct kernel first):
//   * Grid B·H: one CTA of 256 threads per (b, h) walks its chunks in
//     reverse; the dS carry stays in shared memory throughout.
//   * Each chunk's r, k, v, w, dy and saved state are read into shared
//     memory, the factors RD, KG, RS, KE rebuilt from them (logf / expf,
//     the forward's formulas), and the eight products run as FP32 FMAs
//     from shared memory, each thread a 4 × 4 block (rows ri + 16i,
//     columns ci + 16j: every read of a row, a column or a transpose hits
//     distinct banks with the odd row strides K + 1 and 65).  dA reuses
//     A's place once dv has read A.
//   * dRD, dKG, dRS, dKE land on the same (token, channel) positions in
//     every thread's registers, so dr, dk and the clamp terms are formed
//     there with no round trip; the terms that need sums over tokens (mid,
//     cl, the reverse cumsum) go through shared memory to one thread per
//     channel.
//   * No atomics: du is written as per-(b, h) partials [B, H, K] that the
//     wrapper sums over b in a fixed order, so two launches give the same
//     bits.
//   * Shared memory: 213 KB at K = 64, opted in with cudaFuncSetAttribute.
//
// Layout: r, k, v, w [B, S, H, K] through (batch, token, head) element
// strides with the channel contiguous, dy through its own, dr, dk, dv, dw
// through a third set; u [H, K], S_chunks, dS_final, dS_in [.., K, K] and
// du_part [B, H, K] contiguous.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MQ = 64;  // the longest chunk
constexpr float LC = 40.0f;

// shared-memory layout in floats
template <int K>
struct Smem {
  static constexpr int LD = K + 1;   // [MQ][K] and [K][K] rows
  static constexpr int LQ = MQ + 1;  // [MQ][MQ] rows
  static constexpr int QK = MQ * LD, KK = K * LD;
  static constexpr int R = 0, KY = R + QK, V = KY + QK, DY = V + QK,
                       LW = DY + QK, C = LW + QK, RD = C + QK, KG = RD + QK,
                       RS = KG + QK, KE = RS + QK, AM = KE + QK,
                       ST = AM + MQ * LQ, DS = ST + KK, U = DS + KK,
                       CL = U + K, ECL = CL + K, DECL = ECL + K,
                       DIAG = DECL + K, DDIAG = DIAG + MQ,
                       FLOATS = DDIAG + MQ;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&a)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) a[i][j] = 0.f;
}

// acc[i][j] += Σ_{x < n} A(ri + 16i, x) · B(x, ci + 16j), with
// A(i, x) = A[i·ar + x·ac] and B(x, j) = B[x·br + j·bc] in shared memory
template <int MI, int NJ>
__device__ __forceinline__ void mm(float (&acc)[MI][NJ], const float* A,
                                   int ar, int ac, const float* Bm, int br,
                                   int bc, int n, int ri, int ci) {
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    float a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ri + 16 * i) * ar + x * ac];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Bm[x * br + (ci + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -LC), LC));
}
__device__ __forceinline__ bool in_clip(float x) {
  return x >= -LC && x <= LC;
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_seq_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ S_chunks,
                    const float* __restrict__ dy,
                    const float* __restrict__ dS_final,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ du_part, float* __restrict__ dS_in,
                    int H, int S_len, int Q, long long sb, long long ss,
                    long long sh, long long yb, long long ys, long long yh,
                    long long gb, long long gs, long long gh) {
  using L = Smem<K>;
  constexpr int LD = L::LD, LQ = L::LQ;
  constexpr int NK = K / 16, NQ = MQ / 16;  // 16-wide blocks per thread
  static_assert(K % 16 == 0 && K <= MQ && THREADS == 256,
                "the 16 x 16 thread map and the per-channel phases");
  extern __shared__ float sm[];
  float *R = sm + L::R, *KY = sm + L::KY, *V = sm + L::V, *DY = sm + L::DY,
        *LW = sm + L::LW, *C = sm + L::C, *RD = sm + L::RD, *KG = sm + L::KG,
        *RS = sm + L::RS, *KE = sm + L::KE, *AM = sm + L::AM,
        *ST = sm + L::ST, *DS = sm + L::DS, *U = sm + L::U, *CL = sm + L::CL,
        *ECL = sm + L::ECL, *DECL = sm + L::DECL, *DIAG = sm + L::DIAG,
        *DDIAG = sm + L::DDIAG;

  const int tid = threadIdx.x, ri = tid >> 4, ci = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long ib = b * sb + h * sh, iy = b * yb + h * yh,
                  ig = b * gb + h * gh;
  const int n_chunks = (S_len + Q - 1) / Q;

  for (int i = tid; i < K; i += THREADS) U[i] = u[h * K + i];
  for (int i = tid; i < K * K; i += THREADS)
    DS[(i / K) * LD + i % K] =
        dS_final != nullptr ? dS_final[(long long)bh * K * K + i] : 0.f;
  float du_acc = 0.f;  // thread a < K: channel a's partial of du

  for (int cix = n_chunks - 1; cix >= 0; --cix) {
    const int c0 = cix * Q, Qc = min(Q, S_len - c0);
    __syncthreads();  // the previous chunk is done with every array
    // ---- the chunk's inputs; rows past Qc read as zeros, log w as 0 ----
    for (int i = tid; i < MQ * K; i += THREADS) {
      const int t = i / K, a = i % K, o = t * LD + a;
      const bool in = t < Qc;
      const long long gi = ib + (long long)(c0 + t) * ss + a;
      R[o] = in ? r[gi] : 0.f;
      KY[o] = in ? k[gi] : 0.f;
      V[o] = in ? v[gi] : 0.f;
      LW[o] = in ? logf(w[gi]) : 0.f;
      DY[o] = in ? dy[iy + (long long)(c0 + t) * ys + a] : 0.f;
    }
    const float* sc = S_chunks + ((long long)bh * n_chunks + cix) * K * K;
    for (int i = tid; i < K * K; i += THREADS)
      ST[(i / K) * LD + i % K] = sc[i];
    __syncthreads();

    // ---- cumsum per channel; diag, Σ dy·v per token; Σ S·dS per channel
    if (tid < K) {
      float c = 0.f;
      for (int t = 0; t < MQ; ++t) {
        c += LW[t * LD + tid];
        C[t * LD + tid] = c;
      }
      CL[tid] = c;
      ECL[tid] = expf(fmaxf(c, -2.f * LC));
    } else if (tid >= 64 && tid < 64 + MQ) {
      const int t = tid - 64;
      float dg = 0.f, ddg = 0.f;
      for (int a = 0; a < K; ++a) {
        dg += R[t * LD + a] * U[a] * KY[t * LD + a];
        ddg += DY[t * LD + a] * V[t * LD + a];
      }
      DIAG[t] = dg;
      DDIAG[t] = ddg;
    } else if (tid >= 128 && tid < 128 + K) {
      const int a = tid - 128;
      float s = 0.f;
      for (int n = 0; n < K; ++n) s += ST[a * LD + n] * DS[a * LD + n];
      DECL[a] = s;
    }
    __syncthreads();

    // ---- the factors ----
    for (int i = tid; i < MQ * K; i += THREADS) {
      const int t = i / K, a = i % K, o = t * LD + a;
      const float c = C[o], ce = c - LW[o], cl = CL[a], mid = 0.5f * cl;
      RD[o] = R[o] * clip_exp(ce - mid);
      KG[o] = KY[o] * clip_exp(mid - c);
      RS[o] = R[o] * expf(fmaxf(ce, -2.f * LC));
      KE[o] = KY[o] * expf(fmaxf(cl - c, -2.f * LC));
    }
    __syncthreads();

    // ---- A = RD·KGᵀ on j < t ----
    {
      float acc[NQ][NQ];
      zero(acc);
      mm(acc, RD, LD, 1, KG, 1, LD, K, ri, ci);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int t = ri + 16 * i, jj = ci + 16 * j;
          AM[t * LQ + jj] = jj < t ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // ---- dv = Aᵀ·dy + KE·dS_out + diag·dy (written); dS_in, dRS, dKE ----
    {
      float acc[NQ][NK];
      zero(acc);
      mm(acc, AM, 1, LQ, DY, LD, 1, Qc, ri, ci);
      mm(acc, KE, LD, 1, DS, LD, 1, K, ri, ci);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int t = ri + 16 * i;
        if (t >= Qc) continue;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int n = ci + 16 * j;
          dv[ig + (long long)(c0 + t) * gs + n] =
              acc[i][j] + DIAG[t] * DY[t * LD + n];
        }
      }
    }
    float dsp[NK][NK], drs[NQ][NK], dke[NQ][NK];
    zero(dsp);
    mm(dsp, RS, 1, LD, DY, LD, 1, Qc, ri, ci);
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int a = ri + 16 * i, n = ci + 16 * j;
        dsp[i][j] += ECL[a] * DS[a * LD + n];
      }
    zero(drs);
    mm(drs, DY, LD, 1, ST, 1, LD, K, ri, ci);
    zero(dke);
    mm(dke, V, LD, 1, DS, 1, LD, K, ri, ci);
    __syncthreads();  // every read of A and of dS_out is done

    // ---- dA = dy·vᵀ on j < t, in A's place; the carry becomes dS_in ----
    {
      float acc[NQ][NQ];
      zero(acc);
      mm(acc, DY, LD, 1, V, 1, LD, K, ri, ci);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int t = ri + 16 * i, jj = ci + 16 * j;
          AM[t * LQ + jj] = jj < t ? acc[i][j] : 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j)
        DS[(ri + 16 * i) * LD + ci + 16 * j] = dsp[i][j];
    __syncthreads();

    // ---- dRD = dA·KG, dKG = dAᵀ·RD; then dr, dk and the clamp terms ----
    float drd[NQ][NK], dkg[NQ][NK];
    zero(drd);
    mm(drd, AM, LQ, 1, KG, LD, 1, Qc, ri, ci);
    zero(dkg);
    mm(dkg, AM, 1, LQ, RD, LD, 1, Qc, ri, ci);
    float xce[NQ][NK], xcd[NQ][NK], xm[NQ][NK], xke[NQ][NK];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int t = ri + 16 * i, a = ci + 16 * j, o = t * LD + a;
        const float c = C[o], ce = c - LW[o], cl = CL[a], mid = 0.5f * cl;
        const float aRD = ce - mid, aKG = mid - c, aKE = cl - c;
        const float dd = DDIAG[t], uu = U[a];
        if (t < Qc) {
          const long long go = ig + (long long)(c0 + t) * gs + a;
          dr[go] = drd[i][j] * clip_exp(aRD) +
                   drs[i][j] * expf(fmaxf(ce, -2.f * LC)) + dd * uu * KY[o];
          dk[go] = dkg[i][j] * clip_exp(aKG) +
                   dke[i][j] * expf(fmaxf(aKE, -2.f * LC)) + dd * R[o] * uu;
        }
        const float xRD = in_clip(aRD) ? drd[i][j] * RD[o] : 0.f;
        const float xKG = in_clip(aKG) ? dkg[i][j] * KG[o] : 0.f;
        const float xRS = ce >= -2.f * LC ? drs[i][j] * RS[o] : 0.f;
        const float xKE = aKE >= -2.f * LC ? dke[i][j] * KE[o] : 0.f;
        xce[i][j] = xRD + xRS;  // d ce
        xcd[i][j] = -xKG - xKE; // d c, direct
        xm[i][j] = xKG - xRD;   // d mid, before the sum over tokens
        xke[i][j] = xKE;        // d cl, before the sum over tokens
      }
    __syncthreads();  // every read of RD, KG, RS, KE is done
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int o = (ri + 16 * i) * LD + ci + 16 * j;
        RD[o] = xce[i][j];
        KG[o] = xcd[i][j];
        RS[o] = xm[i][j];
        KE[o] = xke[i][j];
      }
    __syncthreads();

    // ---- per channel: mid's and cl's gradients, the reverse cumsum, dw ----
    if (tid < K) {
      const int a = tid;
      float dmid = 0.f, ske = 0.f, dua = 0.f;
      for (int t = 0; t < Qc; ++t) {
        dmid += RS[t * LD + a];
        ske += KE[t * LD + a];
        dua += DDIAG[t] * R[t * LD + a] * KY[t * LD + a];
      }
      du_acc += dua;
      const float cl = CL[a];
      const float dcl = ske + (cl >= -2.f * LC ? DECL[a] * ECL[a] : 0.f) +
                        0.5f * dmid;
      float run = 0.f;
      for (int t = Qc - 1; t >= 0; --t) {
        const float dce = RD[t * LD + a];
        float dc = KG[t * LD + a] + dce;
        if (t == Qc - 1) dc += dcl;
        run += dc;
        const long long off = (long long)(c0 + t);
        dw[ig + off * gs + a] = (run - dce) / w[ib + off * ss + a];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += THREADS)
    dS_in[(long long)bh * K * K + i] = DS[(i / K) * LD + i % K];
  if (tid < K) du_part[(long long)bh * K + tid] = du_acc;
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* S_chunks, const float* dy,
           const float* dS_final, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* dS_in, int B, int H, int S_len, int Q,
           long long sb, long long ss, long long sh, long long yb,
           long long ys, long long yh, long long gb, long long gs,
           long long gh, cudaStream_t stream) {
  constexpr int bytes = Smem<K>::BYTES;
  auto kern = wkv6_seq_bwd_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * H, THREADS, bytes, stream>>>(
      r, k, v, w, u, S_chunks, dy, dS_final, dr, dk, dv, dw, du_part, dS_in,
      H, S_len, Q, sb, ss, sh, yb, ys, yh, gb, gs, gh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r/k/v/w [B, S, H, K] through (sb, ss, sh), dy through (yb, ys, yh), dr,
// dk, dv, dw through (gb, gs, gh), element strides over (batch, token,
// head) with the channel contiguous.  u [H, K]; S_chunks [B, H, C, K, K]
// (the forward's, C = ceil(S / Q)); dS_final [B, H, K, K] or null (zeros);
// du_part [B, H, K]; dS_in [B, H, K, K]; all contiguous.  Chunks of Q
// tokens (1..64), the last one ragged.  Returns cudaErrorInvalidValue for
// a K without an instance (32, 64) or Q outside 1..64.
int wkv6_seq_bwd(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* S_chunks, const void* dy,
                 const void* dS_final, void* dr, void* dk, void* dv, void* dw,
                 void* du_part, void* dS_in, int B, int H, int S_len, int Q,
                 int K, long long sb, long long ss, long long sh,
                 long long yb, long long ys, long long yh, long long gb,
                 long long gs, long long gh, void* stream) {
  if (B <= 0 || H <= 0 || S_len <= 0 || Q <= 0 || Q > MQ)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *cp = static_cast<const float*>(S_chunks),
              *yp = static_cast<const float*>(dy),
              *fp = static_cast<const float*>(dS_final);
  float *drp = static_cast<float*>(dr), *dkp = static_cast<float*>(dk),
        *dvp = static_cast<float*>(dv), *dwp = static_cast<float*>(dw),
        *dup = static_cast<float*>(du_part), *dsp = static_cast<float*>(dS_in);
  if (K == 32)
    return launch<32>(rp, kp, vp, wp, up, cp, yp, fp, drp, dkp, dvp, dwp, dup,
                      dsp, B, H, S_len, Q, sb, ss, sh, yb, ys, yh, gb, gs, gh,
                      st);
  if (K == 64)
    return launch<64>(rp, kp, vp, wp, up, cp, yp, fp, drp, dkp, dvp, dwp, dup,
                      dsp, B, H, S_len, Q, sb, ss, sh, yb, ys, yh, gb, gs, gh,
                      st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
