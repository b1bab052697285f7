// Hand-written Hopper (sm_90a) flash attention on the tensor cores:
// online-softmax causal / sliding-window GQA attention over one prompt
// (the prefill of the dense transformer, models/layers.py:gqa_attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), and computes the function of the
// JAX models' full-sequence layers._sdpa under _causal_window_mask:
//
//   o[b,h,i] = Σ_j softmax_j(q[b,h,i]·k[b,g,j] / √D) v[b,g,j],  g = h / (H/Hkv)
//   over the keys j with j <= i (causal), i - j < window (window > 0) and
//   j < T.  q is scaled by 1/√D in float32 before the product, masked
//   logits are -1e30 and their p is zeroed; the output is
//   acc / max(l, 1e-30), as in _flash_kernel.
//
// What bounds it on this card: operations.  4·D FLOPs per visible (query,
// key) pair: at the qwen3-0.6b prefill [B=4, H=16, Hkv=8, S=512, D=128]
// 4.29 GFLOP.  On the FP32 pipes (67 TFLOP/s) that is 64 µs, and the
// kernel this one replaces ran at 4× that.  Here both products run on the
// tensor cores in TF32 with the 3xTF32 split, which keeps float32
// accuracy: each float32 operand x is split into big = tf32(x) and
// small = x - big, and acc += small·big' + big·small' + big·big' (the
// operator PyTorch's own float32 attention instantiates,
// OpMultiplyAddFastF32; tf32_mma.cuh rounds big with an integer add and
// mask, since cvt.rna.tf32 made the split the bottleneck).  Bound: 3 ×
// 4.29 GFLOP / 495 TFLOP/s = 26 µs, against 8 MB of q, k, v and o over
// 3.35 TB/s = 2.5 µs.
//
// Route: mma.sync.aligned.m16n8k8 TF32 (warp-level), fragments loaded from
// shared memory.  wgmma would take both TF32 operands K-major only, so V
// (D contiguous) would need a transposed copy in shared memory and P a
// round trip through it; mma.sync keeps P in registers (below) and is the
// simple, right first step on the tensor cores.
//
// Design:
//   * One CTA of 8 warps per (b·h, query tile of BQ = 128 rows); each warp
//     owns 16 query rows (the mma M).  Its q rows (scaled) wait in shared
//     memory for the whole key loop (in registers, beside the
//     accumulator, they spilled at D = 128), and the running max m, the
//     normaliser l and the [16, D] accumulator stay in registers in the
//     mma accumulator layout.
//   * K and V stream through a two-stage ring of 64-row tiles in shared
//     memory, filled with 16-byte cp.async copies: tile t + 1 loads while
//     tile t computes.  Rows past T are zero-filled by the copy (source
//     size 0) and masked.  Rows are padded (K by 8, V by 4 floats or 8
//     bf16) so the fragment loads hit 32 distinct banks.
//   * Fragment permutations instead of shuffles: in Q·Kᵀ the mma's k index
//     t / t+4 reads the head dims 2t / 2t+1 of q and k alike (one 8- or
//     4-byte load per pair); in P·V it reads the keys 2t / 2t+1, which are
//     exactly the two score columns a thread holds in the accumulator
//     layout, so P goes from the scores to the A fragment in registers.
//   * bfloat16 inputs: k and v are exact in TF32, so their small part is
//     zero and each product takes two mmas (q or p split, k or v whole).
//     The math stays float32 as in _flash_kernel (q·scale in float32,
//     p in float32).
//   * Key tiles wholly above the causal diagonal, or wholly before the
//     window of every query in the tile, are skipped by the CTA; a warp
//     skips a tile none of its rows sees (exact zeros in _flash_kernel:
//     p = 0, correction e^0 = 1).  Tiles inside the diagonal, the window
//     edge or the ragged T take the masked path; the rest skip the mask.
//   * Heaviest (latest) query tiles launch first.
//   * Layout: q/k/v/o are indexed through (batch, head, sequence) element
//     strides with the head dimension contiguous, so the model's
//     [B, S, H, D] activations go in as [B, H, S, D] views with no copy.
//     The wrapper checks that every row start is 16-byte aligned.
//   * expf and IEEE division, not the fast intrinsics.
//   * Shared memory: 2 stages × BK rows × (D + 8 + DV + 4) floats of K/V
//     and 128 × (D + 8) floats of q = 202 KB at D = DV = 128 in float32
//     with BK = 64 (one CTA of 8 warps per SM; 138 KB at (96, 64)), above
//     the 48 KB default, so each instance opts in with
//     cudaFuncSetAttribute.  BK is 64 wherever that fits the 232,448 B a
//     block may take, else 32 (Layout::Of::BK): only the float32 (192,
//     128) instance takes 32.
//
// Value width: v and o have DV columns, q and k D.  The GQA instances
// have DV = D (64, 80, 128, and 96 for phi-3-vision-4.2b: q·kᵀ runs 12
// k-steps, P·V 12 n-tiles; 2 stages × 64 × ((96 + 8) + (96 + 4)) × 4 B
// = 104,448 B of K/V and 128 × 104 × 4 = 53,248 B of q in float32,
// 157,696 B in all, so BK = 64); the MLA instances do not.  (D, DV) = (96, 64) is
// minicpm3-4b's (q/k are qk_nope 64 + qk_rope 32, v is v_head_dim 64),
// whose q·kᵀ runs 12 k-steps and P·V 8 n-tiles.  (192, 128) is
// deepseek-v2's (qk_nope 128 + qk_rope 64, v 128): q·kᵀ runs 24 k-steps
// and P·V 16 n-tiles.  In float32 its 64-row K/V tiles do not fit:
// 2 stages × 64 × ((192 + 8) + (128 + 4)) × 4 B = 169,984 B of K/V and
// 128 × 200 × 4 = 102,400 B of q make 272,384 B.  So that instance keeps
// the 8 warps and the 128 query rows and halves the key tile: BK = 32,
// 84,992 B of K/V, 187,392 B in all (one CTA an SM), 4 score n-tiles a
// warp a tile; in bfloat16 it keeps BK = 64 (188,416 B).  Each MLA
// instance is scaled by 1/√D, the reference's float32
// 1/sqrt(qk_nope + qk_rope).  Nothing is padded to another instance.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per CTA
constexpr int STAGES = 2;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

template <typename T>
struct Layout {
  static constexpr bool kF32 = sizeof(T) == 4;
  template <int D, int DV>
  struct Of {
    static constexpr int KS = D + 8;                // K row stride, elements
    static constexpr int VS = DV + (kF32 ? 4 : 8);  // V row stride
    static constexpr int QS = D + 8;                // Q row stride, floats
    static constexpr int Q_BYTES = BQ * QS * (int)sizeof(float);
    // key rows per tile: 64 where two stages of them fit beside q
    static constexpr int BK =
        STAGES * 64 * (KS + VS) * (int)sizeof(T) + Q_BYTES <= SMEM_LIMIT ? 64 : 32;
    static constexpr int STAGE = BK * (KS + VS);    // elements per stage
    static constexpr int KV_BYTES = STAGES * STAGE * (int)sizeof(T);
    static constexpr int BYTES = KV_BYTES + Q_BYTES;
    static constexpr int CHUNKS = D * (int)sizeof(T) / 16;    // per K row
    static constexpr int V_CHUNKS = DV * (int)sizeof(T) / 16;  // per V row
  };
};

// two consecutive elements as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, int DV, typename T>
__device__ __forceinline__ void load_tile(T* sk, T* sv, const T* kb,
                                          const T* vb, long long kss,
                                          long long vss, int k0, int T_len,
                                          int tid) {
  using L = typename Layout<T>::template Of<D, DV>;
  constexpr int BK = L::BK;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  for (int i = tid; i < BK * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS, c = (i % L::CHUNKS) * EPC;
    const int s = k0 + r;
    const bool in = s < T_len;
    const long long row = in ? s : 0;  // a valid address; 0 bytes read
    tc::cp_async16(sk + r * L::KS + c, kb + row * kss + c, in);
    if constexpr (DV == D)
      tc::cp_async16(sv + r * L::VS + c, vb + row * vss + c, in);
  }
  if constexpr (DV != D) {
    for (int i = tid; i < BK * L::V_CHUNKS; i += THREADS) {
      const int r = i / L::V_CHUNKS, c = (i % L::V_CHUNKS) * EPC;
      const int s = k0 + r;
      const bool in = s < T_len;
      const long long row = in ? s : 0;
      tc::cp_async16(sv + r * L::VS + c, vb + row * vss + c, in);
    }
  }
}

template <int D, int DV, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int H, int group,
             int S, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
             int window, float scale) {
  using L = typename Layout<T>::template Of<D, DV>;
  constexpr bool EXACT = !Layout<T>::kF32;  // bf16 k, v are exact in TF32
  constexpr int BK = L::BK;                 // key rows per tile
  constexpr int NJ = BK / 8;                // score n-tiles per key tile
  constexpr int KK = D / 8;                 // k-steps of Q·Kᵀ
  constexpr int ND = DV / 8;                // n-tiles of P·V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* sq = reinterpret_cast<float*>(smem_raw + L::KV_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  // heaviest (latest) causal tiles first: the last wave is the light one
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int r0 = q0 + 16 * warp;  // this warp's first query row

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // key tiles that hold a visible key for some query row of this tile
  const int k_hi = min(T_len, min(S, q0 + BQ));
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  if (t_lo < t_hi) {
    load_tile<D, DV, T>(smem, smem + BK * L::KS, kb, vb, ks.s, vs.s, t_lo * BK,
                    T_len, tid);
  }
  tc::cp_async_commit();

  // this warp's 16 query rows, scaled in float32, into shared memory
  // (read back as mma fragments; held in registers they would spill)
  float* sqw = sq + 16 * warp * L::QS;
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), d = 2 * (i % (D / 2));
    const int row = r0 + r;
    const float2 x =
        row < S ? load2(qb + row * qs.s + d) : make_float2(0.f, 0.f);
    store2(sqw + r * L::QS + d, x.x * scale, x.y * scale);
  }
  __syncwarp();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    if (t + 1 < t_hi) {
      T* nxt = smem + ((t + 1 - t_lo) & 1) * L::STAGE;
      load_tile<D, DV, T>(nxt, nxt + BK * L::KS, kb, vb, ks.s, vs.s, k0 + BK,
                      T_len, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile t has landed (tile t + 1 may be in flight)
    __syncthreads();

    const T* sk = smem + ((t - t_lo) & 1) * L::STAGE;
    const T* sv = sk + BK * L::KS;
    // does any row of this warp see any key of this tile?
    const bool skip = r0 >= S || k0 > r0 + 15 ||
                      (window > 0 && k0 + BK - 1 <= r0 - window);
    if (!skip) {
      // S = (q·scale)·Kᵀ, [16, BK] per warp
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        // q rows g / g+8, head dims 8kk+2t, +1
        const float2 qa = load2(sqw + g * L::QS + 8 * kk + 2 * t4);
        const float2 qc = load2(sqw + (g + 8) * L::QS + 8 * kk + 2 * t4);
        uint32_t ab[4], as[4];
        tc::split4(qa.x, qc.x, qa.y, qc.y, ab, as);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv = load2(sk + (8 * j + g) * L::KS + 8 * kk + 2 * t4);
          tc::mma3<EXACT>(s[j], ab, as, kv.x, kv.y);
        }
      }

      // online softmax; element e of s[j] is row g + 8·(e >> 1), key
      // k0 + 8j + 2t + (e & 1)
      const bool full = k0 + BK - 1 <= r0 && k0 + BK <= T_len &&
                        (window <= 0 || r0 + 15 - k0 < window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int qp = r0 + g + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool ok = kp < T_len && kp <= qp &&
                            (window <= 0 || qp - kp < window);
            s[j][e] = ok ? s[j][e] : NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
        corr[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked logit is exactly NEG_INF; only a masked one is
          // (visible logits are finite): its p is zeroed as in the JAX
          // kernel's where(mask, p, 0)
          const float p =
              s[j][e] == NEG_INF ? 0.f : expf(s[j][e] - m_i[e >> 1]);
          s[j][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + ls[r];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // acc += P·V: the k index t / t+4 of the mma is key 2t / 2t+1 of
      // the n-tile, which the thread already holds as s[j][0..3]
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ab[4], as[4];
        tc::split4(s[j][0], s[j][2], s[j][1], s[j][3], ab, as);
        const T* v0 = sv + (8 * j + 2 * t4) * L::VS + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          tc::mma3<EXACT>(acc[n], ab, as, to_f32(v0[8 * n]),
                          to_f32(v0[L::VS + 8 * n]));
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + g + 8 * r;
    const float l = quad_sum(l_i[r]);
    const float den = fmaxf(l, 1e-30f);
    if (qp >= S) continue;
    // the row's log-sum-exp for the backward (training calls only): a row
    // that sees no key gets +inf, so its recomputed p is exactly 0
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * S + qp] = l > 0.f ? m_i[r] + logf(l) : INFINITY;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(ob + qp * os.s + 8 * n + 2 * t4, acc[n][2 * r] / den,
             acc[n][2 * r + 1] / den);
  }
}

template <int D, int DV, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, int T_len, Strides qs, Strides ks,
           Strides vs, Strides os, int window, cudaStream_t stream) {
  constexpr int bytes = Layout<T>::template Of<D, DV>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "shared memory");
  auto kern = flash_kernel<D, DV, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, S, T_len,
      qs, ks, vs, os, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, int DV, const void* q, const void* k, const void* v,
               void* o, float* lse, int B, int H, int Hkv, int S, int T_len,
               Strides qs, Strides ks, Strides vs, Strides os, int window,
               cudaStream_t st) {
#define FLASH_CASE(DD, VV)                                                \
  if (D == DD && DV == VV)                                                \
    return launch<DD, VV, T>(q, k, v, o, lse, B, H, Hkv, S, T_len, qs, ks, \
                             vs, os, window, st);
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(96, 96)
  FLASH_CASE(128, 128)
  FLASH_CASE(96, 64)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements, (batch, head, sequence) for each tensor; the head dimension
// (D of q and k, DV of v and o) is contiguous and every row start is
// 16-byte aligned (the wrapper checks).  Causal; window > 0 adds the
// sliding window.  lse, when not null, receives each row's log-sum-exp
// of the scaled logits, [B, H, S] float32 contiguous (the backward's
// input; the serve path passes null).  Returns cudaErrorInvalidValue for
// a (D, DV) without an instance ((64, 64), (80, 80), (96, 96), (128,
// 128), (96, 64), (192, 128)) or a bad dtype.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int dtype, int B, int H, int Hkv, int S,
                        int T_len, int D, int DV, long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        int window, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || T_len <= 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, DV, q, k, v, o, static_cast<float*>(lse), B,
                             H, Hkv, S, T_len, qs, ks, vs, os, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, DV, q, k, v, o,
                                     static_cast<float*>(lse), B, H, Hkv, S,
                                     T_len, qs, ks, vs, os, window, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
