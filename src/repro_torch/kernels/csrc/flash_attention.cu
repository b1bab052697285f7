// Hand-written Hopper (sm_90a) flash attention: online-softmax causal /
// sliding-window GQA attention over one prompt (the prefill of the dense
// transformer, models/layers.py:gqa_attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), and computes the function of the
// JAX models' full-sequence layers._sdpa under _causal_window_mask:
//
//   o[b,h,i] = Σ_j softmax_j(q[b,h,i]·k[b,g,j] / √D) v[b,g,j],  g = h / (H/Hkv)
//   over the keys j with j <= i (causal), i - j < window (window > 0) and
//   j < T.  Masked logits are -1e30 and their p is zeroed; the output
//   is acc / max(l, 1e-30), as in _flash_kernel.
//
// What bounds it on this card: operations.  4·D FLOPs per visible (query,
// key) pair against 2·D·(bytes per element) read per key row once per
// query tile; at the qwen3-0.6b prefill shape [B=4, H=16, Hkv=8, S=512,
// D=128] the bound is 4.29 GFLOP over 67 TFLOP/s FP32 = 64 µs against
// 8 MB over 3.35 TB/s = 2.5 µs.  This first version runs on the FP32
// pipes (no tensor cores, no TMA): right and simple first.
//
// Design:
//   * One CTA of 128 threads per (b·h, query tile of BQ = 64 rows).  The
//     Q tile is scaled by 1/√D on load (as _flash_kernel scales q) and
//     stays in shared memory; K and V stream through shared memory in
//     tiles of BK = 32 rows, converted to float32 on load.
//   * Thread t owns query rows 4·(t/8) .. +3 and key columns (t%8) + 8·j
//     of the score tile, and output columns (t%8) + 8·c of those rows:
//     the running max m, normaliser l and accumulator stay in registers
//     in float32.  Row max and row sum reduce over the 8 lanes of a row
//     group with shuffles.  P goes through shared memory for P·V.
//   * Rows are padded by one float in shared memory (no bank conflicts on
//     the column reads of K and Q).
//   * Key tiles wholly above the causal diagonal, or wholly before the
//     window of every query in the tile, are skipped: they add exact
//     zeros in _flash_kernel (p = 0, correction e^0 = 1).
//   * Ragged S and T are masked in the kernel (keys j >= T are masked,
//     query rows i >= S are not written): the wrapper pads nothing.
//   * Layout: q/k/v/o are indexed through (batch, head, sequence)
//     element strides with the head dimension contiguous, so the model's
//     [B, S, H, D] activations go in as [B, H, S, D] views with no copy.
//   * float32 and bfloat16 inputs; math in float32 (expf, IEEE division),
//     output in the input type.
//   * Shared memory is 74 KB at D = 128 (three CTAs per SM): above the
//     48 KB default, so each instance opts in with cudaFuncSetAttribute.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // key rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int ROWS = BQ / 16;   // query rows per thread
constexpr int KCOLS = BK / 8;   // key columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int group,
             int S, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
             int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 8;  // output columns per thread
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* sq = smem;            // [BQ][DP]
  float* sk = sq + BQ * DP;    // [BK][DP]
  float* sv = sk + BK * DP;    // [BK][D]
  float* sp = sv + BK * D;     // [BQ][PP]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;     // row group
  const int cl = tid & 7;      // column lane
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  // heaviest (latest) causal tiles first: the last wave is the light one
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    sq[r * DP + d] = s < S ? to_f32(qb[s * qs.s + d]) * scale : 0.f;
  }

  float m_i[ROWS], l_i[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a visible key for some query row of this tile
  const int k_hi = min(T_len, q0 + BQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < T_len;
      sk[r * DP + d] = in ? to_f32(kb[s * ks.s + d]) : 0.f;
      sv[r * D + d] = in ? to_f32(vb[s * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sq[(rg * ROWS + i) * DP + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = sk[(cl + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + rg * ROWS + i;
      bool ok[KCOLS];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kp = k0 + cl + 8 * j;
        ok[j] = kp < T_len && kp <= qp && (window <= 0 || qp - kp < window);
        sc[i][j] = ok[j] ? sc[i][j] : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], group_max(mx));
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sp[(rg * ROWS + i) * PP + cl + 8 * j] = p;
        ls += p;
      }
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + group_sum(ls);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sp[(rg * ROWS + i) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sv[j * D + cl + 8 * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + rg * ROWS + i;
    if (qp >= S) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[qp * os.s + cl + 8 * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, int T_len, Strides qs, Strides ks, Strides vs,
           Strides os, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  auto kern = flash_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, S, T_len, qs,
      ks, vs, os, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int Hkv, int S, int T_len, Strides qs, Strides ks,
               Strides vs, Strides os, int window, cudaStream_t st) {
#define FLASH_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch<DD, T>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, \
                         window, st);
  switch (D) {
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements, (batch, head, sequence) for each tensor; the head dimension
// D is contiguous.  Causal; window > 0 adds the sliding window.  Returns
// cudaErrorInvalidValue for a D without an instance (64, 80, 128) or a
// bad dtype.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Hkv, int S, int T_len,
                        int D, long long qsb, long long qsh, long long qss,
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
    return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs,
                             os, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, S, T_len, qs,
                                     ks, vs, os, window, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
