// Hand-written Hopper (sm_90a) kernel for one RWKV-6 chunk: the chunked-
// parallel WKV6 of the rwkv6 time-mix prefill (models/rwkv6.py:_wkv_chunked
// calls it once per chunk of Q tokens, carrying the state).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:
// wkv6_chunk_pallas (_wkv_chunk_kernel), which is one step of the scan body
// of the JAX model's rwkv6._wkv_chunked.  For one (batch, head), with
// r/k/v/w [Q, K], u [K] and S_in [K, K]:
//
//   c    = inclusive cumsum of log w along Q;   ce = c - log w
//   mid  = ½·c[Q-1]
//   A    = (r·e^{clip(ce - mid, ±40)}) · (k·e^{clip(mid - c, ±40)})ᵀ, j < t
//   y    = A·v + (Σ_k r·u·k)·v + (r·e^{max(ce, -80)})·S_in
//   S_out = e^{max(c[Q-1], -80)}·S_in + (k·e^{max(c[Q-1] - c, -80)})ᵀ·v
//
// What bounds it on this card: at the rwkv6-7b shape [B=4, H=64, Q=64,
// K=64] the bytes (r, k, v, w, S_in read, y, S_out written: 29.4 MB, 8.8 µs
// at 3.35 TB/s) and the four [64,64]x[64,64] products per (b, h) (0.54
// GFLOP, 8.0 µs at 67 TFLOP/s FP32) are about even.  This first version
// runs on the FP32 pipes; a kernel that keeps the state resident across
// all chunks of a (b, h) is later work.
//
// Design:
//   * One CTA of 256 threads per (b, h).  r, k, v, log w, the derived
//     factors, S_in and the [Q, Q] scores live in shared memory as float32
//     (rows padded by one float against bank conflicts): 134 KB at
//     Q = K = 64, above the 48 KB default, so each instance opts in with
//     cudaFuncSetAttribute.
//   * The cumulative log-decay runs sequentially along Q, one thread per
//     channel; every other step is spread over all threads.
//   * Only the strictly lower triangle of A is computed; the rest is 0
//     (an entry above the diagonal, whose clipped factors may overflow,
//     never reaches y).
//   * logf / expf, not the fast-math intrinsics; sums run in the order of
//     the JAX expression ((A·v + diag·v) + r_state·S_in).
//   * r/k/v/w are indexed through (batch, head, token) element strides
//     with the channel contiguous, so the model's [B, H, S, K] buffers go
//     in chunk by chunk as views.  y [B, H, Q, K], u [H, K], S_in and
//     S_out [B, H, K, K] are contiguous.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 64;
constexpr float LOG_CLAMP = 40.0f;

__host__ __device__ constexpr int smem_floats(int Q, int K) {
  // r, k, v, c, r_state, k_end [Q][K+1]; S [K][K+1]; A [Q][Q+1];
  // ce (reuses r_state), diag [Q], u [K], c_last [K]
  return 6 * Q * (K + 1) + K * (K + 1) + Q * (Q + 1) + Q + 2 * K;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ S_in,
                  float* __restrict__ y, float* __restrict__ S_out, int H,
                  int Q, long long sb, long long sh, long long sq) {
  constexpr int KP = K + 1;
  const int QP = Q + 1;
  extern __shared__ float sm[];
  float* s_r = sm;                // r, then r_dec
  float* s_k = s_r + Q * KP;      // k, then k_grow
  float* s_v = s_k + Q * KP;
  float* s_c = s_v + Q * KP;      // log w, then c
  float* s_rs = s_c + Q * KP;     // ce, then r_state
  float* s_ke = s_rs + Q * KP;    // k_end
  float* s_S = s_ke + Q * KP;     // [K][KP]
  float* s_A = s_S + K * KP;      // [Q][QP]
  float* s_diag = s_A + Q * QP;   // [Q]
  float* s_u = s_diag + Q;        // [K]
  float* s_cl = s_u + K;          // [K] c[Q-1]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const float* S0 = S_in + (long long)bh * K * K;

  for (int i = tid; i < Q * K; i += THREADS) {
    const int t = i / K, j = i % K;
    const long long off = base + t * sq + j;
    s_r[t * KP + j] = r[off];
    s_k[t * KP + j] = k[off];
    s_v[t * KP + j] = v[off];
    s_c[t * KP + j] = logf(w[off]);
  }
  for (int i = tid; i < K * K; i += THREADS)
    s_S[(i / K) * KP + i % K] = S0[i];
  for (int j = tid; j < K; j += THREADS) s_u[j] = u[h * K + j];
  __syncthreads();

  // bonus diagonal Σ_k (r·u)·k per token; cumulative log-decay per channel
  for (int t = tid; t < Q; t += THREADS) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j)
      acc += s_r[t * KP + j] * s_u[j] * s_k[t * KP + j];
    s_diag[t] = acc;
  }
  for (int j = tid; j < K; j += THREADS) {
    float c = 0.f;
    for (int t = 0; t < Q; ++t) {
      const float lw = s_c[t * KP + j];
      c += lw;
      s_c[t * KP + j] = c;
      s_rs[t * KP + j] = c - lw;
    }
    s_cl[j] = c;
  }
  __syncthreads();

  // the centred intra-chunk factors and the state factors
  for (int i = tid; i < Q * K; i += THREADS) {
    const int t = i / K, j = i % K, a = t * KP + j;
    const float c = s_c[a], ce = s_rs[a], cl = s_cl[j];
    const float mid = 0.5f * cl;
    const float rr = s_r[a], kk = s_k[a];
    s_rs[a] = rr * expf(fmaxf(ce, -2.f * LOG_CLAMP));
    s_r[a] = rr * expf(fminf(fmaxf(ce - mid, -LOG_CLAMP), LOG_CLAMP));
    s_ke[a] = kk * expf(fmaxf(cl - c, -2.f * LOG_CLAMP));
    s_k[a] = kk * expf(fminf(fmaxf(mid - c, -LOG_CLAMP), LOG_CLAMP));
  }
  __syncthreads();

  // strictly lower [Q, Q] scores
  for (int i = tid; i < Q * Q; i += THREADS) {
    const int t = i / Q, j = i % Q;
    float acc = 0.f;
    if (j < t) {
#pragma unroll 8
      for (int a = 0; a < K; ++a)
        acc = fmaf(s_r[t * KP + a], s_k[j * KP + a], acc);
    }
    s_A[t * QP + j] = acc;
  }
  __syncthreads();

  // y = A·v + diag·v + r_state·S_in
  float* yo = y + (long long)bh * Q * K;
  for (int i = tid; i < Q * K; i += THREADS) {
    const int t = i / K, n = i % K;
    float av = 0.f;
    for (int j = 0; j < t; ++j) av = fmaf(s_A[t * QP + j], s_v[j * KP + n], av);
    av += s_diag[t] * s_v[t * KP + n];
    float rs = 0.f;
#pragma unroll 8
    for (int a = 0; a < K; ++a) rs = fmaf(s_rs[t * KP + a], s_S[a * KP + n], rs);
    yo[i] = av + rs;
  }

  // S_out = e^{max(c[Q-1], -80)}·S_in + k_endᵀ·v
  float* So = S_out + (long long)bh * K * K;
  for (int i = tid; i < K * K; i += THREADS) {
    const int a = i / K, n = i % K;
    float kv = 0.f;
    for (int j = 0; j < Q; ++j) kv = fmaf(s_ke[j * KP + a], s_v[j * KP + n], kv);
    So[i] = expf(fmaxf(s_cl[a], -2.f * LOG_CLAMP)) * s_S[a * KP + n] + kv;
  }
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* S_in, float* y, float* S_out, int B,
           int H, int Q, long long sb, long long sh, long long sq,
           cudaStream_t stream) {
  const int bytes = smem_floats(Q, K) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_Q, K) * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  wkv6_chunk_kernel<K><<<B * H, THREADS, bytes, stream>>>(
      r, k, v, w, u, S_in, y, S_out, H, Q, sb, sh, sq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r/k/v/w: element strides (sb, sh, sq) over (batch, head, token), the
// channel contiguous.  y [B, H, Q, K], u [H, K], S_in and S_out
// [B, H, K, K] contiguous.  Returns cudaErrorInvalidValue for a K
// without an instance (32, 64) or Q outside 1..64.
int wkv6_chunk_fwd(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* S_in, void* y, void* S_out, int B,
                   int H, int Q, int K, long long sb, long long sh,
                   long long sq, void* stream) {
  if (B <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *sp = static_cast<const float*>(S_in);
  float *yp = static_cast<float*>(y), *op = static_cast<float*>(S_out);
  switch (K) {
    case 32:
      return launch<32>(rp, kp, vp, wp, up, sp, yp, op, B, H, Q, sb, sh, sq,
                        st);
    case 64:
      return launch<64>(rp, kp, vp, wp, up, sp, yp, op, B, H, Q, sb, sh, sq,
                        st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
