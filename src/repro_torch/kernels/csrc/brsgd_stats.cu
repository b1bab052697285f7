// Hand-written Hopper (sm_90a) kernels for the BrSGD aggregation pass
// over the worker-gradient matrix G [m, d] (f32, row-major, m workers).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/brsgd_stats.py:
//
//   fused_stats_kernel<M, false>  <- fused_stats_pallas (_fused_stats_kernel):
//                                    any subset of scores [m], l1 [m],
//                                    d2med [m], gram [m, m] in one read of G.
//   fused_stats_kernel<M, true>   <- brsgd_stats_pallas (_stats_kernel):
//                                    the same pass, also writing the
//                                    coordinate-wise median [d] and mean [d].
//   combine_rows_kernel<M, true>  <- select_mean_pallas (_select_mean_kernel):
//                                    C1∩C2 selection (C2 fallback) fused with
//                                    the masked row mean.
//   combine_rows_kernel<M, false> <- masked_mean_pallas (masked_mean_kernel):
//                                    Σ w_i g_i / Σ w_i, empty mask divides by 1.
//   trimmed_mean_kernel<M>        <- trimmed_mean_pallas (_trimmed_mean_kernel):
//                                    per column, the mean of the sorted rows
//                                    k..m-k-1 ([d] out, no partials).
//
// What bounds them: bytes.  Each kernel reads G once (m·d·4 bytes) and
// does O(m log² m) compare-exchanges per column (O(m²) for gram), far
// below the card's FP32 rate per byte; at the LeNet shape [20, 61706] G
// is 4.9 MB and sits in the 50 MB L2, so launch latency dominates.
//
// Design (right and simple first):
//   * One thread owns one column; a block covers THREADS consecutive
//     columns (coalesced row loads) and walks tiles with a grid stride.
//     The TPU grid's sequential carry becomes per-block partials
//     [n_blocks, m] ([n_blocks, m, m] for gram) that the wrapper sums.
//     No float atomics: the partial order is fixed, so l1 — which
//     decides C1 — is the same on every run.
//   * The ragged last tile is masked (invalid columns contribute exact
//     zeros), so no zero-pad columns and no "+1 score per pad column"
//     correction exist here.
//   * m is a template constant: the column lives in registers and the
//     bitonic network (padded with +inf to a power of two, the network
//     of ref.bitonic_stages) fully unrolls; the median is rows[m/2] or
//     the exact two-middle average, bit-equal to the plain version.  At
//     m = 64 the sorted copy goes to shared memory (registers spilled).
//   * NaN in G propagates as in the plain versions: a column holding a
//     NaN has a NaN median (as the NaN-propagating sort of ref gives),
//     and the below-mean side is !(g >= mean), as the plain ~above.
//   * Column mean: row-order sum, IEEE division by m.  The combine sums
//     rows in order 0..m-1 with __fmul_rn/__fadd_rn (no FMA contraction)
//     and skips weight-0 rows, which reproduces ref.masked_mean_det bit
//     for bit on 0/1 weights.
//   * gram: the tile is staged in shared memory and each thread owns
//     fixed (i, j) pairs, accumulating their dot products across tiles.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError()
// after its launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

constexpr int NEED_SCORES = 1;
constexpr int NEED_L1 = 2;
constexpr int NEED_D2MED = 4;
constexpr int NEED_GRAM = 8;

__host__ __device__ constexpr int pow2_at_least(int m) {
  int p = 2;
  while (p < m) p *= 2;
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
  // fixed shuffle tree: deterministic; lane 0 ends with the sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sorts at(0), ..., at(MP-1) ascending in place with the network of
// ref.bitonic_stages.  `at` returns a reference: an element of a register
// array, or of the thread's strided column in shared memory.  fminf/fmaxf
// drop NaN where torch.minimum/maximum keep it: sorted_median restores
// the plain version's result.
template <int MP, typename At>
__device__ __forceinline__ void bitonic_sort(At at) {
#pragma unroll
  for (int k = 2; k <= MP; k *= 2) {
#pragma unroll
    for (int j = k / 2; j >= 1; j /= 2) {
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float lo = fminf(at(i), at(l));
          const float hi = fmaxf(at(i), at(l));
          const bool asc = (i & k) == 0;
          at(i) = asc ? lo : hi;
          at(l) = asc ? hi : lo;
        }
      }
    }
  }
}

// From this worker count on, the sort runs in shared memory: a register
// copy of the column beside the column itself spills at M = 64.
constexpr int SMEM_SORT_M = 64;

// Fills at(0..MP-1) with the column g padded with +inf to a power of two
// and sorts it; returns whether the column holds a NaN.  A NaN anywhere
// in the column makes every sorted row NaN in the plain version's
// NaN-propagating network (every output depends on every input), so the
// callers return NaN for such a column.  One test per column costs less
// than one per compare-exchange.
template <int M, typename At>
__device__ __forceinline__ bool sort_column(const float (&g)[M], At at) {
  constexpr int MP = pow2_at_least(M);
  bool any_nan = false;
#pragma unroll
  for (int i = 0; i < MP; ++i) at(i) = i < M ? g[i] : INFINITY;
#pragma unroll
  for (int i = 0; i < M; ++i) any_nan |= isnan(g[i]);
  bitonic_sort<MP>(at);
  return any_nan;
}

template <int M, typename At>
__device__ __forceinline__ float sorted_median(const float (&g)[M], At at) {
  if (sort_column<M>(g, at)) return NAN;
  if (M % 2) return at(M / 2);
  return __fmul_rn(0.5f, __fadd_rn(at(M / 2 - 1), at(M / 2)));
}

// Mean of the sorted rows k..M-k-1, summed in row order from at(k) and
// IEEE-divided by M - 2k (ref.trimmed_mean_ref).  k is a runtime value:
// the loop runs over every row under a predicate instead of indexing
// with k, so below SMEM_SORT_M the column stays in registers.
template <int M, typename At>
__device__ __forceinline__ float sorted_trimmed_mean(const float (&g)[M], int k, At at) {
  if (sort_column<M>(g, at)) return NAN;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (k <= i && i < M - k) acc = i == k ? at(i) : __fadd_rn(acc, at(i));
  }
  return __fdiv_rn(acc, static_cast<float>(M - 2 * k));
}

// The sort slots of this thread: registers below SMEM_SORT_M; from there
// on its strided column of scratch, which holds THREADS columns of
// pow2_at_least(M) floats.
template <int M>
__device__ __forceinline__ float column_median(const float (&g)[M], float* scratch) {
  if constexpr (M >= SMEM_SORT_M) {
    float* col = scratch + threadIdx.x;
    return sorted_median<M>(g, [col](int i) -> float& { return col[i * THREADS]; });
  } else {
    float s[pow2_at_least(M)];
    return sorted_median<M>(g, [&s](int i) -> float& { return s[i]; });
  }
}

template <int M>
__device__ __forceinline__ float column_trimmed_mean(const float (&g)[M], int k,
                                                     float* scratch) {
  if constexpr (M >= SMEM_SORT_M) {
    float* col = scratch + threadIdx.x;
    return sorted_trimmed_mean<M>(g, k, [col](int i) -> float& { return col[i * THREADS]; });
  } else {
    float s[pow2_at_least(M)];
    return sorted_trimmed_mean<M>(g, k, [&s](int i) -> float& { return s[i]; });
  }
}

template <int M>
__device__ __forceinline__ float column_mean(const float (&g)[M]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i) s = __fadd_rn(s, g[i]);
  return __fdiv_rn(s, static_cast<float>(M));
}

// One pass over G.  Partials: scores/l1/d2med [gridDim.x, M], gram
// [gridDim.x, M, M]; a null pointer's statistic is not requested.
// COLUMN_OUT additionally writes median [d] and mean [d].
template <int M, bool COLUMN_OUT>
__global__ void __launch_bounds__(THREADS)
fused_stats_kernel(const float* __restrict__ G, long long d, int needs,
                   float* __restrict__ scores_p, float* __restrict__ l1_p,
                   float* __restrict__ d2_p, float* __restrict__ gram_p,
                   float* __restrict__ med_out, float* __restrict__ mean_out) {
  constexpr int TS = THREADS + 1;                      // padded tile stride
  __shared__ float acc[3][WARPS][M];
  // Dynamic shared memory.  With gram: the tile [M][TS], then the pair
  // sums gsum [M*M] (thread tid owns pairs tid, tid + THREADS, ...; in
  // shared memory because registers spill at M = 64).  Then, for
  // M >= SMEM_SORT_M, the sort columns [pow2_at_least(M)][THREADS].
  extern __shared__ float tile[];
  float* gsum = tile + M * TS;
  float* sort_scratch = (needs & NEED_GRAM) ? gsum + M * M : tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool want_gram = needs & NEED_GRAM;
  const bool want_med = COLUMN_OUT || (needs & (NEED_L1 | NEED_D2MED));
  const bool want_mean = COLUMN_OUT || (needs & NEED_SCORES);
  for (int i = tid; i < 3 * WARPS * M; i += THREADS) (&acc[0][0][0])[i] = 0.f;
  if (want_gram) {
    for (int p = tid; p < M * M; p += THREADS) gsum[p] = 0.f;
  }
  __syncthreads();

  const long long n_tiles = (d + THREADS - 1) / THREADS;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long col = t * THREADS + tid;
    const bool valid = col < d;
    float g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = valid ? __ldg(G + i * d + col) : 0.f;

    if (want_gram) {
#pragma unroll
      for (int i = 0; i < M; ++i) tile[i * TS + tid] = g[i];
    }
    const float mean = want_mean ? column_mean<M>(g) : 0.f;
    if (needs & NEED_SCORES) {
      int n_above = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) n_above += g[i] >= mean;
      const bool maj_above = 2 * n_above >= M;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        // !(g >= mean), not g < mean: a NaN compares false both ways
        const bool on = maj_above ? (g[i] >= mean) : !(g[i] >= mean);
        const float v = warp_sum(valid && on ? 1.f : 0.f);
        if (lane == 0) acc[0][warp][i] += v;
      }
    }
    if (want_med) {
      const float med = column_median<M>(g, sort_scratch);
      if (COLUMN_OUT && valid) {
        med_out[col] = med;
        mean_out[col] = mean;
      }
      if (needs & NEED_L1) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float v = warp_sum(valid ? fabsf(__fsub_rn(g[i], med)) : 0.f);
          if (lane == 0) acc[1][warp][i] += v;
        }
      }
      if (needs & NEED_D2MED) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float df = __fsub_rn(g[i], med);
          const float v = warp_sum(valid ? __fmul_rn(df, df) : 0.f);
          if (lane == 0) acc[2][warp][i] += v;
        }
      }
    }
    if (want_gram) {
      __syncthreads();
      for (int p = tid; p < M * M; p += THREADS) {
        const float* a = tile + (p / M) * TS;
        const float* b = tile + (p % M) * TS;
        float s = 0.f;
        for (int c = 0; c < THREADS; ++c) s = fmaf(a[c], b[c], s);
        gsum[p] += s;
      }
      __syncthreads();
    }
  }

  __syncthreads();
  if (tid < M) {
    float* outs[3] = {scores_p, l1_p, d2_p};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (outs[s] == nullptr) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += acc[s][w][tid];
      outs[s][static_cast<long long>(blockIdx.x) * M + tid] = v;
    }
  }
  if (want_gram) {
    for (int p = tid; p < M * M; p += THREADS)
      gram_p[static_cast<long long>(blockIdx.x) * M * M + p] = gsum[p];
  }
}

// Weighted row combine Σ_i w_i g_i / Σ_i w_i over the columns.
// SELECT: the weights are the C1∩C2 mask recomputed from sl [2, M]
// (scores; l1) and pr [2] (kth score; 2·𝔗), falling back to C2 when
// the intersection is empty; block 0 writes them to w_out [M].
// Otherwise the weights are read from w_in [M].
template <int M, bool SELECT>
__global__ void __launch_bounds__(THREADS)
combine_rows_kernel(const float* __restrict__ G, long long d,
                    const float* __restrict__ w_in, const float* __restrict__ pr,
                    float* __restrict__ out, float* __restrict__ w_out) {
  __shared__ float w[M];
  __shared__ float den;
  const int tid = threadIdx.x;
  if (tid == 0) {
    if (SELECT) {
      bool c1[M], c2[M];
      bool any = false;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        c1[i] = w_in[M + i] <= pr[1];
        c2[i] = w_in[i] >= pr[0];
        any = any || (c1[i] && c2[i]);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) w[i] = (any ? (c1[i] && c2[i]) : c2[i]) ? 1.f : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i) w[i] = w_in[i];
    }
    float sw = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) sw = __fadd_rn(sw, w[i]);
    den = sw > 0.f ? sw : 1.f;
  }
  __syncthreads();
  if (SELECT && blockIdx.x == 0 && tid < M) w_out[tid] = w[tid];
  for (long long col = static_cast<long long>(blockIdx.x) * THREADS + tid; col < d;
       col += static_cast<long long>(gridDim.x) * THREADS) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (w[i] != 0.f) a = __fadd_rn(a, __fmul_rn(w[i], __ldg(G + i * d + col)));
    }
    out[col] = __fdiv_rn(a, den);
  }
}

// B5: coordinate-wise trimmed mean out [d] with k rows trimmed per side
// (0 <= 2k < M, checked by the wrapper).  Replaces
// src/repro/kernels/brsgd_stats.py:_trimmed_mean_kernel (trimmed_mean_pallas).
// Bound: bytes, G read once plus out written, (M+1)·d·4 B; the sort costs
// the same compare-exchanges per column as B1/B4 (240 at M = 20).  One
// thread per column, a grid-stride walk over the columns, the ragged
// last block masked by the column test; no partials, no reduction.
template <int M>
__global__ void __launch_bounds__(THREADS)
trimmed_mean_kernel(const float* __restrict__ G, long long d, int k,
                    float* __restrict__ out) {
  extern __shared__ float sort_scratch[];  // used from SMEM_SORT_M on
  for (long long col = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       col < d; col += static_cast<long long>(gridDim.x) * THREADS) {
    float g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = __ldg(G + i * d + col);
    out[col] = column_trimmed_mean<M>(g, k, sort_scratch);
  }
}

template <int M>
int launch_stats(const float* G, long long d, int needs, float* sc, float* l1,
                 float* d2, float* gram, float* med, float* mean, int n_blocks,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (((needs & NEED_GRAM) ? M * (THREADS + 1) + M * M : 0) +
                       (M >= SMEM_SORT_M ? pow2_at_least(M) * THREADS : 0));
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (M = 64)
    cudaFuncSetAttribute(fused_stats_kernel<M, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(fused_stats_kernel<M, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (med != nullptr) {
    fused_stats_kernel<M, true><<<n_blocks, THREADS, smem, stream>>>(
        G, d, needs, sc, l1, d2, gram, med, mean);
  } else {
    fused_stats_kernel<M, false><<<n_blocks, THREADS, smem, stream>>>(
        G, d, needs, sc, l1, d2, gram, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_combine(const float* G, long long d, const float* w_in, const float* pr,
                   float* out, float* w_out, int n_blocks, cudaStream_t stream) {
  if (pr != nullptr) {
    combine_rows_kernel<M, true><<<n_blocks, THREADS, 0, stream>>>(G, d, w_in, pr, out, w_out);
  } else {
    combine_rows_kernel<M, false><<<n_blocks, THREADS, 0, stream>>>(G, d, w_in, nullptr, out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_trimmed_mean(const float* G, long long d, int k, float* out, int n_blocks,
                        cudaStream_t stream) {
  if (k < 0 || 2 * k >= M) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = M >= SMEM_SORT_M ? sizeof(float) * pow2_at_least(M) * THREADS : 0;
  trimmed_mean_kernel<M><<<n_blocks, THREADS, smem, stream>>>(G, d, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the worker counts the kernels are instantiated for
#define BRSGD_DISPATCH(m, CALL)                      \
  switch (m) {                                       \
    case 4: { constexpr int M = 4; return CALL; }    \
    case 5: { constexpr int M = 5; return CALL; }    \
    case 7: { constexpr int M = 7; return CALL; }    \
    case 8: { constexpr int M = 8; return CALL; }    \
    case 10: { constexpr int M = 10; return CALL; }  \
    case 16: { constexpr int M = 16; return CALL; }  \
    case 20: { constexpr int M = 20; return CALL; }  \
    case 32: { constexpr int M = 32; return CALL; }  \
    case 64: { constexpr int M = 64; return CALL; }  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" {

int brsgd_threads() { return THREADS; }

int brsgd_max_blocks() { return MAX_BLOCKS; }

const char* brsgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B1: partials of the requested statistics (null pointer = not requested)
int brsgd_fused_stats(const void* G, int m, long long d, int needs, void* scores_p,
                      void* l1_p, void* d2_p, void* gram_p, int n_blocks,
                      void* stream) {
  BRSGD_DISPATCH(m, launch_stats<M>(
      static_cast<const float*>(G), d, needs, static_cast<float*>(scores_p),
      static_cast<float*>(l1_p), static_cast<float*>(d2_p),
      static_cast<float*>(gram_p), nullptr, nullptr, n_blocks,
      static_cast<cudaStream_t>(stream)))
}

// B4: median [d], mean [d], scores and l1 partials
int brsgd_column_stats(const void* G, int m, long long d, void* med, void* mean,
                       void* scores_p, void* l1_p, int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, launch_stats<M>(
      static_cast<const float*>(G), d, NEED_SCORES | NEED_L1,
      static_cast<float*>(scores_p), static_cast<float*>(l1_p), nullptr, nullptr,
      static_cast<float*>(med), static_cast<float*>(mean), n_blocks,
      static_cast<cudaStream_t>(stream)))
}

// B2: selection from sl [2, m] and pr [2], then the masked mean
int brsgd_select_mean(const void* G, int m, long long d, const void* sl, const void* pr,
                      void* out, void* w_out, int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, launch_combine<M>(
      static_cast<const float*>(G), d, static_cast<const float*>(sl),
      static_cast<const float*>(pr), static_cast<float*>(out),
      static_cast<float*>(w_out), n_blocks, static_cast<cudaStream_t>(stream)))
}

// B3: masked / weighted mean with weights w [m]
int brsgd_masked_mean(const void* G, int m, long long d, const void* w, void* out,
                      int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, launch_combine<M>(
      static_cast<const float*>(G), d, static_cast<const float*>(w), nullptr,
      static_cast<float*>(out), nullptr, n_blocks, static_cast<cudaStream_t>(stream)))
}

// B5: trimmed mean [d], k rows dropped from each side of every column
int brsgd_trimmed_mean(const void* G, int m, long long d, int k, void* out,
                       int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, launch_trimmed_mean<M>(
      static_cast<const float*>(G), d, k, static_cast<float*>(out), n_blocks,
      static_cast<cudaStream_t>(stream)))
}

}  // extern "C"
