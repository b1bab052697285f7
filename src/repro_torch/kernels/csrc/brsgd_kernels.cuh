// Hand-written Hopper (sm_90a) kernels for the BrSGD aggregation pass
// over the worker-gradient matrix G [m, d] (f32, row-major, m workers).
// Two libraries are built from this header: brsgd_stats.cu, the tuned
// instances, and brsgd_bucket.cu, one instance per power of two for every
// other m <= 64 (the BUCKET flag below); each defines BRSGD_DISPATCH.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/brsgd_stats.py:
//
//   column_stats_kernel<M, V>     <- fused_stats_pallas (_fused_stats_kernel)
//                                    without gram: any subset of scores,
//                                    l1, d2med [m] in one read of G
//                                    (V = the NEED_* bits); brsgd_stats_pallas
//                                    (_stats_kernel, V = COLUMN_OUT | scores
//                                    | l1): also median [d] and mean [d];
//                                    cwise_median_pallas (V = COLUMN_OUT):
//                                    median [d] and nothing else;
//                                    trimmed_mean_pallas (_trimmed_mean_kernel,
//                                    V = TRIM_OUT): per column, the mean of
//                                    the sorted rows k..m-k-1 ([d] out).
//   fused_stats_kernel<M>         <- fused_stats_pallas with gram [m, m]
//                                    (and any other statistic beside it).
//   select_mean_kernel<M>         <- select_mean_pallas (_select_mean_kernel):
//                                    C1∩C2 selection (C2 fallback) fused with
//                                    the masked row mean.
//   masked_mean_kernel<M>         <- masked_mean_pallas (masked_mean_kernel):
//                                    Σ w_i g_i / Σ w_i, empty mask divides by
//                                    1; unit weights when none are given.
//   select_aggregate_kernel<M, R> <- the engine's local composition of a
//                                    select rule in ONE cooperative launch:
//                                    pass 1 (B1's call), the partials summed
//                                    between two grid barriers, the rule
//                                    resolved in every block, pass 2 (B3).
//                                    R = brsgd (B1's (scores, l1) call and
//                                    B2 with the thresholds between them),
//                                    krum / multi_krum, geomedian.
//
// What bounds them: bytes.  Each kernel reads G once (m·d·4 bytes) and
// does O(m log² m) compare-exchanges per column (O(m²) for gram), below
// the card's FP32 rate per byte but not far below it, so a column's
// sort has to run while the next columns' loads are in flight; at the
// LeNet shape [20, 61706] G is 4.9 MB and sits in the 50 MB L2, so
// launch latency dominates.
//
// Design:
//   * One thread owns one column; a block covers THREADS consecutive
//     columns (coalesced row loads) and walks tiles with a grid stride.
//     The TPU grid's sequential carry becomes per-block partials [grid,
//     m] ([grid, m, m] for gram) that the wrapper sums, or that the
//     cooperative launches sum between grid barriers.  No float atomics:
//     the partial order is fixed, so l1 — which decides C1 — is the same
//     on every run.
//   * The column pass (column_stats_kernel) keeps loads in flight through
//     a cp.async ring of tiles in shared memory, counts scores by warp
//     ballot and sums l1 / d2med in registers across all of a thread's
//     tiles, reduced once per block (see its own note).
//   * The ragged last tile is masked (invalid columns contribute exact
//     zeros), so no zero-pad columns and no "+1 score per pad column"
//     correction exist here.
//   * The worker count is a template constant M: the column lives in
//     registers and the sorting network (ref.bitonic_stages, padded with
//     +inf to a power of two) fully unrolls; the median is rows[m/2] or
//     the exact two-middle average, bit-equal to the plain version.  Two
//     kinds of instance (the BUCKET template flag, m the kernels' last
//     argument): a tuned instance (brsgd_stats.cu) has m == M, every `i <
//     m` below folds away and the pad slots are known at compile time; a
//     bucket instance (brsgd_bucket.cu) serves every m <= M of its power
//     of two M at run time: rows m..M-1 are never loaded, the sort
//     column's slots m..M-1 hold +inf (as ref.bitonic_stages pads them),
//     the whole network runs, and the middle slots are picked by m.  The column pass and the
//     cooperative launches track the +inf pad slots at compile time
//     (padfree_stages: 134 of 240 compare-exchanges at m = 20), the
//     column pass also drops those the middle slots do not need.  At m =
//     64 the median's sorted copy goes to shared memory (registers
//     spilled); the trimmed mean keeps its column in registers.
//   * NaN in G propagates as in the plain versions: a column holding a
//     NaN has a NaN median (as the NaN-propagating sort of ref gives),
//     and the below-mean side is !(g >= mean), as the plain ~above.
//   * Column mean: row-order sum, IEEE division by m.  The combine sums
//     rows in order 0..m-1 with __fmul_rn/__fadd_rn (no FMA contraction),
//     weight-0 rows included (0·NaN and 0·inf are NaN, as the reference's
//     w @ g gives), and divides by Σw summed in row order, which
//     reproduces ref.masked_mean_det bit for bit on any weights.
//   * gram: the tile is staged in shared memory and each thread owns a
//     4 x 4 block of (i, j) pairs over a slice of its columns, the sums in
//     registers across tiles (GramAcc below).
//
// Plain C interface for ctypes: every entry returns cudaGetLastError()
// after its launch; nothing here allocates or synchronises.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

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

__device__ __forceinline__ double warp_sum(double v) {
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

// at(i) for a runtime i < MP: a predicated pick over the slots, so a
// register array is never indexed at run time (a constant i folds to
// at(i))
template <int MP, typename At>
__device__ __forceinline__ float pick(At at, int i) {
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < MP; ++j)
    if (j == i) v = at(j);
  return v;
}

// The median of the sorted slots at(0..m): at(m/2), or the exact average
// of the two middle slots.
template <int MP, typename At>
__device__ __forceinline__ float middle_of(At at, int m) {
  if (m % 2) return pick<MP>(at, m / 2);
  return __fmul_rn(0.5f, __fadd_rn(pick<MP>(at, m / 2 - 1), pick<MP>(at, m / 2)));
}

// Fills at(0..MP-1) with the column g[0..m) padded with +inf to a power of
// two and sorts it; returns whether the column holds a NaN.  A NaN anywhere
// in the column makes every sorted row NaN in the plain version's
// NaN-propagating network (every output depends on every input), so the
// callers return NaN for such a column.  One test per column costs less
// than one per compare-exchange.
template <int M, typename At>
__device__ __forceinline__ bool sort_column(const float (&g)[M], int m, At at) {
  constexpr int MP = pow2_at_least(M);
  bool any_nan = false;
#pragma unroll
  for (int i = 0; i < MP; ++i) at(i) = i < M && i < m ? g[i] : INFINITY;
#pragma unroll
  for (int i = 0; i < M; ++i) any_nan |= i < m && isnan(g[i]);
  bitonic_sort<MP>(at);
  return any_nan;
}

template <int M, typename At>
__device__ __forceinline__ float sorted_median(const float (&g)[M], int m, At at) {
  if (sort_column<M>(g, m, at)) return NAN;
  return middle_of<pow2_at_least(M)>(at, m);
}

// The sort slots of this thread: registers below SMEM_SORT_M; from there
// on its strided column of scratch, which holds THREADS columns of
// pow2_at_least(M) floats.
template <int M>
__device__ __forceinline__ float column_median(const float (&g)[M], int m, float* scratch) {
  if constexpr (M >= SMEM_SORT_M) {
    float* col = scratch + threadIdx.x;
    return sorted_median<M>(g, m, [col](int i) -> float& { return col[i * THREADS]; });
  } else {
    float s[pow2_at_least(M)];
    return sorted_median<M>(g, m, [&s](int i) -> float& { return s[i]; });
  }
}

// rows 0..m-1 in order, IEEE-divided by m
template <int M>
__device__ __forceinline__ float column_mean(const float (&g)[M], int m) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < m) s = __fadd_rn(s, g[i]);
  return __fdiv_rn(s, static_cast<float>(m));
}

// ---- the gram pass: B1's gram call and pass 1 of the gram rules below.
// Each block stages a tile of THREADS columns in shared memory, rows
// [gram_rows(m)][GRAM_LD] (the pad rows m.. stay zero).  Thread items
// (block pair, column slice): a block pair is a GRAM_RB x GRAM_RB block
// of rows (bi, bj) with bi <= bj, so the m(m+1)/2 distinct pairs are
// covered once (diagonal blocks hold both (i, j) and (j, i), with the
// same bits); a column slice is every CS-th float4 group of the tile.
// Per group a thread loads 4 + 4 float4 (rows of bi, rows of bj) and
// does 64 FMAs into 16 accumulators that live in registers across all
// of the block's tiles, so a column costs 2/GRAM_RB shared loads per
// product instead of 2.  The CS slices of a block pair are CS adjacent
// lanes: a fixed shuffle tree sums them once at the end.  No atomics:
// every run gives the same bits.
constexpr int GRAM_RB = 4;             // rows per register block
constexpr int GRAM_LD = THREADS + 4;   // tile row stride: 16-byte rows, 4 banks apart

__host__ __device__ constexpr int gram_slices(int nbp) {
  int p = 1;
  while (2 * p <= 32 && 2 * p * nbp <= THREADS) p *= 2;
  return p;
}

// The plan of an instance of M rows; a bucket instance at m < M runs the
// row blocks of its m rows only (the items past them idle).
template <int M>
struct GramPlan {
  static constexpr int MB = (M + GRAM_RB - 1) / GRAM_RB;   // row blocks
  static constexpr int NBP = MB * (MB + 1) / 2;              // block pairs
  static constexpr int CS = gram_slices(NBP);                // slices a pair
  static constexpr int GROUPS = THREADS / 4 / CS;            // float4 groups a slice
  static constexpr int ITEMS = (NBP * CS + THREADS - 1) / THREADS;
};

// tile rows at m workers: m rounded up to GRAM_RB (rows m.. stay zero)
__host__ __device__ constexpr int gram_rows(int m) {
  return (m + GRAM_RB - 1) / GRAM_RB * GRAM_RB;
}

// the distinct pairs (i <= j) of m workers
__host__ __device__ constexpr int gram_pairs(int m) { return m * (m + 1) / 2; }

// index of the pair (i, j), i <= j, in the packed upper triangle
__host__ __device__ constexpr int gram_pair(int i, int j, int m) {
  return i * m - i * (i - 1) / 2 + (j - i);
}

template <int M>
struct GramAcc {
  using P = GramPlan<M>;
  float acc[P::ITEMS][GRAM_RB * GRAM_RB];
  int bi[P::ITEMS], bj[P::ITEMS], cs[P::ITEMS];
  bool on[P::ITEMS];

  __device__ __forceinline__ void init(int m) {
    const int mb = (m + GRAM_RB - 1) / GRAM_RB;
#pragma unroll
    for (int u = 0; u < P::ITEMS; ++u) {
      const int it = threadIdx.x + u * THREADS;
      on[u] = it < mb * (mb + 1) / 2 * P::CS;
      int r = on[u] ? it / P::CS : 0, a = 0;
      while (r >= mb - a) {
        r -= mb - a;
        ++a;
      }
      bi[u] = a;
      bj[u] = a + r;
      cs[u] = it % P::CS;
#pragma unroll
      for (int e = 0; e < GRAM_RB * GRAM_RB; ++e) acc[u][e] = 0.f;
    }
  }

  // adds the products of one staged tile [ROWS][GRAM_LD]
  __device__ __forceinline__ void add_tile(const float* __restrict__ tile) {
#pragma unroll
    for (int u = 0; u < P::ITEMS; ++u) {
      if (!on[u]) continue;
      const float* A = tile + bi[u] * GRAM_RB * GRAM_LD;
      const float* B = tile + bj[u] * GRAM_RB * GRAM_LD;
#pragma unroll 2
      for (int q = 0; q < P::GROUPS; ++q) {
        const int c = 4 * (q * P::CS + cs[u]);
        float4 a[GRAM_RB], b[GRAM_RB];
#pragma unroll
        for (int r = 0; r < GRAM_RB; ++r) {
          a[r] = *reinterpret_cast<const float4*>(A + r * GRAM_LD + c);
          b[r] = *reinterpret_cast<const float4*>(B + r * GRAM_LD + c);
        }
#pragma unroll
        for (int r = 0; r < GRAM_RB; ++r) {
#pragma unroll
          for (int s = 0; s < GRAM_RB; ++s) {
            float& x = acc[u][r * GRAM_RB + s];
            x = fmaf(a[r].x, b[s].x, x);
            x = fmaf(a[r].y, b[s].y, x);
            x = fmaf(a[r].z, b[s].z, x);
            x = fmaf(a[r].w, b[s].w, x);
          }
        }
      }
    }
  }

  // The block's sums: each pair (i <= j < m) goes to store(i, j, v) once.
  // Every lane of the block must call this.
  template <typename Store>
  __device__ __forceinline__ void finish(int m, Store store) {
#pragma unroll
    for (int u = 0; u < P::ITEMS; ++u) {
#pragma unroll
      for (int e = 0; e < GRAM_RB * GRAM_RB; ++e) {
        float v = acc[u][e];
#pragma unroll
        for (int o = P::CS / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o, P::CS);
        acc[u][e] = v;
      }
      if (on[u] && cs[u] == 0) {
#pragma unroll
        for (int r = 0; r < GRAM_RB; ++r) {
#pragma unroll
          for (int s = 0; s < GRAM_RB; ++s) {
            const int i = bi[u] * GRAM_RB + r, j = bj[u] * GRAM_RB + s;
            if (i <= j && j < m) store(i, j, acc[u][r * GRAM_RB + s]);
          }
        }
      }
    }
  }
};

// zeroes the pad rows m..gram_rows(m)-1 of n_slots staged tiles of `slot`
// floats
__device__ __forceinline__ void zero_pad_rows(float* tiles, int n_slots, int slot, int m) {
  const int pad = (gram_rows(m) - m) * GRAM_LD;
  if (pad > 0) {
    for (int s = 0; s < n_slots; ++s)
      for (int p = threadIdx.x; p < pad; p += THREADS) tiles[s * slot + m * GRAM_LD + p] = 0.f;
  }
}

// B1's gram call: one pass over G.  Partials: gram [gridDim.x, m, m]
// and, where requested (a non-null pointer), scores / l1 / d2med
// [gridDim.x, m], the latter summed per tile by warp shuffles.  A call
// without gram takes the column pass below (column_stats_kernel).  m:
// the worker count (M itself for a tuned instance).
template <int M, bool BUCKET>
__global__ void __launch_bounds__(THREADS)
fused_stats_kernel(const float* __restrict__ G, long long d, int needs,
                   float* __restrict__ scores_p, float* __restrict__ l1_p,
                   float* __restrict__ d2_p, float* __restrict__ gram_p, int m_arg) {
  const int m = BUCKET ? m_arg : M;
  __shared__ float acc[3][WARPS][M];
  // Dynamic shared memory: the staged tile [gram_rows(m)][GRAM_LD], then,
  // for M >= SMEM_SORT_M, the sort columns [pow2_at_least(M)][THREADS].
  extern __shared__ __align__(16) float tile[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sort_scratch = tile + gram_rows(m) * GRAM_LD;
  const bool want_med = needs & (NEED_L1 | NEED_D2MED);
  const bool want_mean = needs & NEED_SCORES;
  for (int i = tid; i < 3 * WARPS * M; i += THREADS) (&acc[0][0][0])[i] = 0.f;
  GramAcc<M> gram;
  gram.init(m);
  zero_pad_rows(tile, 1, 0, m);
  __syncthreads();

  const long long n_tiles = (d + THREADS - 1) / THREADS;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long col = t * THREADS + tid;
    const bool valid = col < d;
    float g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = valid && i < m ? __ldg(G + i * d + col) : 0.f;

#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m) tile[i * GRAM_LD + tid] = g[i];
    const float mean = want_mean ? column_mean<M>(g, m) : 0.f;
    if (needs & NEED_SCORES) {
      int n_above = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) n_above += i < m && g[i] >= mean;
      const bool maj_above = 2 * n_above >= m;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < m) {
          // !(g >= mean), not g < mean: a NaN compares false both ways
          const bool on = maj_above ? (g[i] >= mean) : !(g[i] >= mean);
          const float v = warp_sum(valid && on ? 1.f : 0.f);
          if (lane == 0) acc[0][warp][i] += v;
        }
      }
    }
    if (want_med) {
      const float med = column_median<M>(g, m, sort_scratch);
      if (needs & NEED_L1) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i < m) {
            const float v = warp_sum(valid ? fabsf(__fsub_rn(g[i], med)) : 0.f);
            if (lane == 0) acc[1][warp][i] += v;
          }
        }
      }
      if (needs & NEED_D2MED) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i < m) {
            const float df = __fsub_rn(g[i], med);
            const float v = warp_sum(valid ? __fmul_rn(df, df) : 0.f);
            if (lane == 0) acc[2][warp][i] += v;
          }
        }
      }
    }
    __syncthreads();
    gram.add_tile(tile);
    __syncthreads();
  }

  __syncthreads();
  if (tid < m) {
    float* outs[3] = {scores_p, l1_p, d2_p};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (outs[s] == nullptr) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += acc[s][w][tid];
      outs[s][static_cast<long long>(blockIdx.x) * m + tid] = v;
    }
  }
  float* gb = gram_p + static_cast<long long>(blockIdx.x) * m * m;
  gram.finish(m, [gb, m](int i, int j, float v) {
    gb[i * m + j] = v;
    gb[j * m + i] = v;
  });
}

// B2: the C1∩C2 mask recomputed from sl [2, m] (scores; l1) and pr [2]
// (kth score; 2·𝔗), falling back to C2 when the intersection is empty;
// block 0 writes it to w_out [m]; then Σ_i w_i g_i / Σ_i w_i over the
// columns, every row summed (weight 0 included, as the reference's w @ g).
template <int M, bool BUCKET>
__global__ void __launch_bounds__(THREADS)
select_mean_kernel(const float* __restrict__ G, long long d,
                   const float* __restrict__ sl, const float* __restrict__ pr,
                   float* __restrict__ out, float* __restrict__ w_out, int m_arg) {
  const int m = BUCKET ? m_arg : M;
  __shared__ float w[M];
  __shared__ float den;
  const int tid = threadIdx.x;
  if (tid == 0) {
    bool c1[M], c2[M];
    bool any = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      c1[i] = i < m && sl[m + i] <= pr[1];
      c2[i] = i < m && sl[i] >= pr[0];
      any = any || (c1[i] && c2[i]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m) w[i] = (any ? (c1[i] && c2[i]) : c2[i]) ? 1.f : 0.f;
    float sw = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m) sw = __fadd_rn(sw, w[i]);
    den = sw > 0.f ? sw : 1.f;
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < m) w_out[tid] = w[tid];
  for (long long col = static_cast<long long>(blockIdx.x) * THREADS + tid; col < d;
       col += static_cast<long long>(gridDim.x) * THREADS) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) a = __fadd_rn(a, __fmul_rn(w[i], __ldg(G + i * d + col)));
    }
    out[col] = __fdiv_rn(a, den);
  }
}

// B3: Σ_i w_i g_i / Σ_i w_i with Σw summed in row order and guarded to
// 1 (an empty mask divides by 1); w_in == nullptr means unit weights
// (the mean).  With `small`, block 0 writes w [m] floats, then w > 0 as
// m bytes.  Replaces src/repro/kernels/brsgd_stats.py:masked_mean_kernel
// (masked_mean_pallas).  Bound: bytes, every row read once (weight 0
// included, as the reference's w @ g) and out written.  One thread a column, a grid-stride walk; the
// rows are compile-time indices, so their addresses are strength-reduced
// and the compiler issues the predicated loads in batches (5-7 at once at
// M = 20, as many as it has predicate registers).  A row list with every
// load of a column in flight at once (combine_tiles) measured slower at
// both of the paper's shapes, so B3 keeps this loop.
template <int M, bool BUCKET>
__global__ void __launch_bounds__(THREADS)
masked_mean_kernel(const float* __restrict__ G, long long d, const float* __restrict__ w_in,
                   float* __restrict__ out, float* __restrict__ small, int m_arg) {
  const int m = BUCKET ? m_arg : M;
  __shared__ float w[M];
  __shared__ float den;
  const int tid = threadIdx.x;
  if (tid == 0) {
    float sw = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        w[i] = w_in != nullptr ? w_in[i] : 1.f;
        sw = __fadd_rn(sw, w[i]);
      }
    }
    den = sw > 0.f ? sw : 1.f;
  }
  __syncthreads();
  if (small != nullptr && blockIdx.x == 0 && tid < m) {
    small[tid] = w[tid];
    reinterpret_cast<unsigned char*>(small + m)[tid] = w[tid] > 0.f;
  }
  for (long long col = static_cast<long long>(blockIdx.x) * THREADS + tid; col < d;
       col += static_cast<long long>(gridDim.x) * THREADS) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) a = __fadd_rn(a, __fmul_rn(w[i], __ldg(G + i * d + col)));
    }
    out[col] = __fdiv_rn(a, den);
  }
}

// The median of the fused kernel below SMEM_SORT_M: the network of
// bitonic_sort<MP> with the +inf pad slots tracked at compile time.  A
// compare-exchange of two real slots runs as there; one with a pad slot
// is a move or nothing (min(x, +inf) = x for any x that is not NaN), two
// pad slots nothing.  For a column without NaN every real slot ends with
// the bits the padded network gives it, so the median keeps its bits; a
// NaN column returns NaN, as sort_column's callers do.  At M = 20, 134 of
// the 240 compare-exchanges remain, and the compiler drops those the two
// middle slots do not need.
struct PadSlots {
  unsigned long long before[32];  // pad-slot mask before each stage
};

template <int MP, int M>
__host__ __device__ constexpr PadSlots pad_slots() {
  PadSlots t{};
  unsigned long long pad = 0;
  for (int p = M; p < MP; ++p) pad |= 1ull << p;
  int s = 0;
  for (int k = 2; k <= MP; k *= 2) {
    for (int j = k / 2; j >= 1; j /= 2) {
      t.before[s++] = pad;
      unsigned long long next = pad;
      for (int i = 0; i < MP; ++i) {
        const int l = i ^ j;
        if (l > i && ((pad >> i) & 1) != ((pad >> l) & 1)) {
          // the +inf goes to l when ascending, to i when descending
          next &= ~((1ull << i) | (1ull << l));
          next |= 1ull << (((i & k) == 0) ? l : i);
        }
      }
      pad = next;
    }
  }
  return t;
}

// The slots whose values are read after each stage when only the slots
// of KEEP are read at the end: a compare-exchange with a live output
// needs both inputs.  A stage's pruned network drops the
// compare-exchanges with no live output and computes only the live side
// of the others, so the slots of KEEP end with the bits the whole network
// gives them.  KEEP = every slot keeps the whole network.
struct LiveSlots {
  unsigned long long after[32];  // live-slot mask after each stage
};

template <int MP, unsigned long long KEEP>
__host__ __device__ constexpr LiveSlots live_slots() {
  LiveSlots t{};
  int dist[32] = {};
  int n = 0;
  for (int k = 2; k <= MP; k *= 2)
    for (int j = k / 2; j >= 1; j /= 2) dist[n++] = j;
  unsigned long long live = KEEP;
  for (int s = n - 1; s >= 0; --s) {
    t.after[s] = live;
    unsigned long long before = live;
    for (int i = 0; i < MP; ++i) {
      const int l = i ^ dist[s];
      if (l > i && (((live >> i) | (live >> l)) & 1)) before |= (1ull << i) | (1ull << l);
    }
    live = before;
  }
  return t;
}

// min / max of the network: fminf / fmaxf (a NaN drops out: the callers
// test the column for NaN), or with NAN_OUT min.NaN / max.NaN, which
// return NaN when either input is NaN.  Every output slot of a sorting
// network depends on every input, so with NAN_OUT a NaN anywhere in the
// column reaches every slot the network computes: the median is NaN
// without a test, as the plain version's NaN-propagating network gives.
template <bool NAN_OUT>
__device__ __forceinline__ float net_min(float a, float b) {
  if constexpr (NAN_OUT) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  } else {
    return fminf(a, b);
  }
}

template <bool NAN_OUT>
__device__ __forceinline__ float net_max(float a, float b) {
  if constexpr (NAN_OUT) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  } else {
    return fmaxf(a, b);
  }
}

// Stage S (block size K, distance J) of the pad-tracked network, then the
// rest; template recursion keeps every pad and liveness test a
// compile-time constant.  KEEP: the slots the caller reads (live_slots);
// NAN_OUT: net_min / net_max.
template <int MP, int M, int K, int J, int S, unsigned long long KEEP = ~0ull,
          bool NAN_OUT = false, typename At>
__device__ __forceinline__ void padfree_stages(At at) {
  constexpr unsigned long long pad = pad_slots<MP, M>().before[S];
  constexpr unsigned long long live = live_slots<MP, KEEP>().after[S];
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int l = i ^ J;
    if (l > i) {
      const bool pi = (pad >> i) & 1, pl = (pad >> l) & 1;
      const bool li = (live >> i) & 1, ll = (live >> l) & 1;
      const bool asc = (i & K) == 0;
      if (!pi && !pl) {
        if (li && ll) {
          const float lo = net_min<NAN_OUT>(at(i), at(l));
          const float hi = net_max<NAN_OUT>(at(i), at(l));
          at(i) = asc ? lo : hi;
          at(l) = asc ? hi : lo;
        } else if (li) {
          at(i) = asc ? net_min<NAN_OUT>(at(i), at(l)) : net_max<NAN_OUT>(at(i), at(l));
        } else if (ll) {
          at(l) = asc ? net_max<NAN_OUT>(at(i), at(l)) : net_min<NAN_OUT>(at(i), at(l));
        }
      } else if (pl && !pi && !asc) {
        if (ll) at(l) = at(i);
      } else if (pi && !pl && asc) {
        if (li) at(i) = at(l);
      }
    }
  }
  if constexpr (J > 1) {
    padfree_stages<MP, M, K, J / 2, S + 1, KEEP, NAN_OUT>(at);
  } else if constexpr (K < MP) {
    padfree_stages<MP, M, 2 * K, K, S + 1, KEEP, NAN_OUT>(at);
  }
}

// g[0..M) (no NaN) ascending into at(0..M) with the pad-free network (a
// bucket instance's caller fills g[m..M) with +inf: M is a power of two
// there, and the whole network runs)
template <int M, typename At>
__device__ __forceinline__ void sort_real(const float (&g)[M], At at) {
  constexpr int MP = pow2_at_least(M);
#pragma unroll
  for (int i = 0; i < M; ++i) at(i) = g[i];
  padfree_stages<MP, M, 2, 1, 0>(at);
}

// the median of g[0..m) by the pad-free network (at m < M, a bucket
// instance's power of two M, slots m.. hold +inf)
template <int M>
__device__ __forceinline__ float padfree_median(const float (&g)[M], int m) {
  constexpr int MP = pow2_at_least(M);
  float s[MP];
  bool any_nan = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = i < m ? g[i] : INFINITY;
    any_nan |= i < m && isnan(g[i]);
  }
  const auto at = [&s](int i) -> float& { return s[i]; };
  padfree_stages<MP, M, 2, 1, 0>(at);
  if (any_nan) return NAN;
  return middle_of<MP>(at, m);
}

// ---- the column pass: column_stats_kernel<M, VARIANT>, B1's scores /
// l1 / d2med calls (VARIANT = the NEED_* bits), B4 (COLUMN_OUT | scores
// | l1: median and mean [d], scores and l1 partials), the median alone
// (COLUMN_OUT: median [d], nothing else) and B5 (TRIM_OUT: the trimmed
// mean [d], nothing else, k at run time).  Replaces
// src/repro/kernels/brsgd_stats.py: fused_stats_pallas without gram,
// brsgd_stats_pallas, cwise_median_pallas and trimmed_mean_pallas.
//
// What bounds it: bytes, G read once (m·d·4) and the [d] outputs written.
// At m = 20 a column's work (the network's min / max on the half-rate
// ALU pipe, the mean, the score counts, the l1 sums) takes about as long
// as its bytes, so the sort has to run while the next tiles' loads are
// in flight, or the card waits on one and then the other.
//
// Design:
//   * A persistent grid (the occupancy calculator's count, at most one
//     block a tile, and enough blocks that none takes 2^COUNT_PLANES
//     tiles); block b walks the tiles b, b + grid, ... of THREADS
//     columns, one thread a column.
//   * Tiles arrive through a ring of `stages` shared-memory stages [M]
//     [RING_LD], filled by cp.async 16-byte copies that stay in flight
//     while the thread sorts: tile j + stages - 1 is issued before tile j
//     is read.  A row that does not start on 16 bytes (d % 4 != 0, or a
//     view of G) is copied from the 16-byte boundary before its first
//     column, one chunk more: its column c0 + j lands at [i][s_i + j].
//     Chunks past the end of G are zero-filled.  Only the last tile is
//     ragged: its columns past d are masked (exact zeros in every sum, no
//     median written); every other tile runs without a mask.
//   * The median: the pad-free network pruned to the two middle slots
//     (one for odd M), registers below SMEM_SORT_M, else the thread's
//     column of shared memory, with NaN-propagating min / max: a NaN
//     anywhere in a column gives NaN without a test.
//   * The trimmed mean (trimmed_column): the same network keeping every
//     slot (k is a run-time value), in registers at every M, then the
//     slots k..m-k-1 summed in row order, the first slot picked by a
//     chain of tests on the grid-uniform k (kept_sum; a predicate a slot
//     measured slower).  Its ring refills a stage as soon as the column
//     is in registers (EARLY below), so one stage keeps a tile in flight
//     while a column sorts and leaves room for more blocks an SM, which
//     this heavier network wants more than bytes in flight.
//   * Scores: a bit per row at or above the mean, its popcount for the
//     majority side, and the majority rows' bits added to bit-sliced
//     counters (COUNT_PLANES words, bit i of word k = bit k of row i's
//     count: ~2 logic operations a plane for every row at once, the carry
//     stopping at the count's bit length).  Once per block, __ballot_sync
//     of each plane's row bits, weighted 2^k, counted by the lane that
//     keeps row i (lane i % 32 keeps rows i and i + 32 at M = 64).  A
//     ballot and popcount per row per tile measured 11–15% slower at
//     [20, 8388608], 4–5% faster at [20, 61706] (PERF.md §6).  l1 and d2med:
//     summed in registers across the thread's tiles and reduced once per
//     block by the fixed shuffle tree (at M = 64, per-tile warp sums into
//     shared memory: a register copy of the column spills there).  Block
//     partials [grid, M] in a fixed order, no atomics: every run gives the
//     same bits.
constexpr int COLUMN_OUT = 16;            // variant bit: write median [d]
constexpr int TRIM_OUT = 32;              // variant: write the trimmed mean [d]
constexpr int RING_LD = THREADS + 4;      // a staged row: 33 chunks of 16 bytes
constexpr int MAX_STAGES = 4;             // ring stages a launch may ask for
constexpr int COUNT_PLANES = 16;          // bits of a thread's score counts

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `pending` (0 .. MAX_STAGES - 1) groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else if (pending == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// Issues the copies of tile t into a ring stage [m][RING_LD].  Ga is G
// rounded down to 16 bytes and `head` G's offset from it in floats, so
// element e of G is Ga[head + e]; `total` = head + m·d (the bytes of a
// chunk past G's end are zero-filled).  Warp w copies rows w, w + WARPS,
// ...: lane k chunk k, lane 0 also chunk 32 when the row's first column
// is not on 16 bytes.  A tile whose chunks all lie inside G (every tile
// but the last one or two) takes a short path: whole chunks, and a row's
// start stepped by WARPS·d from the warp's previous row (about 10
// instructions a row instead of 25, which a column's sort would wait on).
template <int M>
__device__ __forceinline__ void stage_tile(float* stage, const float* Ga, long long d,
                                           long long total, int head, long long t, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = t * THREADS;
  if (c0 + RING_LD <= d) {  // row m - 1's chunk 32 ends inside G
    long long e = head + warp * d + c0;  // row i's first element, i = warp + r·WARPS
    const float* src = Ga + 4 * lane;
    float* dst = stage + warp * RING_LD + 4 * lane;
#pragma unroll
    for (int r = 0; r < (M + WARPS - 1) / WARPS; ++r) {
      if (r * WARPS + warp < m) {
        const long long e0 = e & ~3ll;
        cp_async16(dst + r * WARPS * RING_LD, src + e0, 16);
        if (lane == 0 && e != e0)
          cp_async16(dst + r * WARPS * RING_LD + THREADS, src + e0 + THREADS, 16);
      }
      e += WARPS * d;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < (M + WARPS - 1) / WARPS; ++r) {
    const int i = r * WARPS + warp;
    if (i < m) {
      const long long e = head + i * d + c0;
      const long long e0 = e & ~3ll;
      float* row = stage + i * RING_LD;
      const auto copy = [&](int k) {
        const long long left = total - (e0 + 4 * k);
        const int bytes = left >= 4 ? 16 : left > 0 ? static_cast<int>(left) * 4 : 0;
        cp_async16(row + 4 * k, bytes > 0 ? Ga + e0 + 4 * k : Ga, bytes);
      };
      copy(lane);
      if (lane == 0 && e != e0) copy(THREADS / 4);
    }
  }
}

// The median of g[0..m): the pad-free network pruned to the middle
// slots, with NaN-propagating min / max (a NaN column gives NaN).  A
// bucket instance (m known at run time only) keeps every slot, fills
// slots m.. with +inf and picks the middle ones by m.
template <int M, bool BUCKET>
__device__ __forceinline__ float middle_median(const float (&g)[M], int m, float* scratch) {
  constexpr int MP = pow2_at_least(M);
  constexpr unsigned long long KEEP =
      BUCKET ? ~0ull : (1ull << (M / 2)) | (M % 2 ? 0ull : 1ull << (M / 2 - 1));
  const auto median = [&](auto at) -> float {
#pragma unroll
    for (int i = 0; i < M; ++i) at(i) = i < m ? g[i] : INFINITY;
    padfree_stages<MP, M, 2, 1, 0, KEEP, true>(at);
    return middle_of<MP>(at, m);
  };
  if constexpr (M >= SMEM_SORT_M) {
    float* col = scratch + threadIdx.x;
    return median([col](int i) -> float& { return col[i * THREADS]; });
  } else {
    float s[MP];
    return median([&s](int i) -> float& { return s[i]; });
  }
}

// The sorted slots k..m-k-1 summed in row order from slot k.  k is the
// same for every thread of the grid, so the chain of tests on it never
// diverges, and each sum starts at a constant slot: no register array is
// indexed at run time, and only a bucket instance (m at run time) tests
// the last slot.
template <int M, int K = 0, typename At>
__device__ __forceinline__ float kept_sum(At at, int m, int k) {
  if constexpr (2 * K < M) {
    if (k != K) return kept_sum<M, K + 1>(at, m, k);
    float acc = at(K);
#pragma unroll
    for (int i = K + 1; i < M - K; ++i)
      if (i < m - K) acc = __fadd_rn(acc, at(i));
    return acc;
  } else {
    return NAN;  // 2k >= m, which the launch refuses
  }
}

// The trimmed mean of g[0..m) (ref.trimmed_mean_ref): the pad-free
// network keeping every slot (k is a run-time value) with
// NaN-propagating min / max (FMNMX.NAN, one instruction: a NaN column
// gives NaN without a test), then the sorted slots k..m-k-1 summed in
// row order from slot k and IEEE-divided by m - 2k.  The column stays in
// registers at every M, 64 included (nothing else lives through the
// sort; the median's sort columns in shared memory would cost the ring
// blocks an SM).  A bucket instance fills slots m.. with +inf.
template <int M>
__device__ __forceinline__ float trimmed_column(const float (&g)[M], int m, int k) {
  constexpr int MP = pow2_at_least(M);
  float s[MP];
  const auto at = [&s](int i) -> float& { return s[i]; };
#pragma unroll
  for (int i = 0; i < M; ++i) at(i) = i < m ? g[i] : INFINITY;
  padfree_stages<MP, M, 2, 1, 0, ~0ull, true>(at);
  return __fdiv_rn(kept_sum<M>(at, m, k), static_cast<float>(m - 2 * k));
}

// Dynamic shared memory of column_stats_kernel<M, VARIANT, BUCKET> in
// floats: the sort columns where it takes a median at M >= SMEM_SORT_M,
// then the ring, stages of [m][RING_LD].
template <int M, int VARIANT>
struct ColumnLayout {
  static constexpr bool MEDIAN = VARIANT & (COLUMN_OUT | NEED_L1 | NEED_D2MED);
  static constexpr bool TRIM = VARIANT & TRIM_OUT;
  static constexpr int SORT = (MEDIAN && M >= SMEM_SORT_M) ? pow2_at_least(M) * THREADS : 0;
};

// a float of shared memory, read again (not merged with an earlier read)
__device__ __forceinline__ float lds_again(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// a bit per row: 32 or 64 bits
template <int M>
using RowBits = typename std::conditional<(M > 32), unsigned long long, unsigned>::type;

__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popc(unsigned long long x) { return __popcll(x); }

template <int M, int VARIANT, bool BUCKET>
__global__ void __launch_bounds__(THREADS)
column_stats_kernel(const float* __restrict__ G, long long d, int stages, int n_planes,
                    int trim_k, float* __restrict__ scores_p, float* __restrict__ l1_p,
                    float* __restrict__ d2_p, float* __restrict__ col_out,
                    float* __restrict__ mean_out, int m_arg) {
  using L = ColumnLayout<M, VARIANT>;
  const int m = BUCKET ? m_arg : M;
  const int stage_floats = m * RING_LD;
  using Bits = RowBits<M>;
  constexpr bool SCORES = VARIANT & NEED_SCORES;
  constexpr bool L1 = VARIANT & NEED_L1;
  constexpr bool D2 = VARIANT & NEED_D2MED;
  constexpr bool COLS = VARIANT & COLUMN_OUT;
  constexpr bool REG_ACC = M < SMEM_SORT_M;  // l1 / d2med sums in registers
  constexpr int CW = (M + 31) / 32;          // score counters a lane keeps
  __shared__ float red[3][WARPS][M];         // per-warp sums: scores, l1, d2med
  extern __shared__ __align__(16) float dyn[];
  float* ring = dyn + L::SORT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (d + THREADS - 1) / THREADS, grid = gridDim.x;
  const int head = static_cast<int>((reinterpret_cast<unsigned long long>(G) >> 2) & 3);
  const float* Ga = G - head;
  const long long total = head + m * d;
  // row i's first column sits at [i][sh[i & 3]] of a stage
  int sh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sh[q] = (head + q * static_cast<int>(d & 3)) & 3;

  // Score counts, bit-sliced: bit i of plane[k] is bit k of row i's count
  // over this thread's columns (a tile adds one bit per row).  A count is
  // at most a block's tile count, so the n_planes planes of its bit length
  // hold it (the launch keeps it below 2^COUNT_PLANES).
  Bits plane[COUNT_PLANES];
#pragma unroll
  for (int k = 0; k < COUNT_PLANES; ++k) plane[k] = 0;
  float l1_acc[REG_ACC && L1 ? M : 1], d2_acc[REG_ACC && D2 ? M : 1];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if constexpr (REG_ACC && L1) l1_acc[i] = 0.f;
    if constexpr (REG_ACC && D2) d2_acc[i] = 0.f;
  }
  if constexpr (!REG_ACC && (L1 || D2)) {
    for (int i = tid; i < 3 * WARPS * M; i += THREADS) (&red[0][0][0])[i] = 0.f;
  }

  // This thread's column of a tile, from its stage st, to registers.
  const auto load = [&](float (&g)[M], const float* st) {
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = i < m ? st[i * RING_LD + sh[i & 3]] : 0.f;
  };
  // One column g of a tile (st: its stage).  RAGGED: the last tile, whose
  // columns past d add exact zeros to every sum, neither vote nor write;
  // every other tile runs without a test.
  const auto column = [&](auto ragged, const float (&g)[M], const float* st, long long col) {
    constexpr bool RAGGED = decltype(ragged)::value;
    const bool valid = !RAGGED || col < d;
    float mean = 0.f;
    if constexpr (SCORES) {
      mean = column_mean<M>(g, m);
      // the rows at or above the mean (!(g >= mean) below it, not g <
      // mean: a NaN compares false both ways), then the majority side
      Bits above = 0;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < m && g[i] >= mean) above |= Bits(1) << i;
      Bits c = !valid ? Bits(0) : 2 * popc(above) >= m ? above : ~above;
      // add one to the counts of the rows in c
#pragma unroll
      for (int k = 0; k < COUNT_PLANES; ++k) {
        if (k == n_planes) break;
        const Bits carry = plane[k] & c;
        plane[k] ^= c;
        c = carry;
      }
    }
    if constexpr (L::TRIM) {
      const float v = trimmed_column<M>(g, m, trim_k);
      if (valid) col_out[col] = v;
    }
    if constexpr (L::MEDIAN) {
      const float med = middle_median<M, BUCKET>(g, m, dyn);
      if constexpr (COLS) {
        if (valid) {
          col_out[col] = med;
          if constexpr (SCORES) mean_out[col] = mean;
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) continue;
        // below SMEM_SORT_M the column is read again from its stage, so g
        // need not live through the sort (it spilled there at m = 20)
        float gi = g[i];
        if constexpr (REG_ACC) gi = lds_again(st + i * RING_LD + sh[i & 3]);
        const float df = __fsub_rn(gi, med);
        if constexpr (L1) {
          if constexpr (REG_ACC) {
            l1_acc[i] = __fadd_rn(l1_acc[i], valid ? fabsf(df) : 0.f);
          } else {
            const float vs = warp_sum(valid ? fabsf(df) : 0.f);
            if (lane == 0) red[1][warp][i] += vs;
          }
        }
        if constexpr (D2) {
          if constexpr (REG_ACC) {
            d2_acc[i] = __fadd_rn(d2_acc[i], valid ? __fmul_rn(df, df) : 0.f);
          } else {
            const float vs = warp_sum(valid ? __fmul_rn(df, df) : 0.f);
            if (lane == 0) red[2][warp][i] += vs;
          }
        }
      }
    }
  };

  // the ring: tiles b, b + grid, ... into stages 0, 1, ..., stages - 1.
  // EARLY: the variant reads nothing of a stage after copying its column
  // to registers, so the stage is refilled right then, behind a second
  // barrier: `stages` tiles stay in flight while a column sorts, not
  // stages - 1, and one stage is a ring.
  constexpr bool EARLY = L::TRIM;
  const int ahead = EARLY ? stages : stages - 1;  // tiles issued before tile t is read
  long long t_next = blockIdx.x;
  for (int s = 0; s < ahead; ++s, t_next += grid) {
    if (t_next < n_tiles) stage_tile<M>(ring + s * stage_floats, Ga, d, total, head, t_next, m);
    cp_async_commit();
  }
  int s_read = 0, s_write = EARLY ? 0 : stages - 1;
  for (long long t = blockIdx.x; t < n_tiles; t += grid) {
    cp_async_wait(ahead - 1);  // tile t has landed (this thread's copies)
    __syncthreads();           // every thread's copies; stage s_write read
    const float* st = ring + s_read * stage_floats + tid;
    float g[M];
    if constexpr (EARLY) {
      load(g, st);
      // the stage is refilled below: every thread's column read first (a
      // block-wide condition; a block's last tile skips the barrier)
      if (t_next < n_tiles) __syncthreads();
    }
    if (t_next < n_tiles)
      stage_tile<M>(ring + s_write * stage_floats, Ga, d, total, head, t_next, m);
    cp_async_commit();
    t_next += grid;
    if constexpr (!EARLY) load(g, st);
    s_write = s_write + 1 == stages ? 0 : s_write + 1;
    s_read = s_read + 1 == stages ? 0 : s_read + 1;
    const long long col = t * THREADS + tid;
    if (!L::TRIM && (t + 1) * THREADS <= d) {
      column(std::false_type{}, g, st, col);
    } else {  // the trimmed mean's only test is its store's: one copy of its code
      column(std::true_type{}, g, st, col);
    }
  }

  if constexpr (SCORES || L1 || D2) {
    if constexpr (SCORES) {
      // the warp's count of row c·32 + lane to count[c]: plane k's bits of
      // row i by ballot, weighted 2^k, the planes shifting down one a round
      int count[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) count[c] = 0;
#pragma unroll 1
      for (int k = 0; k < n_planes; ++k) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i < m) {
            const unsigned votes = __ballot_sync(0xffffffffu, (plane[0] >> i) & 1);
            if (lane == (i & 31)) count[i >> 5] += __popc(votes) << k;
          }
        }
#pragma unroll
        for (int j = 0; j + 1 < COUNT_PLANES; ++j) plane[j] = plane[j + 1];
      }
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (c * 32 + lane < m) red[0][warp][c * 32 + lane] = static_cast<float>(count[c]);
    }
    if constexpr (REG_ACC) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) continue;
        if constexpr (L1) {
          const float v = warp_sum(l1_acc[i]);
          if (lane == 0) red[1][warp][i] = v;
        }
        if constexpr (D2) {
          const float v = warp_sum(d2_acc[i]);
          if (lane == 0) red[2][warp][i] = v;
        }
      }
    }
    __syncthreads();
    const auto put = [&](int s, float* out) {  // the warps' sums in order
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[s][w][tid];
      out[static_cast<long long>(blockIdx.x) * m + tid] = v;
    };
    if (tid < m) {
      if constexpr (SCORES) put(0, scores_p);
      if constexpr (L1) put(1, l1_p);
      if constexpr (D2) put(2, d2_p);
    }
  }
}

// The select rules in one cooperative launch each: select_aggregate_kernel
// <M, RULE>.  Replaces, per rule, the JAX engine's local composition
// (src/repro/core/engine.py): a fused_stats_pallas call, the [m]-sized
// rule, then masked_mean_pallas (or, for brsgd, its fast path
// brsgd_partials_pallas -> ref.brsgd_thresholds -> select_mean_pallas):
//
//   RULE_BRSGD      B1's (scores, l1) call, the thresholds of
//                   ref.brsgd_thresholds, C1∩C2 (C2 fallback), then B2;
//   RULE_KRUM       B1's gram call; score_i = Σ of the n_close smallest
//                   d²_ij = (S_ii + S_jj) − 2 S_ij (no FMA, self +inf);
//                   krum: the argmin (the first NaN if a score is NaN, as
//                   torch.argmin), one-hot; multi_krum (k > 0): the k best
//                   by a stable rank, NaN last, ties by worker index;
//   RULE_GEOMEDIAN  B1's (gram, d2med) call; Weiszfeld in weight space
//                   from w = 1/max(√d2med, eps), n_updates updates
//                   (engine._geomedian_select), NaN propagating;
//
// then B3's combine with the rule's weights, all in one launch.
//
// What bounds it: bytes, G read once (m·d·4) plus out written (d·4); pass
// 2 reads the rows it sums again unless G stayed resident in shared
// memory.  At the paper's shape [20, 61706] (4.9 MB, in L2) the
// eager compositions were 18-200 launches of a few microseconds each;
// here they are one.
//
// Design:
//   * A cooperative persistent grid, every block co-resident (the wrapper
//     sizes it with the occupancy calculator); block b walks the tiles b,
//     b + grid, ... of THREADS columns, one thread a column.
//   * Pass 1.  brsgd: scores and l1 with the pad-free median network,
//     score counts by warp ballot into a counter that lane i keeps for row
//     i, and l1 sums in registers across all the thread's tiles, reduced
//     once per block at the end (at M = 64 the sort runs in shared memory
//     and per-tile warp sums stay).  Gram rules: the tile staged in shared
//     memory and GramAcc's register-blocked products (the same device code
//     as B1's gram call); geomedian also d² to the pad-free median, summed
//     like brsgd's l1.  With `resident` each block leaves its tiles in
//     dynamic shared memory, slot j holding its j-th tile (the gram rules
//     stage every tile there; without `resident` they reuse slot 0).
//   * Partials [PAIRS][grid] (brsgd: scores then l1; gram rules: the
//     packed upper triangle, then geomedian's d2med), block index fastest;
//     a grid barrier; global warp p sums pair p over the blocks in a fixed
//     order (lane l adds blocks l, l + 32, ... in turn, then the fixed
//     shuffle tree) into totals [PAIRS]; a second grid barrier.  Every
//     block reads the same totals; no float atomics, so every block, and
//     every run, resolves the same weights.
//   * The rule.  brsgd: in every block alike (the same code on the same
//     2m totals gives the same bits, so no third barrier); kth =
//     rank_select(scores, k_idx), 𝔗 = threshold when q_idx < 0, else
//     rank_select(l1, q_idx), C1 = l1 <= 2𝔗, C2 = score >= kth.  Gram
//     rules: block 0 alone reads the m(m+1)/2 totals, resolves the
//     weights and publishes them and Σw; a third grid barrier; every block
//     reads those.  krum: thread i sorts row i of d² with the pad-free
//     network (a NaN, which torch.sort puts last, as +inf, counted) and
//     sums its n_close smallest in ascending order, so duplicated workers
//     tie bit for bit.  geomedian: thread i owns row i of S·w; Σw and wᵀSw
//     in row order.
//   * Pass 2: combine_tiles over the rows of nonzero weight, and the rows
//     of weight 0 that hold NaN or ±inf, in ascending order with
//     __fmul_rn/__fadd_rn, then __fdiv_rn by Σw (row order, guarded to 1),
//     so the aggregate is bit-equal to ref.masked_mean_det(G, w), which
//     sums every row as the reference's w @ g does: a finite row of
//     weight 0 adds ±0 (the sum is never -0, so its bits stay), and a
//     non-finite one makes its columns NaN (0·NaN, 0·inf).  Pass 1 already
//     tells which rows those are, at no cost: a row's grid-wide statistic
//     (the gram diagonal S_ii = Σ g_i², brsgd's l1 = Σ |g_i - med|) is
//     NaN or ±inf when the row holds a non-finite value (an overflow, or
//     a NaN median, only adds rows, which keeps the bits).  It reads the resident tiles, else G, last
//     tile first (the tiles pass 1 read last are the ones still in L2),
//     with the loads of four rows of four tiles in flight.
//   * Block 0 writes the diagnostics to `small`.  brsgd: scores [M], l1
//     [M], w [M], kth, 𝔗 as floats, then sel [M], c1 [M], c2 [M] as
//     bytes.  Gram rules: w [M], scores [M] (krum) or d2med [M]
//     (geomedian), gram [M·M], then w > 0 as M bytes.
constexpr int SMEM_BLOCK_LIMIT = 232448;  // 227 KB: the most one block may hold
constexpr int AGG_STATIC_SMEM = 4096;     // kept for AggShared<M>
constexpr int AGG_MAX_DYNAMIC = SMEM_BLOCK_LIMIT - AGG_STATIC_SMEM;
constexpr int AGG_ROWS = 4;               // pass 2: rows loaded at once
constexpr int AGG_TILES = 4;              // pass 2: tiles of G in flight

constexpr int RULE_BRSGD = 0;
constexpr int RULE_KRUM = 1;              // krum and multi_krum (k > 0)
constexpr int RULE_GEOMEDIAN = 2;

template <int M>
struct AggShared {
  float red[2][WARPS][M];  // per-warp sums of the scores and l1 (d2med)
  float sc[M], l1[M];      // the grid-wide statistics (krum: scores)
  float cand[2][M];        // rank_select: x_i where it hits, else -inf
  float w[M];              // selection weights
  int rows[M];             // the rows pass 2 sums, ascending
  int in[M];               // row i is one of them
  float kth, T, den;        // den: Σw (gram rules)
};
static_assert(sizeof(AggShared<64>) <= AGG_STATIC_SMEM, "static shared memory");

// The weighted row combine over NT tiles of a block, from slot s0 down
// (slot s is the block's tile b + s·grid): Σ over the n rows sh.rows[0..n)
// (ascending: those of nonzero weight, and non-finite ones) of w_i g_i, in
// row order with __fmul_rn/__fadd_rn, then __fdiv_rn by den — bit-equal
// to ref.masked_mean_det on the same weights.  AGG_ROWS rows of every
// tile are loaded before they are added.  load(slot, row, col) reads one
// element of G.
template <int M, int NT, typename Load>
__device__ __forceinline__ void combine_tiles(const AggShared<M>& sh, int n_sel, float den,
                                              long long d, long long b, long long grid,
                                              int s0, int nt, float* __restrict__ out,
                                              Load load) {
  float a[NT];
  long long col[NT];
  bool on[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    a[u] = 0.f;
    col[u] = (b + (s0 - u) * grid) * THREADS + threadIdx.x;
    on[u] = u < nt && col[u] < d;
  }
  int q = 0;
  for (; q + AGG_ROWS <= n_sel; q += AGG_ROWS) {
    float v[NT][AGG_ROWS];
#pragma unroll
    for (int u = 0; u < NT; ++u) {
#pragma unroll
      for (int r = 0; r < AGG_ROWS; ++r)
        v[u][r] = on[u] ? load(s0 - u, sh.rows[q + r], col[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
#pragma unroll
      for (int r = 0; r < AGG_ROWS; ++r)
        a[u] = __fadd_rn(a[u], __fmul_rn(sh.w[sh.rows[q + r]], v[u][r]));
    }
  }
  for (; q < n_sel; ++q) {
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      if (on[u]) a[u] = __fadd_rn(a[u], __fmul_rn(sh.w[sh.rows[q]], load(s0 - u, sh.rows[q], col[u])));
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    if (on[u]) out[col[u]] = __fdiv_rn(a[u], den);
  }
}

// Shared-memory layout of select_aggregate_kernel<M, RULE, BUCKET>, in
// floats: the sort columns (a median at M >= SMEM_SORT_M), the rule's
// scratch, then the tile slots; the last three at m workers.
template <int M, int RULE>
struct AggLayout {
  static constexpr bool GRAM = RULE != RULE_BRSGD;
  static constexpr bool MEDIAN = RULE != RULE_KRUM;
  static constexpr int SORT = (MEDIAN && M >= SMEM_SORT_M) ? pow2_at_least(M) * THREADS : 0;
  static constexpr int LD = GRAM ? GRAM_LD : THREADS;
  static constexpr int STAGE = GRAM ? 1 : 0;  // slots without `resident`
  // krum: S and d², each [m][m+1]; geomedian: S, two weight buffers and
  // S·w (to 16 bytes)
  __host__ __device__ static constexpr int scratch(int m) {
    return RULE == RULE_KRUM        ? 2 * m * (m + 1)
           : RULE == RULE_GEOMEDIAN ? (m * (m + 1) + 3 * m + 3) / 4 * 4
                                    : 0;
  }
  __host__ __device__ static constexpr int slot(int m) { return (GRAM ? gram_rows(m) : m) * LD; }
  __host__ __device__ static constexpr int pairs(int m) {
    return GRAM ? gram_pairs(m) + (RULE == RULE_GEOMEDIAN ? m : 0) : 2 * m;
  }
};

// y sorts before x: ascending, NaN last (torch.sort's order)
__device__ __forceinline__ bool sorts_before(float y, float x) {
  return isnan(x) ? !isnan(y) : y < x;
}

// rank of x[j] in the stable ascending sort of x[0..n) with NaN last
template <int N>
__device__ __forceinline__ int stable_rank(const float* x, int j, int n) {
  const float xj = x[j];
  int r = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= n) continue;
    const float y = x[k];
    r += sorts_before(y, xj) || (k < j && !sorts_before(xj, y));
  }
  return r;
}

// max(x, lo) that keeps NaN, as torch.clamp and jnp.maximum
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The weights of a gram rule from the grid-wide totals (the packed gram,
// then geomedian's d2med), by one block: krum / multi_krum (ia = n_close,
// ib = k, 0 for krum) or geomedian (ia = n_updates, fa = eps).  Writes w,
// the scores or d2med, gram and w > 0 to `small`, and Σw (row order,
// guarded to 1) to *den_out.
template <int M, int RULE, bool BUCKET>
__device__ __forceinline__ void gram_rule_weights(const float* totals, float* scratch,
                                                  float* __restrict__ small,
                                                  float* __restrict__ den_out,
                                                  AggShared<M>& sh, int ia, int ib, float fa,
                                                  int m) {
  const int tid = threadIdx.x;
  const int SL = m + 1;  // row stride of the [m][m+1] scratch
  float* S = scratch;
  float* gram_out = small + 2 * m;
#pragma unroll
  for (int q = 0; q < (M * M + THREADS - 1) / THREADS; ++q) {
    const int e = tid + q * THREADS, i = e / m, j = e % m;
    if (e < m * m) {
      const float v = __ldcg(totals + gram_pair(i < j ? i : j, i < j ? j : i, m));
      S[i * SL + j] = v;
      gram_out[e] = v;
    }
  }
  if constexpr (RULE == RULE_KRUM) {
    const int n_close = ia, k = ib;  // k == 0: krum, else multi_krum
    float* D2 = S + m * SL;
    __syncthreads();
    for (int e = tid; e < m * m; e += THREADS) {
      const int i = e / m, j = e % m;
      const float v = __fsub_rn(__fadd_rn(S[i * SL + i], S[j * SL + j]),
                                __fmul_rn(2.f, S[i * SL + j]));
      D2[i * SL + j] = __fadd_rn(v, i == j ? INFINITY : 0.f);
    }
    __syncthreads();
    // thread i sorts row i ascending and sums its n_close smallest in that
    // order.  A NaN sorts last (torch.sort): it becomes +inf for the
    // network, and a score that would reach one of the q NaNs is NaN.  A
    // bucket instance pads the row with +inf to its power of two M (the
    // n_close <= m smallest never reach a pad).
    if (tid < m) {
      float* row = D2 + tid * SL;
      int q = 0;
      float s;
      if constexpr (M < SMEM_SORT_M || BUCKET) {
        float g[M], v[pow2_at_least(M)];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const float x = j < m ? row[j] : INFINITY;
          q += isnan(x);
          g[j] = isnan(x) ? INFINITY : x;
        }
        sort_real<M>(g, [&v](int k) -> float& { return v[k]; });
        s = v[0];
#pragma unroll
        for (int r = 1; r < M; ++r)
          if (r < n_close) s = __fadd_rn(s, v[r]);
      } else {  // M = 64 = a power of two: the row sorts in place
        for (int j = 0; j < M; ++j) {
          q += isnan(row[j]);
          if (isnan(row[j])) row[j] = INFINITY;
        }
        bitonic_sort<M>([row](int k) -> float& { return row[k]; });
        s = row[0];
        for (int r = 1; r < n_close; ++r) s = __fadd_rn(s, row[r]);
      }
      sh.sc[tid] = n_close > m - q ? NAN : s;
    }
    __syncthreads();
    // multi_krum: rank < k.  krum: torch.argmin, the first NaN if a score
    // is NaN, else the first minimum (stable rank 0)
    const bool nan_i = tid < m && isnan(sh.sc[tid]);
    const bool any_nan = __syncthreads_or(nan_i);
    if (tid < m) {
      bool on;
      if (k > 0) {
        on = stable_rank<M>(sh.sc, tid, m) < k;
      } else if (any_nan) {
        on = nan_i;
#pragma unroll
        for (int j = 0; j < M; ++j) on = on && !(j < tid && isnan(sh.sc[j]));
      } else {
        on = stable_rank<M>(sh.sc, tid, m) == 0;
      }
      sh.w[tid] = on ? 1.f : 0.f;
      small[m + tid] = sh.sc[tid];
    }
  } else {
    const int n_updates = ia;
    const float eps = fa;
    float* wa = S + m * SL;
    float* wb = wa + m;
    float* Sw = wb + m;
    if (tid < m) {
      const float dm = __ldcg(totals + gram_pairs(m) + tid);
      wa[tid] = __fdiv_rn(1.f, clamp_min(sqrtf(dm), eps));
      small[m + tid] = dm;
    }
    __syncthreads();
    for (int it = 0; it < n_updates; ++it) {
      if (tid < m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (j < m) s = fmaf(S[tid * SL + j], wa[j], s);
        Sw[tid] = s;
      }
      __syncthreads();
      if (tid < m) {
        float W = 0.f, wSw = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (j < m) {
            W = __fadd_rn(W, wa[j]);
            wSw = fmaf(wa[j], Sw[j], wSw);
          }
        }
        // diag - 2·Sw/W + wᵀSw/W², in the plain version's order
        const float d2 = __fadd_rn(
            __fsub_rn(S[tid * SL + tid], __fdiv_rn(__fmul_rn(2.f, Sw[tid]), W)),
            __fdiv_rn(wSw, __fmul_rn(W, W)));
        wb[tid] = __fdiv_rn(1.f, clamp_min(sqrtf(clamp_min(d2, 0.f)), eps));
      }
      __syncthreads();
      float* t = wa;
      wa = wb;
      wb = t;
    }
    if (tid < m) sh.w[tid] = wa[tid];
  }
  __syncthreads();
  if (tid < m) {
    small[tid] = sh.w[tid];
    reinterpret_cast<unsigned char*>(small + 2 * m + m * m)[tid] = sh.w[tid] > 0.f;
  }
  if (tid == 0) {  // Σw in row order, guarded to 1
    float sw = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m) sw = __fadd_rn(sw, sh.w[i]);
    *den_out = sw > 0.f ? sw : 1.f;
  }
}

template <int M, int RULE, bool BUCKET>
__global__ void __launch_bounds__(THREADS)
select_aggregate_kernel(const float* __restrict__ G, long long d, int ia, int ib, float fa,
                        int resident, float* partials, float* __restrict__ small,
                        float* __restrict__ out, int m_arg) {
  using L = AggLayout<M, RULE>;
  constexpr bool REG_ACC = M < SMEM_SORT_M;  // M <= 32: per-row sums in registers
  const int m = BUCKET ? m_arg : M;
  const int PAIRS = L::pairs(m), SLOT = L::slot(m);
  __shared__ AggShared<M> sh;
  extern __shared__ __align__(16) float dyn[];
  float* sort_scratch = dyn;
  float* scratch = dyn + L::SORT;
  float* tiles = scratch + L::scratch(m);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long n_tiles = (d + THREADS - 1) / THREADS;
  cg::grid_group all = cg::this_grid();
  int n_slots = 0;

  // ---- pass 1
  if constexpr (RULE == RULE_BRSGD) {
    // scores and l1 of this block's tiles
    int count = 0;                    // score of row `lane` (REG_ACC)
    float l1_acc[REG_ACC ? M : 1];
    if constexpr (REG_ACC) {
#pragma unroll
      for (int i = 0; i < M; ++i) l1_acc[i] = 0.f;
    } else {
      for (int i = tid; i < 2 * WARPS * M; i += THREADS) (&sh.red[0][0][0])[i] = 0.f;
      __syncthreads();
    }
    for (long long t = b; t < n_tiles; t += grid, ++n_slots) {
      const long long col = t * THREADS + tid;
      const bool valid = col < d;
      float g[M];
#pragma unroll
      for (int i = 0; i < M; ++i) g[i] = valid && i < m ? __ldg(G + i * d + col) : 0.f;
      if (resident) {
        float* s = tiles + n_slots * SLOT + tid;
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (i < m) s[i * THREADS] = g[i];
      }
      const float mean = column_mean<M>(g, m);
      int n_above = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) n_above += i < m && g[i] >= mean;
      const bool maj_above = 2 * n_above >= m;
      float med;
      if constexpr (REG_ACC) {
        med = padfree_median<M>(g, m);
      } else {
        med = column_median<M>(g, m, sort_scratch);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) continue;
        // !(g >= mean), not g < mean: a NaN compares false both ways
        const bool on = valid && (maj_above ? (g[i] >= mean) : !(g[i] >= mean));
        const float dev = valid ? fabsf(__fsub_rn(g[i], med)) : 0.f;
        if constexpr (REG_ACC) {
          const unsigned votes = __ballot_sync(0xffffffffu, on);
          if (lane == i) count += __popc(votes);
          l1_acc[i] = __fadd_rn(l1_acc[i], dev);
        } else {
          const float vs = warp_sum(on ? 1.f : 0.f);
          const float vl = warp_sum(dev);
          if (lane == 0) {
            sh.red[0][warp][i] += vs;
            sh.red[1][warp][i] += vl;
          }
        }
      }
    }
    if constexpr (REG_ACC) {
      if (lane < m) sh.red[0][warp][lane] = static_cast<float>(count);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) continue;
        const float vl = warp_sum(l1_acc[i]);
        if (lane == 0) sh.red[1][warp][i] = vl;
      }
    }
    __syncthreads();
    if (tid < PAIRS) {  // pair tid = (statistic tid / m, row tid % m)
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += sh.red[tid / m][w][tid % m];
      partials[tid * grid + b] = v;
    }
  } else {
    // gram (and geomedian's d² to the median) of this block's tiles
    constexpr bool GEO = RULE == RULE_GEOMEDIAN;
    GramAcc<M> gram;
    gram.init(m);
    float d2_acc[GEO && REG_ACC ? M : 1];
    if constexpr (GEO && REG_ACC) {
#pragma unroll
      for (int i = 0; i < M; ++i) d2_acc[i] = 0.f;
    }
    if constexpr (GEO && !REG_ACC) {
      for (int i = tid; i < WARPS * M; i += THREADS) (&sh.red[0][0][0])[i] = 0.f;
    }
    const int my_tiles = b < n_tiles ? static_cast<int>((n_tiles - 1 - b) / grid) + 1 : 0;
    zero_pad_rows(tiles, resident ? my_tiles : 1, SLOT, m);
    __syncthreads();
    for (long long t = b; t < n_tiles; t += grid, ++n_slots) {
      const long long col = t * THREADS + tid;
      const bool valid = col < d;
      float g[M];
#pragma unroll
      for (int i = 0; i < M; ++i) g[i] = valid && i < m ? __ldg(G + i * d + col) : 0.f;
      float* slot = tiles + (resident ? n_slots : 0) * SLOT;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < m) slot[i * GRAM_LD + tid] = g[i];
      if constexpr (GEO) {
        float med;
        if constexpr (REG_ACC) {
          med = padfree_median<M>(g, m);
        } else {
          med = column_median<M>(g, m, sort_scratch);
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i >= m) continue;
          const float df = __fsub_rn(g[i], med);
          const float v = valid ? __fmul_rn(df, df) : 0.f;
          if constexpr (REG_ACC) {
            d2_acc[i] = __fadd_rn(d2_acc[i], v);
          } else {
            const float vs = warp_sum(v);
            if (lane == 0) sh.red[0][warp][i] += vs;
          }
        }
      }
      __syncthreads();
      gram.add_tile(slot);
      __syncthreads();
    }
    if constexpr (GEO && REG_ACC) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) continue;
        const float v = warp_sum(d2_acc[i]);
        if (lane == 0) sh.red[0][warp][i] = v;
      }
    }
    gram.finish(m, [&](int i, int j, float v) { partials[gram_pair(i, j, m) * grid + b] = v; });
    if constexpr (GEO) {
      __syncthreads();
      if (tid < m) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += sh.red[0][w][tid];
        partials[(gram_pairs(m) + tid) * grid + b] = v;
      }
    }
  }
  all.sync();

  // ---- the grid-wide totals: global warp p sums pair p over the blocks.
  // __ldcg: other SMs wrote these during this launch (never read them
  // through the read-only path).
  float* totals = partials + PAIRS * grid;
  if constexpr (RULE == RULE_BRSGD) {
    if (warp == 0) {
      for (long long p = b; p < PAIRS; p += grid) {
        if (p < m) {
          // a score: every block's partial is a whole count below 2^24
          // (brsgd_stats.py:aggregate_plan), so a double sum is the exact
          // count past 2^24 columns too, rounded to float once
          double v = 0.0;
          for (long long j = lane; j < grid; j += 32) v += __ldcg(partials + p * grid + j);
          v = warp_sum(v);
          if (lane == 0) totals[p] = __double2float_rn(v);
          continue;
        }
        float v = 0.f;
        for (long long j = lane; j < grid; j += 32) v += __ldcg(partials + p * grid + j);
        v = warp_sum(v);
        if (lane == 0) totals[p] = v;
      }
    }
  } else {  // m(m+1)/2 pairs: every warp of the grid takes some
    for (long long p = b * WARPS + warp; p < PAIRS; p += grid * WARPS) {
      float v = 0.f;
#pragma unroll 8  // the loads go out together; the adds keep their order
      for (long long j = lane; j < grid; j += 32) v += __ldcg(partials + p * grid + j);
      v = warp_sum(v);
      if (lane == 0) totals[p] = v;
    }
  }
  all.sync();

  // ---- the rule: the weights sh.w, the rows of nonzero weight sh.rows,
  // their count and Σw
  int n_sel;
  float den;
  if constexpr (RULE == RULE_BRSGD) {
    const int k_idx = ia, q_idx = ib;
    const float threshold = fa;
    if (tid < PAIRS) (tid < m ? sh.sc : sh.l1)[tid % m] = __ldcg(totals + tid);
    __syncthreads();
    if (tid < PAIRS) {  // ranks: threads [0, m) the scores, [m, 2m) l1
      const int s = tid / m, i = tid % m;
      const float* x = s ? sh.l1 : sh.sc;
      const int k = s ? q_idx : k_idx;
      const float xi = x[i];
      int lt = 0, le = 0;
      for (int j = 0; j < m; ++j) {
        lt += x[j] < xi;
        le += x[j] <= xi;
      }
      sh.cand[s][i] = (lt <= k && k < le) ? xi : -INFINITY;
    }
    __syncthreads();
    if (tid == 0) {
      float kth = -INFINITY, quart = -INFINITY;
      for (int i = 0; i < m; ++i) {
        if (sh.cand[0][i] > kth) kth = sh.cand[0][i];
        if (sh.cand[1][i] > quart) quart = sh.cand[1][i];
      }
      sh.kth = kth;
      sh.T = q_idx < 0 ? threshold : quart;
    }
    __syncthreads();
    const float kth = sh.kth, T2 = __fmul_rn(2.f, sh.T);
    const bool c1 = tid < m && sh.l1[tid] <= T2;
    const bool c2 = tid < m && sh.sc[tid] >= kth;
    const bool any = __syncthreads_or(c1 && c2);
    const bool sel = any ? (c1 && c2) : c2;
    if (tid < m) sh.w[tid] = sel ? 1.f : 0.f;
    if (b == 0) {
      if (tid < m) {
        unsigned char* masks = reinterpret_cast<unsigned char*>(small + 3 * m + 2);
        small[tid] = sh.sc[tid];
        small[m + tid] = sh.l1[tid];
        small[2 * m + tid] = sel ? 1.f : 0.f;
        masks[tid] = sel;
        masks[m + tid] = c1;
        masks[2 * m + tid] = c2;
      }
      if (tid == 0) {
        small[3 * m] = sh.kth;
        small[3 * m + 1] = sh.T;
      }
    }
    // Σw of 0/1 weights is the count, exact in float; pass 2 also sums
    // the rows whose l1 is not finite (weight 0: 0·NaN, 0·inf)
    const bool in = sel || (tid < m && !isfinite(sh.l1[tid]));
    if (tid < m) sh.in[tid] = in;
    const int n_w = __syncthreads_count(sel);
    den = n_w > 0 ? static_cast<float>(n_w) : 1.f;
    n_sel = __syncthreads_count(in);
    if (in) {  // this row's place among the summed ones
      int pos = 0;
      for (int j = 0; j < tid; ++j) pos += sh.in[j];
      sh.rows[pos] = tid;
    }
  } else {
    // block 0 resolves the weights and publishes them (w in `small`, Σw
    // after the totals); a third barrier; every block reads them (every
    // block resolving the rule from the m(m+1)/2 totals itself measured
    // slower)
    float* den_out = totals + PAIRS;
    if (b == 0)
      gram_rule_weights<M, RULE, BUCKET>(totals, scratch, small, den_out, sh, ia, ib, fa, m);
    all.sync();
    // pass 2 sums the rows of nonzero weight and those whose gram
    // diagonal is not finite (weight 0: 0·NaN, 0·inf); both loads in
    // flight together
    bool in = false;
    if (tid < m) {
      const float wt = __ldcg(small + tid);
      const float sii = __ldcg(totals + gram_pair(tid, tid, m));
      in = wt != 0.f || !isfinite(sii);
      sh.w[tid] = wt;
      sh.in[tid] = in;
    }
    if (tid == 0) sh.den = __ldcg(den_out);
    n_sel = __syncthreads_count(in);
    den = sh.den;
    if (in) {  // this row's place among the summed ones
      int pos = 0;
      for (int j = 0; j < tid; ++j) pos += sh.in[j];
      sh.rows[pos] = tid;
    }
  }
  __syncthreads();

  // ---- pass 2: the weighted row combine, last tile first
  if (resident) {
    const auto from_smem = [&](int slot, int i, long long) {
      return tiles[slot * SLOT + i * L::LD + tid];
    };
    for (int s = n_slots - 1; s >= 0; --s)
      combine_tiles<M, 1>(sh, n_sel, den, d, b, grid, s, 1, out, from_smem);
  } else {
    const auto from_g = [&](int, int i, long long c) { return __ldg(G + i * d + c); };
    for (int s = n_slots - 1; s >= 0; s -= AGG_TILES)
      combine_tiles<M, AGG_TILES>(sh, n_sel, den, d, b, grid, s,
                                  s + 1 < AGG_TILES ? s + 1 : AGG_TILES, out, from_g);
  }
}

template <int M, bool BUCKET>
int launch_gram_stats(const float* G, int m, long long d, int needs, float* sc, float* l1,
                      float* d2, float* gram, int n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (gram_rows(m) * GRAM_LD +
                                       (M >= SMEM_SORT_M ? pow2_at_least(M) * THREADS : 0));
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (M = 64)
    cudaFuncSetAttribute(fused_stats_kernel<M, BUCKET>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  fused_stats_kernel<M, BUCKET><<<n_blocks, THREADS, smem, stream>>>(G, d, needs, sc, l1, d2,
                                                                     gram, m);
  return static_cast<int>(cudaGetLastError());
}

// The opt-in to AGG_MAX_DYNAMIC bytes of dynamic shared memory and the
// largest shared-memory carveout of one kernel, once per device.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AGG_MAX_DYNAMIC);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// *count = the blocks of `kernel` the current card holds at once, each
// with `smem` bytes of dynamic shared memory (`prepared`: its opt-in)
template <typename Kernel>
int coresident_blocks(Kernel kernel, cudaError_t prepared, long long smem, int* count) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = prepared;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *count = e == cudaSuccess ? per_sm * sms : 0;
  return static_cast<int>(e);
}

template <int M, int VARIANT, bool BUCKET>
cudaError_t column_prepare() {
  static bool done[64] = {};
  return prepare_smem(column_stats_kernel<M, VARIANT, BUCKET>, done);
}

// dynamic shared memory of column_stats_kernel<M, VARIANT, BUCKET> at m
// workers with `stages`
template <int M, int VARIANT>
size_t column_smem(int m, int stages) {
  using L = ColumnLayout<M, VARIANT>;
  return sizeof(float) * (L::SORT + static_cast<size_t>(stages) * m * RING_LD);
}

template <int M, int VARIANT, bool BUCKET>
int launch_column(const float* G, int m, long long d, int stages, int trim_k, float* sc,
                  float* l1, float* d2, float* col, float* mean, int grid,
                  cudaStream_t stream) {
  const long long n_tiles = (d + THREADS - 1) / THREADS;
  const long long per_block = (n_tiles + grid - 1) / grid;  // a block's score counts
  // the trimmed mean refills a stage as soon as it is read: one may do
  const int least_stages = (VARIANT & TRIM_OUT) ? 1 : 2;
  if (grid < 1 || stages < least_stages || stages > MAX_STAGES ||
      per_block >= (1ll << COUNT_PLANES))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((VARIANT & TRIM_OUT) && (trim_k < 0 || 2 * trim_k >= m))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_planes = 0;
  while ((1ll << n_planes) <= per_block) ++n_planes;
  const size_t smem = column_smem<M, VARIANT>(m, stages);
  if (smem > AGG_MAX_DYNAMIC) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = column_prepare<M, VARIANT, BUCKET>();
  if (e != cudaSuccess) return static_cast<int>(e);
  column_stats_kernel<M, VARIANT, BUCKET><<<grid, THREADS, smem, stream>>>(
      G, d, stages, n_planes, trim_k, sc, l1, d2, col, mean, m);
  return static_cast<int>(cudaGetLastError());
}

// the column-pass variant a C entry names, to its instance: B1's seven
// non-gram needs, B4, the median alone, the trimmed mean
#define COLUMN_DISPATCH(variant, CALL)                                          \
  switch (variant) {                                                            \
    case 1: { constexpr int V = 1; return CALL; }                               \
    case 2: { constexpr int V = 2; return CALL; }                               \
    case 3: { constexpr int V = 3; return CALL; }                               \
    case 4: { constexpr int V = 4; return CALL; }                               \
    case 5: { constexpr int V = 5; return CALL; }                               \
    case 6: { constexpr int V = 6; return CALL; }                               \
    case 7: { constexpr int V = 7; return CALL; }                               \
    case COLUMN_OUT | NEED_SCORES | NEED_L1: {                                  \
      constexpr int V = COLUMN_OUT | NEED_SCORES | NEED_L1; return CALL; }      \
    case COLUMN_OUT: { constexpr int V = COLUMN_OUT; return CALL; }             \
    case TRIM_OUT: { constexpr int V = TRIM_OUT; return CALL; }                 \
    default: return static_cast<int>(cudaErrorInvalidValue);                    \
  }

template <int M, bool BUCKET>
int launch_stats(const float* G, int m, long long d, int needs, float* sc, float* l1, float* d2,
                 float* gram, int grid, int stages, cudaStream_t stream) {
  if (needs & NEED_GRAM)
    return launch_gram_stats<M, BUCKET>(G, m, d, needs, sc, l1, d2, gram, grid, stream);
  if (needs < 1 || needs > (NEED_SCORES | NEED_L1 | NEED_D2MED))
    return static_cast<int>(cudaErrorInvalidValue);
  COLUMN_DISPATCH(needs, (launch_column<M, V, BUCKET>(G, m, d, stages, 0, sc, l1, d2, nullptr,
                                                      nullptr, grid, stream)))
}

template <int M, bool BUCKET>
int column_coresident(int variant, long long smem, int* count) {
  COLUMN_DISPATCH(variant, (coresident_blocks(column_stats_kernel<M, V, BUCKET>,
                                              column_prepare<M, V, BUCKET>(), smem, count)))
}

template <int M, bool BUCKET>
int launch_select_mean(const float* G, int m, long long d, const float* sl, const float* pr,
                       float* out, float* w_out, int n_blocks, cudaStream_t stream) {
  select_mean_kernel<M, BUCKET><<<n_blocks, THREADS, 0, stream>>>(G, d, sl, pr, out, w_out, m);
  return static_cast<int>(cudaGetLastError());
}

template <int M, bool BUCKET>
int launch_masked_mean(const float* G, int m, long long d, const float* w, float* out,
                       float* small, int n_blocks, cudaStream_t stream) {
  masked_mean_kernel<M, BUCKET><<<n_blocks, THREADS, 0, stream>>>(G, d, w, out, small, m);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of select_aggregate_kernel<M, RULE, BUCKET> at m
// workers on `grid` blocks: the sort columns and the rule's scratch, then
// one slot per tile of the block with the most tiles when `resident`, else
// STAGE slots.
template <int M, int RULE>
size_t aggregate_smem(int m, long long d, int grid, int resident) {
  using L = AggLayout<M, RULE>;
  const long long n_tiles = (d + THREADS - 1) / THREADS;
  const long long slots = resident ? (n_tiles + grid - 1) / grid : L::STAGE;
  return sizeof(float) * (L::SORT + L::scratch(m) + slots * L::slot(m));
}

// The opt-in above 48 KB and the largest shared-memory carveout, once per
// device.
template <int M, int RULE, bool BUCKET>
cudaError_t aggregate_prepare() {
  static bool done[64] = {};
  return prepare_smem(select_aggregate_kernel<M, RULE, BUCKET>, done);
}

template <int M, int RULE, bool BUCKET>
int aggregate_coresident(long long smem, int* count) {
  return coresident_blocks(select_aggregate_kernel<M, RULE, BUCKET>,
                           aggregate_prepare<M, RULE, BUCKET>(), smem, count);
}

template <int M, int RULE, bool BUCKET>
int launch_aggregate(const float* G, int m, long long d, int ia, int ib, float fa, int resident,
                     float* partials, float* small, float* out, int grid,
                     cudaStream_t stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = aggregate_smem<M, RULE>(m, d, grid, resident);
  if (smem > AGG_MAX_DYNAMIC) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = aggregate_prepare<M, RULE, BUCKET>();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&G, &d, &ia, &ib, &fa, &resident, &partials, &small, &out, &m};
  // a grid that is not co-resident is refused (cudaErrorCooperativeLaunchTooLarge)
  e = cudaLaunchCooperativeKernel(select_aggregate_kernel<M, RULE, BUCKET>, dim3(grid),
                                  dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the rule a C entry names, to its instance
#define RULE_DISPATCH(rule, CALL)                                            \
  switch (rule) {                                                            \
    case RULE_BRSGD: { constexpr int R = RULE_BRSGD; return CALL; }          \
    case RULE_KRUM: { constexpr int R = RULE_KRUM; return CALL; }            \
    case RULE_GEOMEDIAN: { constexpr int R = RULE_GEOMEDIAN; return CALL; }  \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }

template <int M, bool BUCKET>
int launch_select(int rule, const float* G, int m, long long d, int ia, int ib, float fa,
                  int resident, float* partials, float* small, float* out, int grid,
                  cudaStream_t stream) {
  RULE_DISPATCH(rule, (launch_aggregate<M, R, BUCKET>(G, m, d, ia, ib, fa, resident, partials,
                                                      small, out, grid, stream)))
}

template <int M, bool BUCKET>
int select_coresident(int rule, long long smem, int* count) {
  RULE_DISPATCH(rule, (aggregate_coresident<M, R, BUCKET>(smem, count)))
}

}  // namespace

// BRSGD_DISPATCH(m, CALL), defined by the source that includes this
// header, maps m to its instance: CALL sees the constants M and BUCKET,
// and returns cudaErrorInvalidValue for an m it has no instance for.

extern "C" {

int brsgd_threads() { return THREADS; }

int brsgd_max_blocks() { return MAX_BLOCKS; }

const char* brsgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B1: partials [grid, m] (gram [grid, m, m]) of the requested statistics
// (null pointer = not requested): with gram the gram kernel, else the
// column pass with `stages` ring stages (stages unused with gram)
int brsgd_fused_stats(const void* G, int m, long long d, int needs, void* scores_p,
                      void* l1_p, void* d2_p, void* gram_p, int grid, int stages,
                      void* stream) {
  BRSGD_DISPATCH(m, (launch_stats<M, BUCKET>(
      static_cast<const float*>(G), m, d, needs, static_cast<float*>(scores_p),
      static_cast<float*>(l1_p), static_cast<float*>(d2_p), static_cast<float*>(gram_p),
      grid, stages, static_cast<cudaStream_t>(stream))))
}

// B4: median [d], mean [d], scores and l1 partials [grid, m]
int brsgd_column_stats(const void* G, int m, long long d, void* med, void* mean,
                       void* scores_p, void* l1_p, int grid, int stages, void* stream) {
  BRSGD_DISPATCH(m, (launch_column<M, COLUMN_OUT | NEED_SCORES | NEED_L1, BUCKET>(
      static_cast<const float*>(G), m, d, stages, 0, static_cast<float*>(scores_p),
      static_cast<float*>(l1_p), nullptr, static_cast<float*>(med),
      static_cast<float*>(mean), grid, static_cast<cudaStream_t>(stream))))
}

// the coordinate-wise median [d] alone
int brsgd_cwise_median(const void* G, int m, long long d, void* med, int grid, int stages,
                       void* stream) {
  BRSGD_DISPATCH(m, (launch_column<M, COLUMN_OUT, BUCKET>(
      static_cast<const float*>(G), m, d, stages, 0, nullptr, nullptr, nullptr,
      static_cast<float*>(med), nullptr, grid, static_cast<cudaStream_t>(stream))))
}

// B5: the trimmed mean [d] alone, k rows dropped from each side of every
// column (0 <= 2k < m)
int brsgd_trimmed_mean(const void* G, int m, long long d, int k, void* out, int grid,
                       int stages, void* stream) {
  BRSGD_DISPATCH(m, (launch_column<M, TRIM_OUT, BUCKET>(
      static_cast<const float*>(G), m, d, stages, k, nullptr, nullptr, nullptr,
      static_cast<float*>(out), nullptr, grid, static_cast<cudaStream_t>(stream))))
}

// *count = the blocks of a column-pass instance (variant: B1's needs
// without gram, 16 | 3 for B4, 16 for the median, 32 for the trimmed
// mean) the current card holds at once with `smem` bytes of dynamic
// shared memory each
int brsgd_column_coresident(int m, int variant, long long smem, void* count) {
  BRSGD_DISPATCH(m, (column_coresident<M, BUCKET>(variant, smem, static_cast<int*>(count))))
}

// B2: selection from sl [2, m] and pr [2], then the masked mean
int brsgd_select_mean(const void* G, int m, long long d, const void* sl, const void* pr,
                      void* out, void* w_out, int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, (launch_select_mean<M, BUCKET>(
      static_cast<const float*>(G), m, d, static_cast<const float*>(sl),
      static_cast<const float*>(pr), static_cast<float*>(out),
      static_cast<float*>(w_out), n_blocks, static_cast<cudaStream_t>(stream))))
}

// B3: weighted mean with weights w [m] (null: unit weights, the mean);
// small_out (nullable): w [m] floats then w > 0 as m bytes
int brsgd_masked_mean(const void* G, int m, long long d, const void* w, void* out,
                      void* small_out, int n_blocks, void* stream) {
  BRSGD_DISPATCH(m, (launch_masked_mean<M, BUCKET>(
      static_cast<const float*>(G), m, d, static_cast<const float*>(w),
      static_cast<float*>(out), static_cast<float*>(small_out), n_blocks,
      static_cast<cudaStream_t>(stream))))
}

// A select rule's whole aggregation in one cooperative launch of `grid`
// blocks (rule: 0 brsgd, 1 krum / multi_krum, 2 geomedian).  (ia, ib,
// fa): brsgd (k_idx, q_idx, threshold), the rank_select indices of kth
// and of the auto 𝔗 (q_idx < 0 takes `threshold`); krum (n_close, k: 0
// for krum, the count for multi_krum); geomedian (n_updates, -, eps).
// partials: PAIRS·(grid + 1) floats, + 1 for the gram rules, with PAIRS
// = 2m for brsgd, else m(m+1)/2 (+ m for geomedian); small_out: the
// rule's diagnostics (brsgd: 3m + 2 floats then 3m bytes); out [d].
int brsgd_select_aggregate(const void* G, int m, long long d, int rule, int ia, int ib,
                           float fa, int resident, void* partials, void* small_out,
                           void* out, int grid, void* stream) {
  BRSGD_DISPATCH(m, (launch_select<M, BUCKET>(
      rule, static_cast<const float*>(G), m, d, ia, ib, fa, resident,
      static_cast<float*>(partials), static_cast<float*>(small_out),
      static_cast<float*>(out), grid, static_cast<cudaStream_t>(stream))))
}

// *count = the blocks of the rule's instance the current card holds at once
int brsgd_select_aggregate_coresident(int m, int rule, long long smem, void* count) {
  BRSGD_DISPATCH(m, (select_coresident<M, BUCKET>(rule, smem, static_cast<int*>(count))))
}

}  // extern "C"
