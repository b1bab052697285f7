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
//   brsgd_aggregate_kernel<M>     <- brsgd_partials_pallas -> ref.brsgd_thresholds
//                                    -> select_mean_pallas (the JAX engine's
//                                    brsgd fast path) in ONE cooperative
//                                    launch: pass 1, the partials summed
//                                    between two grid barriers, the
//                                    thresholds resolved in every block, pass 2.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

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

// Stage S (block size K, distance J) of the pad-tracked network, then the
// rest; template recursion keeps every pad test a compile-time constant.
template <int MP, int M, int K, int J, int S, typename At>
__device__ __forceinline__ void padfree_stages(At at) {
  constexpr unsigned long long pad = pad_slots<MP, M>().before[S];
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int l = i ^ J;
    if (l > i) {
      const bool pi = (pad >> i) & 1, pl = (pad >> l) & 1;
      const bool asc = (i & K) == 0;
      if (!pi && !pl) {
        const float lo = fminf(at(i), at(l));
        const float hi = fmaxf(at(i), at(l));
        at(i) = asc ? lo : hi;
        at(l) = asc ? hi : lo;
      } else if (pl && !pi && !asc) {
        at(l) = at(i);
      } else if (pi && !pl && asc) {
        at(i) = at(l);
      }
    }
  }
  if constexpr (J > 1) {
    padfree_stages<MP, M, K, J / 2, S + 1>(at);
  } else if constexpr (K < MP) {
    padfree_stages<MP, M, 2 * K, K, S + 1>(at);
  }
}

template <int M>
__device__ __forceinline__ float padfree_median(const float (&g)[M]) {
  constexpr int MP = pow2_at_least(M);
  float s[MP];
  bool any_nan = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = g[i];
    any_nan |= isnan(g[i]);
  }
  padfree_stages<MP, M, 2, 1, 0>([&s](int i) -> float& { return s[i]; });
  if (any_nan) return NAN;
  if (M % 2) return s[M / 2];
  return __fmul_rn(0.5f, __fadd_rn(s[M / 2 - 1], s[M / 2]));
}

// B1 (its brsgd call) and B2 in one cooperative launch.  Replaces the JAX
// engine's brsgd fast path (src/repro/core/engine.py:612-620):
// brsgd_partials_pallas, ref.brsgd_thresholds, select_mean_pallas.
//
// What bounds it: bytes, G read once (m·d·4) plus out written (d·4); pass
// 2 reads the selected rows again unless G stayed resident in shared
// memory.  At the paper's shape [20, 61706] (4.9 MB, in L2) the two
// kernels, their partial sums and the threshold ops between them were ~40
// launches of a few microseconds each; here they are one.
//
// Design:
//   * A cooperative persistent grid, every block co-resident (the wrapper
//     sizes it with the occupancy calculator); block b walks the tiles b,
//     b + grid, ... of THREADS columns, one thread a column.
//   * Pass 1 is fused_stats_kernel's (scores, l1) call with fewer
//     instructions and registers per column: the pad-free median network
//     above, score counts by warp ballot into a counter that lane i keeps
//     for row i, and l1 sums in registers across all the thread's tiles,
//     reduced once per block at the end (at M = 64 the sort runs in shared
//     memory and the per-tile warp sums of fused_stats_kernel stay).  With
//     `resident` each block also leaves its tiles in dynamic shared
//     memory, slot j holding its j-th tile.
//   * Partials [2][M][grid] (scores, then l1, block index fastest), a grid
//     barrier, block p < 2M sums pair p over the blocks in a fixed order
//     (lane l adds blocks l, l + 32, ... in turn, then the fixed shuffle
//     tree) into totals [2M], a second grid barrier.  Every block reads
//     the same totals; no float atomics, so l1 (which decides C1) is the
//     same on every run.  (Each block summing all partials itself, with
//     one barrier, read 2M x grid floats per block and was slower.)
//   * Every block resolves the thresholds of ref.brsgd_thresholds itself:
//     kth = rank_select(scores, k_idx); 𝔗 = threshold when q_idx < 0,
//     else rank_select(l1, q_idx); both indices come from the host.
//     rank_select's counting rule: x_i hits iff #{x_j < x_i} <= k <
//     #{x_j <= x_i}, the result is the max over the hits, -inf without one
//     (a NaN never hits).  C1 = l1 <= 2𝔗, C2 = score >= kth, sel = C1∩C2,
//     or C2 when that is empty.
//   * Pass 2 is combine_rows_kernel<M, true>'s sum over the selected rows
//     in ascending order with __fmul_rn/__fadd_rn, then __fdiv_rn by Σw
//     (guarded to 1), so the aggregate is bit-equal to
//     ref.masked_mean_det(G, w).  It reads the resident tiles, else G, last
//     tile first (the tiles pass 1 read last are the ones still in L2),
//     with the loads of four selected rows of four tiles in flight.
//   * Block 0 writes the diagnostics to `small`: scores [M], l1 [M], w [M],
//     kth, 𝔗 as floats, then sel [M], c1 [M], c2 [M] as bytes.
constexpr int SMEM_BLOCK_LIMIT = 232448;  // 227 KB: the most one block may hold
constexpr int AGG_STATIC_SMEM = 4096;     // kept for AggShared<M>
constexpr int AGG_MAX_DYNAMIC = SMEM_BLOCK_LIMIT - AGG_STATIC_SMEM;
constexpr int AGG_ROWS = 4;               // pass 2: selected rows loaded at once
constexpr int AGG_TILES = 4;              // pass 2: tiles of G in flight

template <int M>
struct AggShared {
  float red[2][WARPS][M];  // per-warp sums of the scores and l1
  float sc[M], l1[M];      // the grid-wide statistics
  float cand[2][M];        // rank_select: x_i where it hits, else -inf
  float w[M];              // selection weights
  int rows[M];             // the selected rows, ascending
  float kth, T;
};
static_assert(sizeof(AggShared<64>) <= AGG_STATIC_SMEM, "static shared memory");

// Pass 2 over NT tiles from slot s0 down: Σ over the n selected rows in
// ascending order, AGG_ROWS rows of every tile loaded before they are
// added.  load(slot, row, col) reads one element of G.
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
      if (on[u])
        a[u] = __fadd_rn(a[u], __fmul_rn(sh.w[sh.rows[q]], load(s0 - u, sh.rows[q], col[u])));
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    if (on[u]) out[col[u]] = __fdiv_rn(a[u], den);
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS)
brsgd_aggregate_kernel(const float* __restrict__ G, long long d, int k_idx, int q_idx,
                       float threshold, int resident, float* partials,
                       float* __restrict__ small, float* __restrict__ out) {
  constexpr bool REG_ACC = M < SMEM_SORT_M;  // M <= 32: lane i counts row i
  constexpr int PAIRS = 2 * M;               // (statistic, row)
  __shared__ AggShared<M> sh;
  extern __shared__ float dyn[];
  // dynamic: the sort columns from SMEM_SORT_M on, then the resident tiles
  float* sort_scratch = dyn;
  float* tiles = dyn + (M >= SMEM_SORT_M ? pow2_at_least(M) * THREADS : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long n_tiles = (d + THREADS - 1) / THREADS;
  cg::grid_group all = cg::this_grid();

  // ---- pass 1: scores and l1 of this block's tiles
  int count = 0;                    // score of row `lane` (REG_ACC)
  float l1_acc[REG_ACC ? M : 1];
  if constexpr (REG_ACC) {
#pragma unroll
    for (int i = 0; i < M; ++i) l1_acc[i] = 0.f;
  } else {
    for (int i = tid; i < 2 * WARPS * M; i += THREADS) (&sh.red[0][0][0])[i] = 0.f;
    __syncthreads();
  }
  int n_slots = 0;
  for (long long t = b; t < n_tiles; t += grid, ++n_slots) {
    const long long col = t * THREADS + tid;
    const bool valid = col < d;
    float g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = valid ? __ldg(G + i * d + col) : 0.f;
    if (resident) {
      float* s = tiles + n_slots * (M * THREADS) + tid;
#pragma unroll
      for (int i = 0; i < M; ++i) s[i * THREADS] = g[i];
    }
    const float mean = column_mean<M>(g);
    int n_above = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) n_above += g[i] >= mean;
    const bool maj_above = 2 * n_above >= M;
    float med;
    if constexpr (REG_ACC) {
      med = padfree_median<M>(g);
    } else {
      med = column_median<M>(g, sort_scratch);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
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
    if (lane < M) sh.red[0][warp][lane] = static_cast<float>(count);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float vl = warp_sum(l1_acc[i]);
      if (lane == 0) sh.red[1][warp][i] = vl;
    }
  }
  __syncthreads();
  if (tid < PAIRS) {  // pair tid = (statistic tid / M, row tid % M)
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += sh.red[tid / M][w][tid % M];
    partials[tid * grid + b] = v;
  }
  all.sync();

  // ---- the grid-wide totals: block p sums pair p over the blocks.
  // __ldcg: other SMs wrote these during this launch (never read them
  // through the read-only path).
  float* totals = partials + PAIRS * grid;
  if (warp == 0) {
    for (long long p = b; p < PAIRS; p += grid) {
      float v = 0.f;
      for (long long j = lane; j < grid; j += 32) v += __ldcg(partials + p * grid + j);
      v = warp_sum(v);
      if (lane == 0) totals[p] = v;
    }
  }
  all.sync();

  // ---- the thresholds and the selection, in every block alike
  if (tid < PAIRS) (tid < M ? sh.sc : sh.l1)[tid % M] = __ldcg(totals + tid);
  __syncthreads();
  if (tid < PAIRS) {  // ranks: threads [0, M) the scores, [M, 2M) l1
    const int s = tid / M, i = tid % M;
    const float* x = s ? sh.l1 : sh.sc;
    const int k = s ? q_idx : k_idx;
    const float xi = x[i];
    int lt = 0, le = 0;
    for (int j = 0; j < M; ++j) {
      lt += x[j] < xi;
      le += x[j] <= xi;
    }
    sh.cand[s][i] = (lt <= k && k < le) ? xi : -INFINITY;
  }
  __syncthreads();
  if (tid == 0) {
    float kth = -INFINITY, quart = -INFINITY;
    for (int i = 0; i < M; ++i) {
      if (sh.cand[0][i] > kth) kth = sh.cand[0][i];
      if (sh.cand[1][i] > quart) quart = sh.cand[1][i];
    }
    sh.kth = kth;
    sh.T = q_idx < 0 ? threshold : quart;
  }
  __syncthreads();
  const float kth = sh.kth, T2 = __fmul_rn(2.f, sh.T);
  const bool c1 = tid < M && sh.l1[tid] <= T2;
  const bool c2 = tid < M && sh.sc[tid] >= kth;
  const bool any = __syncthreads_or(c1 && c2);
  const bool sel = any ? (c1 && c2) : c2;
  if (tid < M) sh.w[tid] = sel ? 1.f : 0.f;
  if (b == 0) {
    if (tid < M) {
      unsigned char* masks = reinterpret_cast<unsigned char*>(small + 3 * M + 2);
      small[tid] = sh.sc[tid];
      small[M + tid] = sh.l1[tid];
      small[2 * M + tid] = sel ? 1.f : 0.f;
      masks[tid] = sel;
      masks[M + tid] = c1;
      masks[2 * M + tid] = c2;
    }
    if (tid == 0) {
      small[3 * M] = sh.kth;
      small[3 * M + 1] = sh.T;
    }
  }
  // Σw of 0/1 weights is the count, exact in float; the barrier also
  // publishes sh.w
  const int n_sel = __syncthreads_count(sel);
  const float den = n_sel > 0 ? static_cast<float>(n_sel) : 1.f;
  if (sel) {  // this row's place among the selected ones
    int pos = 0;
    for (int j = 0; j < tid; ++j) pos += sh.w[j] != 0.f;
    sh.rows[pos] = tid;
  }
  __syncthreads();

  // ---- pass 2: the weighted row combine, last tile first
  if (resident) {
    const auto from_smem = [&](int slot, int i, long long) {
      return tiles[slot * (M * THREADS) + i * THREADS + tid];
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

// Dynamic shared memory of brsgd_aggregate_kernel<M> on `grid` blocks: the
// sort columns from SMEM_SORT_M on, and with `resident` one slot of
// M x THREADS floats per tile of the block with the most tiles.
template <int M>
size_t aggregate_smem(long long d, int grid, int resident) {
  const long long n_tiles = (d + THREADS - 1) / THREADS;
  const long long per_block = (n_tiles + grid - 1) / grid;
  return sizeof(float) * ((M >= SMEM_SORT_M ? pow2_at_least(M) * THREADS : 0) +
                          (resident ? per_block * M * THREADS : 0));
}

// The opt-in above 48 KB and the largest shared-memory carveout, once per
// device.
template <int M>
cudaError_t aggregate_prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(brsgd_aggregate_kernel<M>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, AGG_MAX_DYNAMIC);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(brsgd_aggregate_kernel<M>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int M>
int aggregate_coresident(long long smem, int* count) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = aggregate_prepare<M>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, brsgd_aggregate_kernel<M>,
                                                      THREADS, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *count = e == cudaSuccess ? per_sm * sms : 0;
  return static_cast<int>(e);
}

template <int M>
int launch_aggregate(const float* G, long long d, int k_idx, int q_idx, float threshold,
                     int resident, float* partials, float* small, float* out, int grid,
                     cudaStream_t stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = aggregate_smem<M>(d, grid, resident);
  if (smem > AGG_MAX_DYNAMIC) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = aggregate_prepare<M>();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&G, &d, &k_idx, &q_idx, &threshold, &resident, &partials, &small, &out};
  // a grid that is not co-resident is refused (cudaErrorCooperativeLaunchTooLarge)
  e = cudaLaunchCooperativeKernel(brsgd_aggregate_kernel<M>, dim3(grid), dim3(THREADS),
                                  args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// B1 + B2 fused: brsgd's whole aggregation in one cooperative launch of
// `grid` blocks.  k_idx, q_idx: the rank_select indices of kth and of the
// auto 𝔗 (q_idx < 0 takes `threshold`).  partials: scratch of
// 2m·grid + 2m floats; small_out (3m + 2) floats then 3m bytes; out [d].
int brsgd_aggregate(const void* G, int m, long long d, int k_idx, int q_idx,
                    float threshold, int resident, void* partials, void* small_out,
                    void* out, int grid, void* stream) {
  BRSGD_DISPATCH(m, launch_aggregate<M>(
      static_cast<const float*>(G), d, k_idx, q_idx, threshold, resident,
      static_cast<float*>(partials), static_cast<float*>(small_out),
      static_cast<float*>(out), grid, static_cast<cudaStream_t>(stream)))
}

// *count = the blocks of brsgd_aggregate_kernel<m> the current card holds
// at once with smem bytes of dynamic shared memory each
int brsgd_aggregate_coresident(int m, long long smem, void* count) {
  BRSGD_DISPATCH(m, aggregate_coresident<M>(smem, static_cast<int*>(count)))
}

}  // extern "C"
