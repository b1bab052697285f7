// The bucket instances of the BrSGD kernels (brsgd_kernels.cuh): every
// worker count 1 <= m <= 64 without a tuned instance (brsgd_stats.cu)
// runs the instance of its power of two M = pow2_at_least(m), with m
// passed at run time.  Rows m..M-1 are never read; the sort column's
// slots m..M-1 hold +inf, as ref.bitonic_stages pads them, so medians and
// trimmed means keep the plain version's bits; row-order sums, score
// counts and the rules' loops stop at m.  Built as a library of its own,
// beside the tuned one, so the two compile in parallel.

// m to the bucket of its power of two
#define BRSGD_BUCKET(MP, CALL) { constexpr int M = MP; constexpr bool BUCKET = true; return CALL; }
#define BRSGD_DISPATCH(m, CALL)                                  \
  if ((m) < 1 || (m) > 64) return static_cast<int>(cudaErrorInvalidValue); \
  if ((m) <= 2) BRSGD_BUCKET(2, CALL)                            \
  if ((m) <= 4) BRSGD_BUCKET(4, CALL)                            \
  if ((m) <= 8) BRSGD_BUCKET(8, CALL)                            \
  if ((m) <= 16) BRSGD_BUCKET(16, CALL)                          \
  if ((m) <= 32) BRSGD_BUCKET(32, CALL)                          \
  BRSGD_BUCKET(64, CALL)

#include "brsgd_kernels.cuh"
