// The tuned instances of the BrSGD kernels (brsgd_kernels.cuh): one per
// worker count of the paper's experiments and the port's main path, m
// a compile-time constant, so every row loop and the median's pad slots
// are resolved by the compiler.  Every other m <= 64 takes its bucket
// instance in brsgd_bucket.cu.

// the worker counts with a tuned instance
#define BRSGD_DISPATCH(m, CALL)                                                          \
  switch (m) {                                                                           \
    case 4: { constexpr int M = 4; constexpr bool BUCKET = false; return CALL; }         \
    case 5: { constexpr int M = 5; constexpr bool BUCKET = false; return CALL; }         \
    case 7: { constexpr int M = 7; constexpr bool BUCKET = false; return CALL; }         \
    case 8: { constexpr int M = 8; constexpr bool BUCKET = false; return CALL; }         \
    case 10: { constexpr int M = 10; constexpr bool BUCKET = false; return CALL; }       \
    case 16: { constexpr int M = 16; constexpr bool BUCKET = false; return CALL; }       \
    case 20: { constexpr int M = 20; constexpr bool BUCKET = false; return CALL; }       \
    case 32: { constexpr int M = 32; constexpr bool BUCKET = false; return CALL; }       \
    case 64: { constexpr int M = 64; constexpr bool BUCKET = false; return CALL; }       \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }

#include "brsgd_kernels.cuh"
