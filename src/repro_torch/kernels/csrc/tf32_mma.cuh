// Helpers shared by the tensor-core kernels (flash_attention.cu, wkv6.cu):
// the 3xTF32 split, the warp-level TF32 mma, and 16-byte cp.async copies.
//
// 3xTF32: a float32 x is split into big = tf32(x) and small = x - big
// (the split below); a·b is then summed as small·big' + big·small' +
// big·big' in float32, which keeps about float32 accuracy (the
// small·small' term, ~2^-22 of |a·b|, is dropped).
//
// mma.sync.aligned.m16n8k8 TF32 fragments, with g = lane / 4, t = lane % 4:
//   A (16 × 8, row):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                     a3 = A[g+8][t+4]
//   B (8 × 8, col):   b0 = B[t][g], b1 = B[t+4][g]
//   C (16 × 8):       c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                     c3 = C[g+8][2t+1]
// The kernels read the k index t / t+4 as the physical k = 2t / 2t+1 of
// each 8-wide step, in A and B alike (a permutation of the sum): operand
// pairs then sit side by side (one 8-byte load), and a C tile's two
// columns 2t, 2t+1 are exactly the A fragment's k = t, t+4 of a product
// that contracts over those columns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// big: x rounded to its top 19 bits (sign, exponent, 10 mantissa bits),
// half away from zero, by an integer add and mask (no cvt instruction);
// small: the exact rest x - big, passed as it is (the tensor core reads
// the top 19 bits of a TF32 operand and ignores the others, which drops
// at most 2^-10 of small, about 2^-21 of x)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// split the four A-fragment values of one k step
__device__ __forceinline__ void split4(float x0, float x1, float x2,
                                       float x3, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
  split(x2, big[2], small[2]);
  split(x3, big[3], small[3]);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c + cs += a·b in float32 accuracy, a as (big, small) fragments: big·big'
// goes to c and the correction terms, first, to cs.  Kept apart (c + cs at
// the end) they are shorter dependent chains where a warp has few tiles in
// flight (B7's A pass); the overload below passes one accumulator as both.
// With EXACT_B the B values are exact in TF32 (bfloat16 data), so b is
// passed whole and its small part is not issued.
template <bool EXACT_B>
__device__ __forceinline__ void mma3(float (&c)[4], float (&cs)[4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  if (EXACT_B) {
    const uint32_t e0 = __float_as_uint(b0), e1 = __float_as_uint(b1);
    mma(cs, as[0], as[1], as[2], as[3], e0, e1);
    mma(c, ab[0], ab[1], ab[2], ab[3], e0, e1);
  } else {
    uint32_t bb0, bb1, bs0, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma(cs, as[0], as[1], as[2], as[3], bb0, bb1);
    mma(cs, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
    mma(c, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
  }
}

template <bool EXACT_B>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  mma3<EXACT_B>(c, c, ab, as, b0, b1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tc
