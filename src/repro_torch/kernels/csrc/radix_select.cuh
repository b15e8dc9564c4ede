// Pieces of the radix top-k select shared by cluster_rank.cu and
// topk_dot.cu: the order-preserving key and one warp's digit search.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

// Monotone map float -> uint32 (larger float, larger key); -0.0 -> +0.0.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.f) f = 0.f;
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One full warp, over the 256-bin histogram of the current 8-bit digit:
// the largest digit at which the count of keys at or above it reaches
// `need` (> 0, at most the histogram's total), and the count of keys
// above that digit.  Lane l owns digits 255-8l down to 248-8l; every
// lane gets the result.
__device__ inline void find_digit(const unsigned* hist, unsigned need,
                                  int* digit, unsigned* above) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned local = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = hist[255 - 8 * lane - q];
    local += c[q];
  }
  unsigned incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
  const int src = __ffs(hit) - 1;
  unsigned acc = incl - local;
  int d = 255 - 8 * lane;
  for (int q = 0; q < 8; ++q) {
    if (acc + c[q] >= need) {
      d = 255 - 8 * lane - q;
      break;
    }
    acc += c[q];
  }
  *digit = __shfl_sync(0xffffffffu, d, src);
  *above = __shfl_sync(0xffffffffu, acc, src);
}

}  // namespace radix
