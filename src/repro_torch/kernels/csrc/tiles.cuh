// Shared tiling of the fp32 SIMT "row tile x column tile" products used by
// vq_assign.cu and inbatch_softmax.cu.
//
// A block of kThreads = 256 threads computes a kRows x kCols = 64 x 128
// tile of dot products x_r . y_c.  Thread (tx = tid % 16, ty = tid / 16)
// owns rows 4*ty + i (i < 4) and columns tx + 16*q (q < 8).
//   - the x tile lives in shared memory transposed, xs[j * kXS + r], so a
//     thread reads its four rows with one float4;
//   - the y tile lives row-major with a padded stride d + 1,
//     ys[c * (d + 1) + j], so the 16 column owners of a half warp read 16
//     different banks.
// Each dot is a chain of fp32 FMAs in order of j (no TF32).

#pragma once

#include <cuda_runtime.h>

namespace tiles {

constexpr int kRows = 64;
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kXS = kRows + 4;  // x tile row stride: 16-byte aligned rows,
                                // neighbouring j on other banks

__host__ __device__ inline size_t x_tile_floats(int d) {
  return static_cast<size_t>(d) * kXS;
}
__host__ __device__ inline size_t y_tile_floats(int d) {
  return static_cast<size_t>(kCols) * (d + 1);
}

// xs[j * kXS + r] = x[r0 + r, j], zero beyond row n.  Consecutive threads
// take consecutive rows of one column j: conflict-free shared stores.
__device__ inline void load_x_tile(const float* __restrict__ x, int n, int d,
                                   int r0, float* xs) {
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i % kRows, j = i / kRows;
    const int g = r0 + r;
    xs[j * kXS + r] = g < n ? x[static_cast<size_t>(g) * d + j] : 0.f;
  }
}

// ys[c * (d + 1) + j] = y[c0 + c, j], zero beyond row n.  Coalesced reads.
__device__ inline void load_y_tile(const float* __restrict__ y, int n, int d,
                                   int c0, float* ys) {
  for (int i = threadIdx.x; i < kCols * d; i += kThreads) {
    const int c = i / d, j = i % d;
    const int g = c0 + c;
    ys[c * (d + 1) + j] = g < n ? y[static_cast<size_t>(g) * d + j] : 0.f;
  }
}

// acc[i][q] = sum_j xs[j][4*ty + i] * ys[tx + 16*q][j]
__device__ inline void tile_dot(const float* xs, const float* ys, int d,
                                float acc[4][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
  const float* yc = ys + tx * (d + 1);
  const int ystep = 16 * (d + 1);
  for (int j = 0; j < d; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(&xs[j * kXS + 4 * ty]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) bv[q] = yc[q * ystep + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
  }
}

}  // namespace tiles
