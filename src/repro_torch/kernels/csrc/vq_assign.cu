// vq_assign: Eq. 10 disturbance-weighted nearest-cluster assignment,
//   a_b = argmin_k max(||v_b||^2 - 2 v_b . e_k + ||e_k||^2, 0) * r_k,
// the first minimum (ties to the lower cluster id, as jnp.argmin).
//
// Replaces: src/repro/kernels/vq_assign.py, _vq_assign_kernel /
//   vq_assign_pallas (a grid over (item blocks, K blocks) that carries a
//   running (value, index) minimum from one K block to the next).
//
// Bound on Hopper: at the train shape (B=65536 items, K=16384, d=64) the
//   function does 2*B*K*d = 137 GFLOP of fp32 FMAs and must move only
//   about 21 MB (v, e, r, the ids), so it is bound by the fp32 pipes
//   (about 2.05 ms at 67 TFLOP/s), not by device memory.
//
// Design: no (B, K) score matrix is written.  One block owns 64 items and
//   keeps their v tile in shared memory; it loops over the codebook in
//   tiles of 128 clusters staged through shared memory (the loop takes the
//   place of the TPU's sequential K grid dimension, since Hopper's blocks
//   run in no order).  Each thread computes a 4 x 8 micro-tile of dots
//   with fp32 FMAs (tiles.cuh), applies the norm/disturbance epilogue in
//   the reference's order, and keeps a running (value, index) minimum per
//   row in registers with a strict <, so the first minimum wins.  At the
//   end the 16 column owners of a row merge their minima by shuffles,
//   lower index on equal values.  The ragged edges of B and K are masked,
//   no cluster is padded.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kRows;
using tiles::kThreads;
using tiles::kXS;

__global__ void __launch_bounds__(kThreads)
vq_assign_kernel(const float* __restrict__ v, const float* __restrict__ e,
                 const float* __restrict__ r, int* __restrict__ out, int B,
                 int K, int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ys = xs + tiles::x_tile_floats(d);
  float* vv_s = ys + tiles::y_tile_floats(d);
  float* ee_s = vv_s + kRows;
  float* r_s = ee_s + kCols;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * kRows;

  tiles::load_x_tile(v, B, d, b0, xs);
  __syncthreads();
  if (tid < kRows) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(xs[j * kXS + tid], xs[j * kXS + tid], s);
    vv_s[tid] = s;
  }

  float best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = 0.f;
    bidx[i] = -1;
  }
  float acc[4][8];
  for (int k0 = 0; k0 < K; k0 += kCols) {
    __syncthreads();  // the previous tile's epilogue is done with ys, ee_s
    tiles::load_y_tile(e, K, d, k0, ys);
    __syncthreads();
    if (tid < kCols) {
      const float* row = ys + tid * (d + 1);
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
      ee_s[tid] = s;
      r_s[tid] = k0 + tid < K ? r[k0 + tid] : 0.f;
    }
    tiles::tile_dot(xs, ys, d, acc);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = tx + 16 * q;
      const int gk = k0 + c;
      if (gk >= K) continue;
      const float ee = ee_s[c], rk = r_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // (vv - 2 dot) + ee, clamped at 0, times r: the reference's order
        const float t = __fmaf_rn(-2.f, acc[i][q], vv_s[4 * ty + i]);
        const float s = __fmul_rn(fmaxf(__fadd_rn(t, ee), 0.f), rk);
        if (bidx[i] < 0 || s < best[i]) {
          best[i] = s;
          bidx[i] = gk;
        }
      }
    }
  }
  // merge the 16 column owners of each row (lanes tx = 0..15 of a half
  // warp): smaller value, then lower index
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (oi >= 0 && (bidx[i] < 0 || ov < best[i] ||
                      (ov == best[i] && oi < bidx[i]))) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
    const int gb = b0 + 4 * ty + i;
    if (tx == 0 && gb < B) out[gb] = bidx[i];
  }
}

}  // namespace

extern "C" size_t vq_assign_smem_bytes(int d) {
  return (tiles::x_tile_floats(d) + tiles::y_tile_floats(d) + kRows +
          2 * kCols) * sizeof(float);
}

// v (B, d), e (K, d), r (K,) fp32 row-major -> out (B,) int32.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int vq_assign_launch(const float* v, const float* e,
                                const float* r, int* out, int B, int K, int d,
                                cudaStream_t stream) {
  const size_t smem = vq_assign_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + kRows - 1) / kRows;
  vq_assign_kernel<<<grid, kThreads, smem, stream>>>(v, e, r, out, B, K, d);
  return static_cast<int>(cudaGetLastError());
}
