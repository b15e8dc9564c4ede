// inbatch_softmax: the fused in-batch softmax cross-entropy of L_aux / L_ind
// (Eq. 1 / Eq. 4 with the Eq. 11 bias and the logQ correction) and its VJP.
//
// With z_or = u_o . v_r + bias_r - logQ_r over all B columns of the batch:
//   forward   loss_o = m_o + log(l_o) - z_oo, with the online logsumexp
//             stats m_o = max_r z_or and l_o = sum_r exp(z_or - m_o);
//   backward  from the saved lse_o = m_o + log(l_o) and the cotangent g,
//             p_or = exp(z_or - lse_o):
//               du_acc_o = sum_r p_or v_r            (du_kernel)
//               dv_acc_r = sum_o g_o p_or u_o        (dv_kernel)
//               db_acc_r = sum_o g_o p_or
//             and the wrapper adds the rank-one terms -g v, -g u, -g.
//
// Replaces: src/repro/kernels/inbatch_softmax.py, _inbatch_kernel /
//   inbatch_softmax_pallas (forward) and _du_kernel + _dv_kernel /
//   inbatch_softmax_bwd_pallas (backward).  Those carry (m, l, diag) and
//   the du / dv accumulators across a sequential grid dimension.
//
// Bound on Hopper: at the train shape (B=65536, d=64) the forward does
//   2*B*B*d = 550 GFLOP of fp32 FMAs (8.2 ms at 67 TFLOP/s).  The
//   backward needs z once and its two contractions, 6*B*B*d = 1.65 TFLOP
//   (24.6 ms); the two kernels here do 8*B*B*d, since each recomputes z.
//   Bytes are tens of MB: all three are bound by the fp32 pipes.  B*B
//   exponentials (4.3 G) ride along.
//
// Design: nothing (B, B) is ever written, and no float atomics are used,
//   so every result is the same from run to run.  Hopper's blocks run in
//   no order, so each carried accumulator becomes a loop inside a block:
//   - fwd_kernel: one block per 64-row tile keeps its u tile in shared
//     memory and loops over 128-column tiles of v (tiles.cuh: 4 x 8
//     micro-tile of fp32 FMAs per thread).  Each thread keeps an online
//     (m, l) per row over its own columns and the diagonal where it
//     meets it; the 16 owners of a row merge at the end by shuffles.
//   - du_kernel: one block per 64-row tile loops over column tiles,
//     recomputes z, writes p to shared memory and accumulates p . v into
//     a 64 x d register tile.
//   - dv_kernel: one block per 128-column tile keeps its v tile and loops
//     over row tiles, recomputes z, writes g p to shared memory and
//     accumulates (g p)^T . u into a 128 x d register tile and the column
//     sums of g p; the per-thread partial column sums are added in a
//     fixed order at the end.
//   The ragged edges are masked (no padding column with a huge logQ).
//   d is at most 128: the backward's register tiles hold ceil(d / 16)
//   dims a thread, a template argument, so d = 64 takes half the
//   registers of d = 128.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kRows;
using tiles::kThreads;
using tiles::kXS;

constexpr float kNeg = -1e30f;
constexpr int kPS = kCols + 4;  // p tile row stride (rows 4 apart on other banks)
constexpr int kMaxD = 128;

__device__ __forceinline__ float logit(float dot, float b, float q) {
  return __fsub_rn(__fadd_rn(dot, b), q);  // (u.v + bias) - logQ
}

// ---- forward ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
           const float* __restrict__ bias, const float* __restrict__ logq,
           float* __restrict__ loss, float* __restrict__ m_out,
           float* __restrict__ l_out, int B, int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ys = xs + tiles::x_tile_floats(d);
  float* cb = ys + tiles::y_tile_floats(d);
  float* cq = cb + kCols;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kRows;
  tiles::load_x_tile(u, B, d, r0, xs);

  float m[4], l[4], dg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    dg[i] = 0.f;
  }
  float acc[4][8];
  for (int c0 = 0; c0 < B; c0 += kCols) {
    __syncthreads();
    tiles::load_y_tile(v, B, d, c0, ys);
    if (tid < kCols) {
      const int c = c0 + tid;
      cb[tid] = c < B ? bias[c] : 0.f;
      cq[tid] = c < B ? logq[c] : 0.f;
    }
    __syncthreads();
    tiles::tile_dot(xs, ys, d, acc);
    const int n_valid = min(kCols, B - c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      float z[8];
      float zmax = kNeg;
      bool any = false;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = tx + 16 * q;
        z[q] = logit(acc[i][q], cb[c], cq[c]);
        if (c < n_valid) {
          zmax = fmaxf(zmax, z[q]);
          any = true;
          if (c0 + c == row) dg[i] = z[q];
        }
      }
      if (!any) continue;
      const float m_new = fmaxf(m[i], zmax);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (tx + 16 * q < n_valid) s += expf(z[q] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + s;
      m[i] = m_new;
    }
  }
  // merge the 16 column owners of each row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float od = __shfl_xor_sync(0xffffffffu, dg[i], off);
      const float mm = fmaxf(m[i], om);
      l[i] = l[i] * expf(m[i] - mm) + ol * expf(om - mm);
      m[i] = mm;
      dg[i] += od;  // one owner holds the diagonal, the others 0
    }
    const int row = r0 + 4 * ty + i;
    if (tx == 0 && row < B) {
      loss[row] = __fsub_rn(__fadd_rn(m[i], logf(l[i])), dg[i]);
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

// ---- backward: du_acc = p . v, rows outer ----------------------------------

template <int NS>  // dims per thread: tx + 16 s, s < NS = ceil(d / 16)
__global__ void __launch_bounds__(kThreads)
du_kernel(const float* __restrict__ u, const float* __restrict__ v,
          const float* __restrict__ bias, const float* __restrict__ logq,
          const float* __restrict__ lse, float* __restrict__ du_acc, int B,
          int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ys = xs + tiles::x_tile_floats(d);
  float* ps = ys + tiles::y_tile_floats(d);
  float* cb = ps + kRows * kPS;
  float* cq = cb + kCols;
  float* lse_s = cq + kCols;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kRows;
  tiles::load_x_tile(u, B, d, r0, xs);
  if (tid < kRows) lse_s[tid] = r0 + tid < B ? lse[r0 + tid] : 0.f;

  float out[4][NS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int s = 0; s < NS; ++s) out[i][s] = 0.f;
  float acc[4][8];
  for (int c0 = 0; c0 < B; c0 += kCols) {
    __syncthreads();  // the previous tile's contraction is done
    tiles::load_y_tile(v, B, d, c0, ys);
    if (tid < kCols) {
      const int c = c0 + tid;
      cb[tid] = c < B ? bias[c] : 0.f;
      cq[tid] = c < B ? logq[c] : 0.f;
    }
    __syncthreads();
    tiles::tile_dot(xs, ys, d, acc);
    const int n_valid = min(kCols, B - c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = tx + 16 * q;
        const bool ok = c < n_valid && r0 + r < B;
        ps[r * kPS + c] =
            ok ? expf(logit(acc[i][q], cb[c], cq[c]) - lse_s[r]) : 0.f;
      }
    }
    __syncthreads();
    for (int c = 0; c < n_valid; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(4 * ty + i) * kPS + c];
      const float* yrow = ys + c * (d + 1);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = tx + 16 * s;
        if (j < d) {
          const float y = yrow[j];
#pragma unroll
          for (int i = 0; i < 4; ++i) out[i][s] = fmaf(pr[i], y, out[i][s]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= B) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int j = tx + 16 * s;
      if (j < d) du_acc[static_cast<size_t>(row) * d + j] = out[i][s];
    }
  }
}

// ---- backward: dv_acc = (g p)^T . u and db_acc = colsum(g p), cols outer ---

template <int NS>  // dims per thread: ty + 16 s, s < NS = ceil(d / 16)
__global__ void __launch_bounds__(kThreads)
dv_kernel(const float* __restrict__ u, const float* __restrict__ v,
          const float* __restrict__ bias, const float* __restrict__ logq,
          const float* __restrict__ lse, const float* __restrict__ g,
          float* __restrict__ dv_acc, float* __restrict__ db_acc, int B,
          int d) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;
  float* xs = ys + tiles::y_tile_floats(d);
  float* gps = xs + tiles::x_tile_floats(d);
  float* cb = gps + kRows * kPS;
  float* cq = cb + kCols;
  float* lse_s = cq + kCols;
  float* g_s = lse_s + kRows;
  float* dbp = g_s + kRows;  // (16, kCols) per-ty partial column sums
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kCols;
  const int n_valid = min(kCols, B - c0);
  tiles::load_y_tile(v, B, d, c0, ys);
  if (tid < kCols) {
    const int c = c0 + tid;
    cb[tid] = c < B ? bias[c] : 0.f;
    cq[tid] = c < B ? logq[c] : 0.f;
  }

  float out[8][NS];  // columns tx + 16 q, dims ty + 16 s
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int s = 0; s < NS; ++s) out[q][s] = 0.f;
  float colsum[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) colsum[q] = 0.f;
  float acc[4][8];
  for (int r0 = 0; r0 < B; r0 += kRows) {
    __syncthreads();  // the previous tile's contraction is done
    tiles::load_x_tile(u, B, d, r0, xs);
    if (tid < kRows) {
      const int r = r0 + tid;
      lse_s[tid] = r < B ? lse[r] : 0.f;
      g_s[tid] = r < B ? g[r] : 0.f;
    }
    __syncthreads();
    tiles::tile_dot(xs, ys, d, acc);
    const int n_rows = min(kRows, B - r0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = tx + 16 * q;
        const bool ok = c < n_valid && r < n_rows;
        const float gp =
            ok ? __fmul_rn(g_s[r],
                           expf(logit(acc[i][q], cb[c], cq[c]) - lse_s[r]))
               : 0.f;
        gps[r * kPS + c] = gp;
        colsum[q] += gp;
      }
    }
    __syncthreads();
    for (int o = 0; o < n_rows; ++o) {
      float a[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] = gps[o * kPS + tx + 16 * q];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = ty + 16 * s;
        if (j < d) {
          const float x = xs[j * kXS + o];
#pragma unroll
          for (int q = 0; q < 8; ++q) out[q][s] = fmaf(a[q], x, out[q][s]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = tx + 16 * q;
    dbp[ty * kCols + c] = colsum[q];
    if (c >= n_valid) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int j = ty + 16 * s;
      if (j < d) dv_acc[static_cast<size_t>(c0 + c) * d + j] = out[q][s];
    }
  }
  __syncthreads();
  if (tid < n_valid) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += dbp[t * kCols + tid];  // fixed order
    db_acc[c0 + tid] = s;
  }
}

size_t fwd_smem_floats(int d) {
  return tiles::x_tile_floats(d) + tiles::y_tile_floats(d) + 2 * kCols;
}
size_t du_smem_floats(int d) {
  return tiles::x_tile_floats(d) + tiles::y_tile_floats(d) + kRows * kPS +
         2 * kCols + kRows;
}
size_t dv_smem_floats(int d) {
  return tiles::x_tile_floats(d) + tiles::y_tile_floats(d) + kRows * kPS +
         2 * kCols + 2 * kRows + 16 * kCols;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Largest dynamic shared memory any of the three kernels takes at width d.
extern "C" size_t inbatch_softmax_smem_bytes(int d) {
  size_t f = fwd_smem_floats(d);
  if (du_smem_floats(d) > f) f = du_smem_floats(d);
  if (dv_smem_floats(d) > f) f = dv_smem_floats(d);
  return f * sizeof(float);
}

extern "C" int inbatch_softmax_max_d() { return kMaxD; }

// u, v (B, d), bias, logq (B,) fp32 -> loss, m, l (B,).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int inbatch_softmax_fwd_launch(const float* u, const float* v,
                                          const float* bias, const float* logq,
                                          float* loss, float* m, float* l,
                                          int B, int d, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(
      u, v, bias, logq, loss, m, l, B, d);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int NS>
int bwd_launch(const float* u, const float* v, const float* bias,
               const float* logq, const float* lse, const float* g,
               float* du_acc, float* dv_acc, float* db_acc, int B, int d,
               cudaStream_t stream) {
  size_t smem = du_smem_floats(d) * sizeof(float);
  cudaError_t err = allow_smem(du_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  du_kernel<NS><<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(
      u, v, bias, logq, lse, du_acc, B, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smem = dv_smem_floats(d) * sizeof(float);
  err = allow_smem(dv_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dv_kernel<NS><<<(B + kCols - 1) / kCols, kThreads, smem, stream>>>(
      u, v, bias, logq, lse, g, dv_acc, db_acc, B, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As the forward, plus lse, g (B,) -> du_acc (B, d), dv_acc (B, d),
// db_acc (B,).  Returns the CUDA error code of the launches.
extern "C" int inbatch_softmax_bwd_launch(const float* u, const float* v,
                                          const float* bias, const float* logq,
                                          const float* lse, const float* g,
                                          float* du_acc, float* dv_acc,
                                          float* db_acc, int B, int d,
                                          cudaStream_t stream) {
#define REPRO_BWD(ns)                                                     \
  case ns:                                                                \
    return bwd_launch<ns>(u, v, bias, logq, lse, g, du_acc, dv_acc, db_acc, \
                          B, d, stream);
  switch ((d + 15) / 16) {
    REPRO_BWD(1) REPRO_BWD(2) REPRO_BWD(3) REPRO_BWD(4)
    REPRO_BWD(5) REPRO_BWD(6) REPRO_BWD(7) REPRO_BWD(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD
}
