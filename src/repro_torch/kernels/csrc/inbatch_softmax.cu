// inbatch_softmax: the fused in-batch softmax cross-entropy of L_aux / L_ind
// (Eq. 1 / Eq. 4 with the Eq. 11 bias and the logQ correction) and its VJP.
//
// With z_or = u_o . v_r + bias_r - logQ_r over all B columns of the batch:
//   forward   loss_o = m_o + log(l_o) - z_oo, with the online logsumexp
//             stats m_o = max_r z_or and l_o = sum_r exp(z_or - m_o);
//   backward  from the saved lse_o = m_o + log(l_o) and the cotangent g,
//             p_or = exp(z_or - lse_o):
//               du_acc_o = sum_r p_or v_r            (bwd_kernel<DP, false>)
//               dv_acc_r = sum_o g_o p_or u_o        (bwd_kernel<DP, true>)
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
//   backward needs z once and its two contractions, 6*B*B*d = 1.65 TFLOP:
//   24.6 ms in the fp32 pipes, or, as three tf32 passes on the tensor
//   cores, 4.95 TFLOP at 495 TFLOP/s = 10.0 ms; its B*B exponentials
//   (4.3 G) take 1.03 ms.  Bytes are tens of MB: all of it is bound by
//   operations.
//
// Design: nothing (B, B) is ever written, and no float atomics are used,
//   so every result is the same from run to run.  Hopper's blocks run in
//   no order, so each carried accumulator becomes a loop inside a block.
//   - fwd_kernel (fp32 SIMT): one block per 64-row tile keeps its u tile in
//     shared memory and loops over 128-column tiles of v (tiles.cuh: 4 x 8
//     micro-tile of fp32 FMAs per thread).  Each thread keeps an online
//     (m, l) per row over its own columns and the diagonal where it
//     meets it; the 16 owners of a row merge at the end by shuffles.
//   - backward, on the tensor cores at fp32 accuracy (tf32x3.cuh: 3xTF32
//     on wgmma).  The fp32 SIMT version (du_kernel + dv_kernel, 105 ms a
//     call at the train shape on an H100) was bound by the fp32 pipes; a
//     single tf32 pass would break rtol 1e-4 / atol 1e-5.  prep_kernel
//     splits u and v once a launch into tf32 hi and lo parts, zero-padded
//     to DP = d rounded up to 32 and Bp = B rounded up to 128 (zeros are
//     exact), with transposed copies whose columns take each 8 rows in the
//     order {0, 2, 4, 6, 1, 3, 5, 7}, and packs (bias, logQ) and (lse, g).
//     One kernel body serves both sides: a block, one warpgroup, owns 64
//     "fixed" rows (u rows for du, v rows for dv) and streams 32-row tiles
//     of the other operand through a two-stage cp.async ring.  For each
//     tile it runs
//       z (64 x 32) = fixed . stream^T       wgmma m64n32k8: the fixed
//                                            rows from registers (d <= 64;
//                                            three blocks an SM) or shared
//                                            memory, the tile K-major in
//                                            shared memory,
//     turns z into p (du) or g p (dv) in its registers, and contracts it
//       acc (64 x DP) += p . stream          wgmma m64nDPk8, p from
//                                            registers, the transposed
//                                            stream tile from shared memory,
//     three passes each (lo.hi, hi.lo, hi.hi).  tf32 wgmma takes K-major
//     operands only, hence the transposed copies; the accumulator fragment
//     of z is the register A fragment of the second product once the 8
//     rows of a k-step are taken in the permuted order, so p never leaves
//     the registers, and its split is the only per-element one.  Each
//     tile's contraction starts from zero and is added into fp32 sums with
//     round-to-nearest (the tensor cores add with truncation).
//     The tensor-core z is nearer the exact logit than the plain version's
//     (a chain of fp32 FMAs in order of d: 5.3e-6 against 1.2e-5 from
//     fp64 at B=1000, d=64, unit normal u, v), yet another rounding: where
//     p is large, du - the difference of p . v and v - cancels, and a
//     first version's du left the plain version's by 2.2x the tolerance.
//     So a p above 2^-7 (at most 128 a row, a few where a row's p is
//     peaked, none where it is flat) takes its logit from the plain
//     version's own chain, read from the fp32 u and v, and the accurate
//     expf; the rest take __expf.  dv's column sums of g p (db) are fp32
//     adds in a fixed order and a fixed quad shuffle.  z is computed in
//     both kernels.
//   The ragged edges are masked (no padding column with a huge logQ).
//   d is at most 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kRows;
using tiles::kThreads;

constexpr float kNeg = -1e30f;
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

// ---- backward on the tensor cores ----------------------------------------

constexpr int kStream = 32;    // streamed rows of a tile: one slab of k
constexpr int kPadRows = 128;  // Bp: B rounded up to this

// d padded to whole 128-byte slabs of tf32 (zeros add nothing)
__host__ __device__ constexpr int pad_dims(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int pad_rows(int b) {
  return (b + kPadRows - 1) / kPadRows * kPadRows;
}
// Up to DP = 64 a thread keeps the fixed rows' A fragments of z in
// registers (DP of them), three blocks an SM; above, they stay in shared
// memory, one block an SM.
__host__ __device__ constexpr bool bwd_a_in_regs(int dp) { return dp <= 64; }
// bytes: the fixed rows' hi and lo tiles where they live in shared
// memory; two stages of the streamed rows' hi and lo tiles for z (k =
// dims) and for the contraction (k = rows); two stages of 32 (bias, logQ)
// or (lse, g) pairs; 1024 for alignment
__host__ __device__ constexpr size_t bwd_fixed_bytes(int dp) {
  return bwd_a_in_regs(dp) ? 0 : 2 * static_cast<size_t>(dp) * 64 * 4;
}
__host__ __device__ constexpr size_t bwd_stage_bytes(int dp) {
  return 4 * static_cast<size_t>(dp) * 128;
}
size_t bwd_smem_bytes(int d) {
  const int dp = pad_dims(d);
  return 1024 + bwd_fixed_bytes(dp) + 2 * bwd_stage_bytes(dp) +
         2 * kStream * sizeof(float2);
}

// Per operand x (u, v): hi, lo (Bp, DP) and their transposes (DP, Bp),
// whose columns take each 8 rows in the order {0, 2, 4, 6, 1, 3, 5, 7},
// and x itself (Bp, DP), zero-padded; bq (Bp,) (bias, logQ) and lg (Bp,)
// (lse, g).
struct Split {
  float *hi, *lo, *hi_t, *lo_t, *x;
};

__global__ void prep_kernel(const float* __restrict__ u,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ logq,
                            const float* __restrict__ lse,
                            const float* __restrict__ g, Split su, Split sv,
                            float2* bq, float2* lg, int B, int Bp, int d,
                            int DP) {
  const size_t total = static_cast<size_t>(Bp) * DP;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / DP), j = static_cast<int>(i % DP);
    const bool ok = r < B && j < d;
    const size_t src = static_cast<size_t>(r) * d + j;
    // slot of row r among its 8: the inverse of {0, 2, 4, 6, 1, 3, 5, 7}
    const size_t t = static_cast<size_t>(j) * Bp + (r & ~7) +
                     ((r & 1) << 2 | (r & 7) >> 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const Split& o = k ? sv : su;
      const float x = ok ? (k ? v : u)[src] : 0.f;
      const float2 p = tf32x3::split(x);
      o.x[i] = x;
      o.hi[i] = p.x;
      o.lo[i] = p.y;
      o.hi_t[t] = p.x;
      o.lo_t[t] = p.y;
    }
    if (j == 0) {
      bq[r] = r < B ? make_float2(bias[r], logq[r]) : make_float2(0.f, 0.f);
      lg[r] = r < B ? make_float2(lse[r], g[r]) : make_float2(0.f, 0.f);
    }
  }
}

// p of a logit dot: kDV false, fixed (lse_o, g_o), stream (bias_r, logQ_r);
// kDV true, fixed (bias_r, logQ_r), stream (lse_o, g_o).  kExact: expf, as
// the plain version; else __expf (ex2.approx).
template <bool kDV, bool kExact>
__device__ __forceinline__ float prob(float dot, float2 fv, float2 sv) {
  const float x = kDV ? logit(dot, fv.x, fv.y) - sv.x
                      : logit(dot, sv.x, sv.y) - fv.x;
  return kExact ? expf(x) : __expf(x);
}

// The plain version's dot: a chain of fp32 FMAs in order of d.  Out of
// line: it runs for few elements, and sixteen inlined copies cost more.
__device__ __noinline__ float fp32_dot(const float* __restrict__ a,
                                       const float* __restrict__ b, int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < d; ++j) acc = fmaf(__ldg(a + j), __ldg(b + j), acc);
  return acc;
}

// A p above this takes its logit from fp32_dot rather than the tensor cores.
constexpr float kExactP = 1.f / 128.f;

// kDV false (du): fixed = u rows o with fvec = lg, stream = v rows r with
//   svec = bq; out = du_acc.
// kDV true (dv): fixed = v rows r with fvec = bq, stream = u rows o with
//   svec = lg; out = dv_acc, db = db_acc.
template <int DP, bool kDV>
__global__ void __launch_bounds__(128, bwd_a_in_regs(DP) ? 3 : 1)
bwd_kernel(Split fixed, Split stream, const float2* __restrict__ fvec,
           const float2* __restrict__ svec, float* __restrict__ out,
           float* __restrict__ db, int B, int Bp, int d) {
  using tf32x3::bits;
  using tf32x3::sw128_desc;
  constexpr int kThreads = 128;            // one warpgroup
  constexpr int kFixed = 64;               // fixed rows of a block
  constexpr int kK = DP / 8;               // k-steps of z
  constexpr bool kARegs = bwd_a_in_regs(DP);
  constexpr uint32_t kFixedPart = DP * kFixed * 4;   // hi or lo tile
  constexpr uint32_t kZPart = DP * kStream * 4;      // stream, k = dims
  constexpr uint32_t kPPart = DP * 128;              // stream, k = rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tf32x3::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + bwd_fixed_bytes(DP);
  float2* vring = reinterpret_cast<float2*>(ring + 2 * bwd_stage_bytes(DP));
  const uint32_t fixed_s = tf32x3::smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * kFixed;
  // this thread's fixed rows lf + 8 r: the wgmma accumulator fragment
  // holds element 4 j + 2 r + e at row lf + 8 r, column 8 j + 2 t + e
  const int lf = 16 * warp + g;

  auto load_stage = [&](int it) {
    unsigned char* st = ring + (it & 1) * bwd_stage_bytes(DP);
    const size_t c0 = static_cast<size_t>(it) * kStream;
    tf32x3::load_k_major<DP, kStream, kThreads>(st, stream.hi + c0 * DP);
    tf32x3::load_k_major<DP, kStream, kThreads>(st + kZPart,
                                                stream.lo + c0 * DP);
    tf32x3::load_slab<DP, kThreads>(st + 2 * kZPart, stream.hi_t + c0, Bp);
    tf32x3::load_slab<DP, kThreads>(st + 2 * kZPart + kPPart,
                                    stream.lo_t + c0, Bp);
    if (tid < kStream / 2)
      tf32x3::cp_async16(vring + (it & 1) * kStream + 2 * tid,
                         svec + c0 + 2 * tid);
  };
  // z's A operand: in registers, the fragment {(lf, k), (lf + 8, k),
  // (lf, k + 4), (lf + 8, k + 4)} of k-step kk at k = 8 kk + t; or a tile
  uint32_t fa[kARegs ? kK : 1][2][4];
  if constexpr (kARegs) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t at = static_cast<size_t>(f0 + lf + 8 * (q & 1)) * DP +
                          8 * kk + t + 4 * (q >> 1);
        fa[kk][0][q] = bits(fixed.hi[at]);
        fa[kk][1][q] = bits(fixed.lo[at]);
      }
  } else {
    tf32x3::load_k_major<DP, kFixed, kThreads>(
        smem, fixed.hi + static_cast<size_t>(f0) * DP);
    tf32x3::load_k_major<DP, kFixed, kThreads>(
        smem + kFixedPart, fixed.lo + static_cast<size_t>(f0) * DP);
  }
  load_stage(0);
  tf32x3::cp_async_commit();
  const float2 fv[2] = {fvec[f0 + lf], fvec[f0 + lf + 8]};

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float dbs[2] = {0.f, 0.f};

  const int n_it = Bp / kStream;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_stage(it + 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    tf32x3::fence_proxy_async();
    __syncthreads();
    const uint32_t st =
        tf32x3::smem_u32(ring + (it & 1) * bwd_stage_bytes(DP));
    const float2* vec = vring + (it & 1) * kStream;
    const int c0 = it * kStream;

    // z (64 x 32) = fixed . stream^T over d: k-step kk is 32 bytes of
    // slab kk / 4; lo.hi, hi.lo, hi.hi into one accumulator
    float s[16];
    tf32x3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const uint32_t sb = st + (kk >> 2) * (kStream * 128) + (kk & 3) * 32;
      if constexpr (kARegs) {
        tf32x3::wgmma_rs_n32(s, fa[kk][1], sw128_desc(sb), kk > 0);
        tf32x3::wgmma_rs_n32(s, fa[kk][0], sw128_desc(sb + kZPart), 1);
        tf32x3::wgmma_rs_n32(s, fa[kk][0], sw128_desc(sb), 1);
      } else {
        const uint32_t fs =
            fixed_s + (kk >> 2) * (kFixed * 128) + (kk & 3) * 32;
        tf32x3::wgmma_ss_n32(s, sw128_desc(fs + kFixedPart), sw128_desc(sb),
                             kk > 0);
        tf32x3::wgmma_ss_n32(s, sw128_desc(fs), sw128_desc(sb + kZPart), 1);
        tf32x3::wgmma_ss_n32(s, sw128_desc(fs), sw128_desc(sb), 1);
      }
    }
    tf32x3::wgmma_commit();
    tf32x3::wgmma_wait_all();
    tf32x3::keep(s);

    // p (du) or g p (dv) in place
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          const int ls = 8 * j + 2 * t + e, lfr = lf + 8 * r;
          const float2 sv = vec[ls];
          float val = 0.f;
          if (c0 + ls < B && f0 + lfr < B) {
            float p = prob<kDV, false>(x, fv[r], sv);
            if (p > kExactP)
              p = prob<kDV, true>(
                  fp32_dot(fixed.x + static_cast<size_t>(f0 + lfr) * DP,
                           stream.x + static_cast<size_t>(c0 + ls) * DP, d),
                  fv[r], sv);
            val = kDV ? __fmul_rn(sv.y, p) : p;
          }
          x = val;
          if (kDV) dbs[r] += val;
        }

    // acc += p . stream, from zero each tile: k-step kk takes stream rows
    // 8 kk + {0, 2, 4, 6, 1, 3, 5, 7}, the transposed tiles' order, which
    // makes s[4 kk .. 4 kk + 3] = {(g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1)} the A fragment {a0, a2, a1, a3}
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 h = tf32x3::split(s[4 * kk + ((q & 1) << 1 | q >> 1)]);
        ah[kk][q] = bits(h.x);
        al[kk][q] = bits(h.y);
      }
    float part[DP / 2];
    tf32x3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pb = st + 2 * kZPart + kk * 32;
      tf32x3::wgmma_rs<DP>(part, al[kk], sw128_desc(pb), kk > 0);
      tf32x3::wgmma_rs<DP>(part, ah[kk], sw128_desc(pb + kPPart), 1);
      tf32x3::wgmma_rs<DP>(part, ah[kk], sw128_desc(pb), 1);
    }
    tf32x3::wgmma_commit();
    tf32x3::wgmma_wait_all();
    tf32x3::keep(part);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += part[i];
    __syncthreads();  // the stage is read; the next iteration refills it
  }

#pragma unroll
  for (int m = 0; m < DP / 8; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = f0 + lf + 8 * r, j = 8 * m + 2 * t + e;
        if (row < B && j < d)
          out[static_cast<size_t>(row) * d + j] = acc[4 * m + 2 * r + e];
      }
  if (kDV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = dbs[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int row = f0 + lf + 8 * r;
      if (t == 0 && row < B) db[row] = x;
    }
  }
}

size_t fwd_smem_floats(int d) {
  return tiles::x_tile_floats(d) + tiles::y_tile_floats(d) + 2 * kCols;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Largest dynamic shared memory any of the kernels takes at width d.
extern "C" size_t inbatch_softmax_smem_bytes(int d) {
  const size_t f = fwd_smem_floats(d) * sizeof(float), b = bwd_smem_bytes(d);
  return f > b ? f : b;
}

extern "C" int inbatch_softmax_max_d() { return kMaxD; }

// Scratch floats the backward takes: the split u and v and the packed
// vectors, padded.
extern "C" size_t inbatch_softmax_bwd_scratch_floats(int B, int d) {
  const size_t bp = pad_rows(B), dp = pad_dims(d);
  return 10 * bp * dp + 4 * bp;
}

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

template <int DP>
int bwd_launch(const float* u, const float* v, const float* bias,
               const float* logq, const float* lse, const float* g,
               float* scratch, float* du_acc, float* dv_acc, float* db_acc,
               int B, int d, cudaStream_t stream) {
  const int bp = pad_rows(B);
  const size_t total = static_cast<size_t>(bp) * DP;
  Split sp[2];
  for (int k = 0; k < 2; ++k)
    sp[k] = Split{scratch + (5 * k) * total, scratch + (5 * k + 1) * total,
                  scratch + (5 * k + 2) * total, scratch + (5 * k + 3) * total,
                  scratch + (5 * k + 4) * total};
  float2* bq = reinterpret_cast<float2*>(scratch + 10 * total);
  float2* lg = bq + bp;
  const int prep_blocks =
      static_cast<int>(total / 256 < 4096 ? (total + 255) / 256 : 4096);
  prep_kernel<<<prep_blocks, 256, 0, stream>>>(u, v, bias, logq, lse, g,
                                               sp[0], sp[1], bq, lg, B, bp,
                                               d, DP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem_bytes(d);
  const int blocks = bp / 64, threads = 128;
  err = allow_smem(bwd_kernel<DP, false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<DP, false><<<blocks, threads, smem, stream>>>(
      sp[0], sp[1], lg, bq, du_acc, nullptr, B, bp, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(bwd_kernel<DP, true>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<DP, true><<<blocks, threads, smem, stream>>>(
      sp[1], sp[0], bq, lg, dv_acc, db_acc, B, bp, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As the forward, plus lse, g (B,) and a scratch buffer of
// inbatch_softmax_bwd_scratch_floats(B, d) floats (16-byte aligned) ->
// du_acc (B, d), dv_acc (B, d), db_acc (B,).  Returns the CUDA error code
// of the launches.
extern "C" int inbatch_softmax_bwd_launch(const float* u, const float* v,
                                          const float* bias, const float* logq,
                                          const float* lse, const float* g,
                                          float* scratch, float* du_acc,
                                          float* dv_acc, float* db_acc, int B,
                                          int d, cudaStream_t stream) {
#define REPRO_BWD(dp)                                                       \
  case dp:                                                                  \
    return bwd_launch<dp>(u, v, bias, logq, lse, g, scratch, du_acc, dv_acc, \
                          db_acc, B, d, stream);
  switch (pad_dims(d)) {
    REPRO_BWD(32) REPRO_BWD(64) REPRO_BWD(96) REPRO_BWD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD
}
