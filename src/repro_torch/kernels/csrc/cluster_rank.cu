// cluster_rank: per query, the top-n clusters of u . e_k (Eq. 5 / Eq. 11).
//
// Replaces: src/repro/kernels/merge_serve.py, _cluster_rank_kernel /
//   cluster_rank_pallas (a grid over K-blocks that carries a running
//   top-n from one block to the next).
//
// Bound on Hopper: at the serve shape (B=512, K=16384, d=64, n=128) the
//   function does 2*B*K*d = 1.07 GFLOP of fp32 FMAs and must move about
//   4.6 MB (u, e, and the (B, n) outputs), so it is bound by the fp32
//   pipes, not by device memory.
//
// Design: blocks run in no order, so nothing is carried across them, and
//   a block that owned one query and streamed the whole codebook would
//   read e once per query (2 GB of L2 traffic at the serve shape).  So
//   the work is split in two kernels:
//   1. score_kernel: a tiled fp32 SIMT product.  A block stages a
//      64-query by 128-cluster tile of u and e in shared memory (chunks
//      of 32 along d) and each thread accumulates a 4x8 micro-tile with
//      sequential FMAs over d (no TF32).  The (B, K) scores go to a
//      scratch buffer the wrapper allocates (32 MB, mostly L2-resident).
//   2. select_kernel: one block per query row.  The K scores become
//      order-preserving uint32 keys in dynamic shared memory (K * 4
//      bytes: 64 KB at K=16384).  A radix select (four 8-bit passes over
//      a shared histogram, warp-aggregated atomics) finds the key of the
//      n-th largest score; all keys above it and the lowest-index keys
//      equal to it (an ordered block scan) are taken, so exact ties go to
//      the lower cluster id, as lax.top_k does.  The n entries are placed
//      by counting in (score desc, index asc) order; their scores are
//      read back from the scratch buffer, bitwise the ones ranked.
//   -0.0 and +0.0 share one key (they tie); inputs are taken to be finite.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

// ---- score_kernel: scores[b, k] = sum_j u[b, j] * e[k, j] ----------------

constexpr int kTileB = 64;
constexpr int kTileK = 128;
constexpr int kTileD = 32;
constexpr int kScoreThreads = 256;  // 16 x 16 threads, 4 x 8 outputs each

__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const float* __restrict__ u, const float* __restrict__ e,
             float* __restrict__ scores, int B, int K, int d) {
  __shared__ __align__(16) float u_s[kTileD][kTileB];   // transposed tiles
  __shared__ __align__(16) float e_s[kTileD][kTileK];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.y * kTileB, k0 = blockIdx.x * kTileK;
  float acc[4][8];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kTileD) {
    // load: consecutive threads take consecutive rows of one column j, so
    // the transposed shared-memory stores are conflict-free (the strided
    // global reads of a tile hit L1 after the first column)
    for (int i = tid; i < kTileB * kTileD; i += kScoreThreads) {
      const int r = i % kTileB, j = i / kTileB;
      const int gb = b0 + r, gj = d0 + j;
      u_s[j][r] = (gb < B && gj < d) ? u[static_cast<size_t>(gb) * d + gj]
                                     : 0.f;
    }
    for (int i = tid; i < kTileK * kTileD; i += kScoreThreads) {
      const int r = i % kTileK, j = i / kTileK;
      const int gk = k0 + r, gj = d0 + j;
      e_s[j][r] = (gk < K && gj < d) ? e[static_cast<size_t>(gk) * d + gj]
                                     : 0.f;
    }
    __syncthreads();
    const int jn = min(kTileD, d - d0);
    for (int j = 0; j < jn; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&u_s[j][4 * ty]);
      const float4 c0 = *reinterpret_cast<const float4*>(&e_s[j][8 * tx]);
      const float4 c1 = *reinterpret_cast<const float4*>(&e_s[j][8 * tx + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      for (int i = 0; i < 4; ++i)
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], cv[q], acc[i][q]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int gb = b0 + 4 * ty + i;
    if (gb >= B) continue;
    for (int q = 0; q < 8; ++q) {
      const int gk = k0 + 8 * tx + q;
      if (gk < K) scores[static_cast<size_t>(gb) * K + gk] = acc[i][q];
    }
  }
}

// ---- select_kernel: top-n of one score row -------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;

// Exclusive prefix sum over the block, in thread order.
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kSelWarps ? warp_sums[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += t;
    }
    if (lane < kSelWarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  return incl - v + warp_sums[warp];
}

__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ scores, float* __restrict__ out_val,
              int* __restrict__ out_idx, int K, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);           // K
  uint32_t* sel_key = keys + K;                                  // n
  int* sel_idx = reinterpret_cast<int*>(sel_key + n);            // n
  __shared__ unsigned int hist[256];
  __shared__ int warp_sums[kSelWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;
  __shared__ int s_nsel;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* row = scores + static_cast<size_t>(b) * K;
  for (int k = tid; k < K; k += kSelThreads)
    keys[k] = radix::order_key(row[k]);

  // Radix select: after the pass over bits [shift, shift+8), `prefix`
  // holds the top bits of the n-th largest key and `remaining` how many
  // keys with that prefix still belong to the top n.
  uint32_t prefix = 0, mask = 0;
  int remaining = n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < K; base += kSelThreads) {
      const int k = base + tid;
      const uint32_t key = k < K ? keys[k] : 0u;
      const bool in = k < K && (key & mask) == prefix;
      const unsigned int bin = in ? (key >> shift) & 255u : 256u;
      // lanes with the same bin add once, through their lowest lane
      const unsigned int peers = __match_any_sync(0xffffffffu, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      int digit;
      unsigned int above;
      radix::find_digit(hist, static_cast<unsigned int>(remaining), &digit,
                        &above);
      if (tid == 0) {
        s_prefix = prefix | (static_cast<uint32_t>(digit) << shift);
        s_remaining = remaining - static_cast<int>(above);
      }
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    mask |= 255u << shift;
  }
  const uint32_t kth = prefix;

  // Take every key above the n-th and the `remaining` lowest-index keys
  // equal to it: each thread owns a contiguous index range, so an
  // exclusive scan of the tie counts ranks the ties by index.
  const int seg = (K + kSelThreads - 1) / kSelThreads;
  const int lo = min(K, tid * seg), hi = min(K, lo + seg);
  int ties = 0;
  for (int k = lo; k < hi; ++k) ties += (keys[k] == kth);
  if (tid == 0) s_nsel = 0;
  int tie_rank = block_exclusive_scan(ties, warp_sums);
  for (int k = lo; k < hi; ++k) {
    const uint32_t key = keys[k];
    bool take = key > kth;
    if (key == kth) take = tie_rank++ < remaining;
    if (take) {
      const int slot = atomicAdd(&s_nsel, 1);
      sel_key[slot] = key;
      sel_idx[slot] = k;
    }
  }
  __syncthreads();

  // Place each selected entry at its rank in (key desc, index asc).
  float* val_row = out_val + static_cast<size_t>(b) * n;
  int* idx_row = out_idx + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += kSelThreads) {
    const uint32_t key = sel_key[i];
    const int idx = sel_idx[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const uint32_t kj = sel_key[j];
      rank += (kj > key) || (kj == key && sel_idx[j] < idx);
    }
    idx_row[rank] = idx;
    val_row[rank] = row[idx];
  }
}

}  // namespace

extern "C" size_t cluster_rank_smem_bytes(int K, int n) {
  return static_cast<size_t>(K) * 4 + static_cast<size_t>(n) * 8;
}

// u (B, d), e (K, d) fp32 row-major; scores (B, K) fp32 scratch ->
// out_val (B, n) fp32, out_idx (B, n) int32.  Returns the CUDA error code
// of the launches (0 on success).
extern "C" int cluster_rank_launch(const float* u, const float* e,
                                   float* scores, float* out_val,
                                   int* out_idx, int B, int K, int d, int n,
                                   cudaStream_t stream) {
  const dim3 grid((K + kTileK - 1) / kTileK, (B + kTileB - 1) / kTileB);
  score_kernel<<<grid, kScoreThreads, 0, stream>>>(u, e, scores, B, K, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cluster_rank_smem_bytes(K, n);
  err = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<B, kSelThreads, smem, stream>>>(scores, out_val, out_idx,
                                                  K, n);
  return static_cast<int>(cudaGetLastError());
}
