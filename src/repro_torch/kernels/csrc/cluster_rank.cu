// cluster_rank: per query, the top-n clusters of u . e_k (Eq. 5 / Eq. 11).
//
// Replaces: src/repro/kernels/merge_serve.py, _cluster_rank_kernel /
//   cluster_rank_pallas (a grid over K-blocks that carries a running
//   top-n from one block to the next).
//
// Bound on Hopper: at the serve shape (B=512, K=16384, d=64, n=128) the
//   function does 2*B*K*d = 1.07 GFLOP of fp32 FMAs and must move about
//   4.6 MB (u, e, and the (B, n) outputs), so it is bound by the fp32
//   pipes (0.016 ms), not by device memory.
//
// Design.  Timed apart on an H100 at the serve shape, the first version
//   spent 0.141 ms in its score kernel (a 64 x 128 tile loaded by strided
//   reads: 7.6 TFLOP/s) and 0.181 ms in its select (one 512-thread block
//   a query with the row's 64 KB of keys in shared memory, about 3 blocks
//   an SM, four 8-bit radix passes over all K keys with __match_any_sync
//   and shared atomics).  Both are answered:
//   1. score_kernel: a 128-query by 128-cluster tile a block, 8 x 8
//      outputs a thread (two float4 reads of each operand a step, 64
//      FMAs), operands staged in chunks of 32 along d by coalesced reads.
//      Each score stays a chain of fp32 FMAs in order of d (no TF32), so
//      a shard's slice of the codebook scores a cluster bitwise as the
//      whole codebook does.  The (B, K) scores go to a scratch buffer
//      (mostly L2-resident), and beside them the maximum of each thread's
//      8 clusters: K/8 segment maxima a query.
//   2. select_kernel: one block a query, no copy of the row.  The n-th
//      largest segment maximum T is a lower bound on the n-th largest
//      score (n segments reach T, each through one of its own clusters),
//      so the top n lie among the scores >= T: about n to 2n of them on
//      random inputs.  A radix select over the K/8 maxima finds T, one
//      pass over the row compacts the scores >= T into shared memory as
//      (key, ~index) pairs, and a bitonic sort of that short list puts
//      them in (score desc, index asc) order; the first n are the answer.
//      Fewer than n segments (n > K/8), or more survivors than the list
//      holds (heavy ties), take the exact path: a radix select over the
//      row for the n-th key itself, then the same compaction, or, if the
//      ties at that key still overflow the list, the keys above it and
//      its lowest-index ties in index order.
//   Exact ties go to the lower cluster id, as lax.top_k does; the output
//   scores are read back from the scratch buffer, bitwise the ones ranked.
//   The only atomics are integer ones (histogram counts and list slots);
//   the sort makes the result independent of slot order, so two launches
//   agree bitwise.  -0.0 and +0.0 share one key (they tie); inputs are
//   taken to be finite.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

// ---- score_kernel: scores[b, k] = sum_j u[b, j] * e[k, j] ----------------

constexpr int kTile = 128;          // queries and clusters of a block tile
constexpr int kTileD = 32;          // depth of a staged chunk
constexpr int kTS = kTile + 4;      // staged row stride (16-byte rows)
constexpr int kScoreThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSegs = 16;           // segments of a tile: one per column owner

// Thread (tx, ty) owns rows {4ty + i, 64 + 4ty + i} and columns
// {4tx + q, 64 + 4tx + q} (i, q < 4): each operand read is two float4 at
// 16 consecutive bytes a lane.  Its 8 columns are segment kt * 16 + tx.
__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const float* __restrict__ u, const float* __restrict__ e,
             float* __restrict__ scores, float* __restrict__ segmax, int B,
             int K, int d, int nseg) {
  __shared__ __align__(16) float u_s[kTileD][kTS];  // transposed chunks
  __shared__ __align__(16) float e_s[kTileD][kTS];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kTileD) {
    // coalesced: consecutive threads read consecutive j of one row
    for (int i = tid; i < kTile * kTileD; i += kScoreThreads) {
      const int r = i / kTileD, j = i % kTileD;
      const int gj = d0 + j;
      const int gb = b0 + r, gk = k0 + r;
      u_s[j][r] = (gb < B && gj < d) ? u[static_cast<size_t>(gb) * d + gj]
                                     : 0.f;
      e_s[j][r] = (gk < K && gj < d) ? e[static_cast<size_t>(gk) * d + gj]
                                     : 0.f;
    }
    __syncthreads();
    const int jn = min(kTileD, d - d0);
    for (int j = 0; j < jn; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(&u_s[j][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&u_s[j][64 + 4 * ty]);
      const float4 c0 = *reinterpret_cast<const float4*>(&e_s[j][4 * tx]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&e_s[j][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], cv[q], acc[i][q]);
    }
    __syncthreads();
  }
  const int seg = blockIdx.x * kSegs + tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gb = b0 + 4 * ty + (i & 3) + (i >> 2) * 64;
    if (gb >= B) continue;
    float* row = scores + static_cast<size_t>(gb) * K;
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gk = k0 + 4 * tx + (q & 3) + (q >> 2) * 64;
      if (gk < K) {
        row[gk] = acc[i][q];
        m = fmaxf(m, acc[i][q]);
      }
    }
    if (seg < nseg) segmax[static_cast<size_t>(gb) * nseg + seg] = m;
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

struct SelShared {
  unsigned int hist[256];
  int warp_sums[kSelWarps];
  uint32_t prefix;
  int remaining;
  int count;
};

// The key of the n-th largest of src[0, N) (1 <= n <= N) and how many
// keys equal to it belong to the top n: four 8-bit radix passes.
__device__ void radix_kth(const float* __restrict__ src, int N, int n,
                          SelShared& sh, uint32_t* kth, int* remaining_out) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  int remaining = n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) sh.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += kSelThreads) {
      const int k = base + tid;
      const uint32_t key = k < N ? radix::order_key(src[k]) : 0u;
      const bool in = k < N && (key & mask) == prefix;
      const unsigned int bin = in ? (key >> shift) & 255u : 256u;
      // lanes with the same bin add once, through their lowest lane
      const unsigned int peers = __match_any_sync(0xffffffffu, bin);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      int digit;
      unsigned int above;
      radix::find_digit(sh.hist, static_cast<unsigned int>(remaining), &digit,
                        &above);
      if (tid == 0) {
        sh.prefix = prefix | (static_cast<uint32_t>(digit) << shift);
        sh.remaining = remaining - static_cast<int>(above);
      }
    }
    __syncthreads();
    prefix = sh.prefix;
    remaining = sh.remaining;
    mask |= 255u << shift;
  }
  *kth = prefix;
  *remaining_out = remaining;
}

// Sort order: larger key first, then lower index.
__device__ __forceinline__ uint64_t pack(uint32_t key, int idx) {
  return (static_cast<uint64_t>(key) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(idx));
}

// Appends (key, index) of every row key >= t to list (up to cap entries;
// the count goes on past cap) -> how many there are.
__device__ int compact(const float* __restrict__ row, int K, uint32_t t,
                       uint64_t* list, int cap, SelShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) sh.count = 0;
  __syncthreads();
  for (int base = 0; base < K; base += kSelThreads) {
    const int k = base + tid;
    const uint32_t key = k < K ? radix::order_key(row[k]) : 0u;
    const bool take = k < K && key >= t;
    const unsigned int ballot = __ballot_sync(0xffffffffu, take);
    if (ballot == 0u) continue;
    int slot0 = 0;
    if (lane == 0) slot0 = atomicAdd(&sh.count, __popc(ballot));
    slot0 = __shfl_sync(0xffffffffu, slot0, 0);
    const int slot = slot0 + __popc(ballot & ((1u << lane) - 1u));
    if (take && slot < cap) list[slot] = pack(key, k);
  }
  __syncthreads();
  return sh.count;
}

// The keys above kth and the `remaining` lowest-index keys equal to it:
// each thread owns a contiguous index range, so an exclusive scan of the
// tie counts ranks the ties by index.  Writes exactly n entries.
__device__ void take_in_index_order(const float* __restrict__ row, int K,
                                    uint32_t kth, int remaining,
                                    uint64_t* list, SelShared& sh) {
  const int tid = threadIdx.x;
  const int seg = (K + kSelThreads - 1) / kSelThreads;
  const int lo = min(K, tid * seg), hi = min(K, lo + seg);
  int ties = 0;
  for (int k = lo; k < hi; ++k) ties += (radix::order_key(row[k]) == kth);
  __syncthreads();  // every thread has read the last count
  if (tid == 0) sh.count = 0;
  int tie_rank = block_exclusive_scan(ties, sh.warp_sums);
  for (int k = lo; k < hi; ++k) {
    const uint32_t key = radix::order_key(row[k]);
    bool take = key > kth;
    if (key == kth) take = tie_rank++ < remaining;
    if (take) list[atomicAdd(&sh.count, 1)] = pack(key, k);
  }
  __syncthreads();
}

// Bitonic sort of list[0, p), p a power of two, largest first.
__device__ void sort_desc(uint64_t* list, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += kSelThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = list[i], b = list[ixj];
          if (((i & k) == 0) ? (a < b) : (a > b)) {
            list[i] = b;
            list[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// list capacity: room for the survivors of the threshold, and for n
__host__ __device__ inline int list_cap(int K, int n) {
  const int cap = pow2_ceil(n) > 4096 ? pow2_ceil(n) : 4096;
  return cap < pow2_ceil(K) ? cap : pow2_ceil(K);
}

__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ scores,
              const float* __restrict__ segmax, float* __restrict__ out_val,
              int* __restrict__ out_idx, int K, int nseg, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* list = reinterpret_cast<uint64_t*>(smem);
  __shared__ SelShared sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = scores + static_cast<size_t>(b) * K;
  const int cap = list_cap(K, n);

  uint32_t t;
  int remaining;
  int count = cap + 1;
  if (nseg >= n) {  // the n-th largest segment maximum bounds the n-th score
    radix_kth(segmax + static_cast<size_t>(b) * nseg, nseg, n, sh, &t,
              &remaining);
    count = compact(row, K, t, list, cap, sh);
  }
  if (count > cap) {  // the n-th key itself
    radix_kth(row, K, n, sh, &t, &remaining);
    count = compact(row, K, t, list, cap, sh);
    if (count > cap) {
      take_in_index_order(row, K, t, remaining, list, sh);
      count = n;
    }
  }
  const int p = pow2_ceil(count);
  for (int i = count + tid; i < p; i += kSelThreads) list[i] = 0ull;
  __syncthreads();
  sort_desc(list, p);

  float* val_row = out_val + static_cast<size_t>(b) * n;
  int* idx_row = out_idx + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += kSelThreads) {
    const int idx = static_cast<int>(~static_cast<uint32_t>(list[i]));
    idx_row[i] = idx;
    val_row[i] = row[idx];
  }
}

}  // namespace

extern "C" size_t cluster_rank_smem_bytes(int K, int n) {
  return static_cast<size_t>(list_cap(K, n)) * sizeof(uint64_t);
}

// Segment maxima of a query: one per 8 clusters of a 128-cluster tile.
extern "C" int cluster_rank_segments(int K) {
  return (K + kTile - 1) / kTile * kSegs;
}

// u (B, d), e (K, d) fp32 row-major; scores (B, K) and segmax (B,
// cluster_rank_segments(K)) fp32 scratch -> out_val (B, n) fp32, out_idx
// (B, n) int32.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int cluster_rank_launch(const float* u, const float* e,
                                   float* scores, float* segmax,
                                   float* out_val, int* out_idx, int B,
                                   int K, int d, int n, cudaStream_t stream) {
  const int nseg = cluster_rank_segments(K);
  const dim3 grid((K + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  score_kernel<<<grid, kScoreThreads, 0, stream>>>(u, e, scores, segmax, B,
                                                   K, d, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cluster_rank_smem_bytes(K, n);
  err = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<B, kSelThreads, smem, stream>>>(scores, segmax, out_val,
                                                  out_idx, K, nseg, n);
  return static_cast<int>(cudaGetLastError());
}
