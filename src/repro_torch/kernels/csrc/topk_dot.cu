// topk_dot: per query, the top-k items of scores = items . u + bias.
//
// Replaces: src/repro/kernels/topk_dot.py, _topk_dot_kernel /
//   topk_dot_pallas (a sequential grid over 4,096-item blocks, each
//   emitting its local top-k, then one lax.top_k over the partials).
//
// Bound on Hopper: at retrieval_cand (B=1, N=1,000,000, d=64, k=512) the
//   function must read the 256 MB item table once: bound by bytes
//   (0.078 ms at 3.35 TB/s).  At the shadow-probe oracle (B=512,
//   N=2,097,152, d=64, k=20) it does 2*B*N*d = 137 GFLOP of fp32 FMAs:
//   bound by the fp32 pipes (2.05 ms at 67 TFLOP/s).
//
// Design: blocks run in no order and a (B, N) score buffer would take
//   4.3 GB at the probe shape, so nothing of that size is made.  A block
//   owns a tile of up to 16*RB queries and one contiguous range of items
//   (the "chunk"), which it walks in sub-tiles of 64 items in ascending
//   index order:
//   1. the 64 x d item tile (and its bias) is staged in shared memory,
//      its loads issued from registers a sub-tile ahead so they overlap
//      the scoring and folding of the current one; each thread
//      accumulates an RB x 4 micro-tile of scores with sequential fp32
//      FMAs over d (no TF32; the query tile stays in shared memory for
//      the whole chunk), adds the bias and leaves the (TB, 64) scores in
//      shared memory;
//   2. one warp per query row keeps the row's running top-k of the chunk
//      in shared memory, in ascending item order, and behind it a buffer
//      of admitted items.  A new item is admitted only if its score is
//      strictly above the running k-th score: the running entries all
//      come from lower indices, so a tie keeps the older item.  Most
//      32-item groups cost one vote.  When the buffer is full (and at
//      the chunk's end) a warp radix select (order-preserving uint32
//      keys, four 8-bit passes over a per-warp histogram with
//      warp-aggregated atomics, as in cluster_rank.cu) over the running
//      entries and the buffer finds the new k-th key, and an ordered
//      warp compaction keeps every key above it and the lowest-index
//      keys equal to it.  Ties therefore go to the lower index, as
//      lax.top_k's do.
//   The block writes the row's k entries as its partial: values, and
//   int64 sort keys holding the inverted order key above the global
//   index; the wrapper's second stage sorts the (B, chunks * k) keys, so
//   the result, (key desc, index asc), does not depend on the chunk
//   size.  A chunk with fewer than k items pads with the empty
//   key 0 (float bits 0xFFFFFFFF, index -1), below every finite score.
//   bf16 inputs: the wrapper upcasts them to fp32 (exact), so the kernel
//   has one fp32 body.  -0.0 and +0.0 share one key (they tie); inputs
//   are taken to be finite.  Addresses are int64; N < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 64;            // items per sub-tile
constexpr int kCols = kTN / 16;    // score columns a thread owns
constexpr int kSS = kTN + 4;       // score tile row stride
constexpr int kStage = 4;          // float4 loads a thread stages (d <= 64)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmptyBits = 0xffffffffu;   // key 0

using radix::order_key;

// The partial's sort key: ascending order is (score desc, index asc).
// The inverted order key sits above the 31-bit index; an empty entry
// (key 0, index -1) takes the largest.
__device__ __forceinline__ long long sort_key(float v, int idx) {
  const unsigned long long inv = 0xffffffffull - order_key(v);
  const unsigned long long i31 = idx < 0 ? 0x7fffffffull
                                         : static_cast<unsigned long long>(idx);
  return static_cast<long long>((inv << 31) | i31);
}

struct Smem {
  float* us;        // d x TB, transposed query tile
  float* ys;        // kTN x (d + 1), item tile
  float* bs;        // kTN, bias tile
  float* sc;        // TB x kSS, scores
  float* cand_val;  // rows x (k + cb): running top-k, then the buffer
  int* cand_idx;    // rows x (k + cb), global item indices
  uint32_t* thr;    // rows, running k-th key
  int* nbuf;        // rows, entries in the buffer
  unsigned* hist;   // kWarps x 256
};

// Entries a row's buffer of admitted items holds: k rounded up to a
// multiple of 32, at least 32, so a fold of running + buffer keeps at
// most half of its candidates.
__host__ __device__ inline int buffer_len(int k) {
  return ((k > 32 ? k : 32) + 31) / 32 * 32;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Carves `bytes` (16-byte aligned) off the layout at `*off`.
__host__ __device__ inline unsigned char* carve(unsigned char* base,
                                                size_t* off, size_t bytes) {
  unsigned char* p = base ? base + *off : nullptr;
  *off += align16(bytes);
  return p;
}

// The dynamic shared memory of a block with `tb` query rows, of which
// `rows` are kept (min(tb, B)); fills `s` when `base` is given.
__host__ __device__ inline size_t smem_layout(int tb, int rows, int d, int k,
                                              unsigned char* base,
                                              Smem* s) {
  const size_t width = static_cast<size_t>(k) + buffer_len(k);
  size_t off = 0;
  Smem t;
  t.us = reinterpret_cast<float*>(
      carve(base, &off, sizeof(float) * size_t(d) * tb));
  t.ys = reinterpret_cast<float*>(
      carve(base, &off, sizeof(float) * size_t(kTN) * (d + 1)));
  t.bs = reinterpret_cast<float*>(carve(base, &off, sizeof(float) * kTN));
  t.sc = reinterpret_cast<float*>(
      carve(base, &off, sizeof(float) * size_t(tb) * kSS));
  t.cand_val = reinterpret_cast<float*>(
      carve(base, &off, sizeof(float) * rows * width));
  t.cand_idx = reinterpret_cast<int*>(
      carve(base, &off, sizeof(int) * rows * width));
  t.thr = reinterpret_cast<uint32_t*>(
      carve(base, &off, sizeof(uint32_t) * rows));
  t.nbuf = reinterpret_cast<int*>(carve(base, &off, sizeof(int) * rows));
  t.hist = reinterpret_cast<unsigned*>(
      carve(base, &off, sizeof(unsigned) * kWarps * 256));
  if (s) *s = t;
  return off;
}

// One warp: the top-k of a row's k running entries and its `nb` buffered
// ones (cv/ci[0, k + nb), in ascending index order) into cv/ci[0, k),
// still in ascending index order.  -> the new k-th key.
__device__ uint32_t warp_select(float* cv, int* ci, int k, int nb,
                                unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const int n_cand = k + nb;
  __syncwarp();
  uint32_t prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int base = 0; base < n_cand; base += 32) {
      const int p = base + lane;
      const uint32_t key = p < n_cand ? order_key(cv[p]) : 0u;
      const bool in = p < n_cand && (key & mask) == prefix;
      const unsigned bin = in ? (key >> shift) & 255u : 256u;
      // lanes with the same bin add once, through their lowest lane
      const unsigned peers = __match_any_sync(kFull, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncwarp();
    int digit;
    unsigned above;
    radix::find_digit(hist, static_cast<unsigned>(remaining), &digit,
                      &above);
    prefix |= static_cast<uint32_t>(digit) << shift;
    remaining -= static_cast<int>(above);
    mask |= 255u << shift;
    __syncwarp();
  }
  const uint32_t kth = prefix;

  // Ordered compaction: take every key above the k-th and the
  // `remaining` lowest-position keys equal to it.  Position order is
  // index order, so ties go to the lower index.  A taken entry moves to
  // a slot <= its position, and every lane reads its 32 positions before
  // any lane writes.
  const unsigned lt = (1u << lane) - 1u;
  int taken = 0, ties = 0;
  for (int base = 0; base < n_cand; base += 32) {
    const int p = base + lane;
    float v = 0.f;
    int id = -1;
    uint32_t key = 0;
    if (p < n_cand) {
      v = cv[p];
      id = ci[p];
      key = order_key(v);
    }
    const bool eq = p < n_cand && key == kth;
    const unsigned eqb = __ballot_sync(kFull, eq);
    const bool take = (p < n_cand && key > kth) ||
                      (eq && ties + __popc(eqb & lt) < remaining);
    const unsigned tb = __ballot_sync(kFull, take);
    const int slot = taken + __popc(tb & lt);
    __syncwarp();
    if (take) {
      cv[slot] = v;
      ci[slot] = id;
    }
    taken += __popc(tb);
    ties += __popc(eqb);
  }
  __syncwarp();
  return kth;
}

// One warp: append the items of the score row `srow` (global indices
// t0 + p) whose key is above the running k-th key to the row's buffer,
// in index order; a full buffer is first folded into the running top-k.
// A skipped item cannot enter: the running entries all have lower
// indices, so a tie keeps the older one.
__device__ void warp_admit(const float* srow, long long t0, float* cv,
                           int* ci, uint32_t* thr, int* nbuf,
                           unsigned* hist, int k) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int cb = buffer_len(k);
  uint32_t T = *thr;
  int nb = *nbuf;
  for (int c = 0; c < kTN; c += 32) {
    const float v = srow[c + lane];
    const uint32_t key = order_key(v);
    unsigned adm = __ballot_sync(kFull, key > T);
    if (!adm) continue;
    if (nb + __popc(adm) > cb) {
      T = warp_select(cv, ci, k, nb, hist);
      nb = 0;
      adm = __ballot_sync(kFull, key > T);
    }
    if (key > T) {
      const int pos = k + nb + __popc(adm & lt);
      cv[pos] = v;
      ci[pos] = static_cast<int>(t0 + c + lane);
    }
    nb += __popc(adm);
  }
  __syncwarp();
  if (lane == 0) {
    *thr = T;
    *nbuf = nb;
  }
  __syncwarp();
}

// The item tile of the sub-tile at t0 (n items) as float4 loads, one
// register stage a thread, issued together: lane i of the block loads
// the 16 bytes at i, i + 256, ... of the tile, and the bias of item tid.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ items,
                                           const float* __restrict__ bias,
                                           long long t0, int n, int d,
                                           float4 (&st)[kStage], float& bst) {
  const int d4 = d >> 2;
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < n * d4)
      st[q] = __ldg(reinterpret_cast<const float4*>(
          items + (t0 + i / d4) * d + (i % d4) * 4));
  }
  if (static_cast<int>(threadIdx.x) < n) bst = __ldg(bias + t0 + threadIdx.x);
}

__device__ __forceinline__ void store_tile(const float4 (&st)[kStage],
                                           float bst, int n, int d,
                                           float* ys, float* bs) {
  const int d4 = d >> 2;
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < n * d4) {
      float* dst = ys + (i / d4) * (d + 1) + (i % d4) * 4;
      dst[0] = st[q].x;
      dst[1] = st[q].y;
      dst[2] = st[q].z;
      dst[3] = st[q].w;
    }
  }
  if (static_cast<int>(threadIdx.x) < kTN)
    bs[threadIdx.x] = static_cast<int>(threadIdx.x) < n ? bst : 0.f;
}

// Blocks an SM is to hold: 2 of the 64-query kernel (its shared
// memory allows 2), 4 of the 16-query one, whose few queries make it
// bound by the loads, which more resident blocks overlap.
template <int RB>
__global__ void __launch_bounds__(kThreads, RB == 1 ? 4 : 2)
topk_dot_kernel(const float* __restrict__ u, const float* __restrict__ items,
                const float* __restrict__ bias, float* __restrict__ part_val,
                long long* __restrict__ part_key, int B, long long N, int d,
                int k,
                long long chunk, int n_chunks, int rows_alloc) {
  constexpr int TB = 16 * RB;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s;
  smem_layout(TB, rows_alloc, d, k, smem, &s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TB;
  const int rows = min(TB, B - q0);
  const long long lo = static_cast<long long>(blockIdx.y) * chunk;
  const long long hi = min(N, lo + chunk);

  for (int i = tid; i < TB * d; i += kThreads) {
    const int r = i % TB, j = i / TB;
    s.us[j * TB + r] = r < rows ? u[static_cast<long long>(q0 + r) * d + j]
                                : 0.f;
  }
  const int width = k + buffer_len(k);
  for (int r = warp; r < rows; r += kWarps)
    for (int i = lane; i < k; i += 32) {
      s.cand_val[r * width + i] = __uint_as_float(kEmptyBits);
      s.cand_idx[r * width + i] = -1;
    }
  for (int i = tid; i < rows; i += kThreads) {
    s.thr[i] = 0u;
    s.nbuf[i] = 0;
  }

  // Staged path: the next sub-tile's loads are in flight in registers
  // while this one is scored and folded.  Otherwise plain loads.
  const bool staged = (d & 3) == 0 && d <= 4 * kStage * kThreads / kTN &&
                      (reinterpret_cast<uintptr_t>(items) & 15) == 0;
  float4 st[kStage];
  float bst = 0.f;
  if (staged && lo < hi)
    fetch_tile(items, bias, lo, static_cast<int>(min(static_cast<long long>(
        kTN), hi - lo)), d, st, bst);
  for (long long t0 = lo; t0 < hi; t0 += kTN) {
    const int n_here = static_cast<int>(min(static_cast<long long>(kTN),
                                            hi - t0));
    __syncthreads();   // the previous sub-tile is scored and folded
    if (staged) {
      store_tile(st, bst, n_here, d, s.ys, s.bs);
    } else {
      for (int i = tid; i < n_here * d; i += kThreads)
        s.ys[(i / d) * (d + 1) + i % d] = items[t0 * d + i];
      if (tid < kTN) s.bs[tid] = tid < n_here ? bias[t0 + tid] : 0.f;
    }
    __syncthreads();
    if (staged && t0 + kTN < hi)
      fetch_tile(items, bias, t0 + kTN, static_cast<int>(min(
          static_cast<long long>(kTN), hi - t0 - kTN)), d, st, bst);

    float acc[RB][kCols];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    const float* yc = s.ys + tx * (d + 1);
    const int ystep = 16 * (d + 1);
    for (int j = 0; j < d; ++j) {
      float av[RB];
      if constexpr (RB == 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            &s.us[j * TB + 4 * ty]);
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else {
#pragma unroll
        for (int i = 0; i < RB; ++i) av[i] = s.us[j * TB + RB * ty + i];
      }
      float bv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) bv[q] = yc[q * ystep + j];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = tx + 16 * q;
        s.sc[(RB * ty + i) * kSS + c] =
            c < n_here ? acc[i][q] + s.bs[c] : __uint_as_float(kEmptyBits);
      }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps)
      warp_admit(s.sc + r * kSS, t0, s.cand_val + r * width,
                 s.cand_idx + r * width, s.thr + r, s.nbuf + r,
                 s.hist + warp * 256, k);
  }
  // each row's last fold and its partial, by the warp that owns the row
  for (int r = warp; r < rows; r += kWarps) {
    float* cv = s.cand_val + r * width;
    int* ci = s.cand_idx + r * width;
    if (s.nbuf[r] > 0) warp_select(cv, ci, k, s.nbuf[r], s.hist + warp * 256);
    const long long out = (static_cast<long long>(q0 + r) * n_chunks +
                           blockIdx.y) * k;
    for (int i = lane; i < k; i += 32) {
      part_val[out + i] = cv[i];
      part_key[out + i] = sort_key(cv[i], ci[i]);
    }
  }
}

}  // namespace

extern "C" size_t topk_dot_smem_bytes(int rows_per_thread, int B, int d,
                                      int k) {
  const int tb = 16 * rows_per_thread;
  return smem_layout(tb, B < tb ? B : tb, d, k, nullptr, nullptr);
}

// u (B, d), items (N, d), bias (N,) fp32 row-major -> partials
// part_val (B, n_chunks, k) fp32 and their sort keys part_key (B,
// n_chunks, k) int64, chunk = items per block (a multiple of 64).
// Returns the CUDA error code (0 on success).
extern "C" int topk_dot_launch(const float* u, const float* items,
                               const float* bias, float* part_val,
                               long long* part_key, int B, long long N,
                               int d, int k, long long chunk, int n_chunks,
                               int rows_per_thread, cudaStream_t stream) {
  const int tb = 16 * rows_per_thread;
  const int rows_alloc = B < tb ? B : tb;
  const size_t smem = smem_layout(tb, rows_alloc, d, k, nullptr, nullptr);
  const dim3 grid((B + tb - 1) / tb, n_chunks);
  cudaError_t err;
  if (rows_per_thread == 4) {
    err = cudaFuncSetAttribute(topk_dot_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_dot_kernel<4><<<grid, kThreads, smem, stream>>>(
        u, items, bias, part_val, part_key, B, N, d, k, chunk, n_chunks,
        rows_alloc);
  } else if (rows_per_thread == 1) {
    err = cudaFuncSetAttribute(topk_dot_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_dot_kernel<1><<<grid, kThreads, smem, stream>>>(
        u, items, bias, part_val, part_key, B, N, d, k, chunk, n_chunks,
        rows_alloc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
