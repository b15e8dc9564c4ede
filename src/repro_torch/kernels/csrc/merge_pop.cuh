// merge_pop.cuh: the pop loop of the batched Alg. 1 merge, shared by
// merge_serve.cu (merge_serve and merge_serve_ds) and fused_gather_rank.cu.
//
// One block per query, one thread per cluster (C <= 1024).  Each thread
// keeps its cluster's pointer and head score in registers, and the biases
// one and two chunks ahead, loaded early, so a pop seldom waits on device
// memory.  A pop is a warp-shuffle argmax of (score desc, cluster asc; NaN
// counts as the maximum, as argmax does), a second one over the warp
// winners, and two block barriers; one thread records the pop (cluster,
// pointer, output offset) in shared memory.  No item is read or written
// inside the loop, which stops once `target` items are out (no later pop
// can emit).  The caller emits the items after the loop: output slot o
// belongs to the last recorded pop whose offset is <= o (`find_pop`),
// since the valid items of a pop are a prefix of its chunk.
//
// The kernels differ only in where a cluster's biases come from, so the
// loop takes the head read as a functor: `head(p)` is the bias at pointer
// p of the calling thread's cluster (clamped by the caller).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace merge_pop {

constexpr int kMaxC = 1024;
constexpr float kNeg = -1e30f;
constexpr int kNoCluster = 0x7fffffff;

struct PopRecord {
  int cluster;  // popped cluster
  int base;     // its pointer before the pop
  int offset;   // first output slot of the pop's items
};

// Per-block state of the loop, in static shared memory.
struct PopShared {
  int len[kMaxC];
  float cs[kMaxC];
  int ptr[kMaxC];
  float wv[32];
  int wi[32];
  int best, n_out, n_rec;
};

// Bytes of dynamic shared memory for the pop records: at most one record
// per pop, and a recorded pop emits at least one of the `target` items.
__host__ __device__ inline size_t records_bytes(int target, int n_steps) {
  return static_cast<size_t>(target < n_steps ? target : n_steps) *
         sizeof(PopRecord);
}

// True when (a, ia) comes before (b, ib) in argmax order.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Runs the pops of the block's query.  Every thread of the block calls it;
// thread tid < C owns cluster tid with score `my_cs` and `my_len` items.
// On return (after a barrier) rec[0, sh.n_rec) holds the pops that emitted
// and sh.n_out the items they emitted (it may exceed target: the last pop
// emits its whole valid chunk).
template <class Head>
__device__ void run_pops(PopShared& sh, PopRecord* rec, int C, float my_cs,
                         int my_len, const Head& head, int chunk, int target,
                         int n_steps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const bool active = tid < C;

  float head_b = 0.f, next1 = 0.f, next2 = 0.f;
  int ptr = 0;
  if (active) {
    head_b = head(0);
    next1 = head(chunk);
    next2 = head(2 * chunk);
    sh.len[tid] = my_len;
    sh.cs[tid] = my_cs;
    sh.ptr[tid] = 0;
  }
  if (tid == 0) {
    sh.n_out = 0;
    sh.n_rec = 0;
  }
  // lanes past C never win: -inf loses to every head, ties go to lower ids
  float head_s = active ? (ptr < my_len ? my_cs + head_b : kNeg) : -INFINITY;
  __syncthreads();

  int n_out = 0;
  for (int t = 0; t < n_steps && n_out < target; ++t) {
    float v = head_s;
    int i = active ? tid : kNoCluster;
    warp_argmax(v, i);
    if (lane == 0) {
      sh.wv[warp] = v;
      sh.wi[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < n_warps ? sh.wv[lane] : -INFINITY;
      i = lane < n_warps ? sh.wi[lane] : kNoCluster;
      warp_argmax(v, i);
      if (lane == 0) {
        const int base = sh.ptr[i];
        sh.ptr[i] = base + chunk;
        sh.best = i;
        const int cnt = v > kNeg / 2 ? max(0, min(chunk, sh.len[i] - base)) : 0;
        if (cnt > 0) {
          rec[sh.n_rec++] = PopRecord{i, base, sh.n_out};
          sh.n_out += cnt;
        }
      }
    }
    __syncthreads();
    n_out = sh.n_out;
    if (tid == sh.best) {
      ptr += chunk;
      head_b = next1;
      next1 = next2;
      next2 = head(ptr + 2 * chunk);
      head_s = ptr < my_len ? my_cs + head_b : kNeg;
    }
  }
  __syncthreads();
}

// The pop that emitted output slot o < n_out: the last record whose
// offset is <= o (offsets strictly increase).
__device__ __forceinline__ PopRecord find_pop(const PopRecord* rec, int n_rec,
                                              int o) {
  int lo = 0, hi = n_rec - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rec[mid].offset <= o) lo = mid; else hi = mid - 1;
  }
  return rec[lo];
}

}  // namespace merge_pop
