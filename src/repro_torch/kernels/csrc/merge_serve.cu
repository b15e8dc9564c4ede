// merge_serve: batched Alg. 1, the k-way chunked merge of the serve path.
//
// Replaces: src/repro/kernels/merge_serve.py, _merge_serve_kernel /
//   merge_serve_pallas (one grid step per query; head pointers carried
//   through a fori_loop; the wrapper compacts the chunked emissions).
//
// Bound on Hopper: not bytes.  The function needs only the C head biases,
//   the popped chunks and its (B, S) outputs (a few MB at the serve shape
//   B=512, C=128, L=256, chunk=8, S=512), but every pop depends on the
//   one before it: per query a chain of up to ceil(S/chunk)+C block-wide
//   argmax reductions.  Latency of that chain bounds it.
//
// Design: one block per query, one thread per cluster (C <= 1024).  Each
//   thread keeps its cluster's pointer and head score in registers, and
//   the biases one and two chunks ahead, loaded early, so a pop seldom
//   waits on device memory.  A pop is a warp-shuffle argmax of (score
//   desc, cluster asc; NaN counts as the maximum, as argmax does), a
//   second one over the warp winners, and two block barriers; one thread
//   records the pop (cluster, pointer, output offset) in shared memory.
//   No item is read or written inside the loop, which stops once S items
//   are out (no later pop can emit).  After it, one thread per output
//   slot finds its pop by binary search over the offsets and writes
//   pos = c*L + idx and score = cs_c + bias: the compacted output
//   directly, since the valid items of a pop are a prefix of its chunk.
//   The score is the same fp32 add as the reference's, so the result is
//   bitwise equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 1024;
constexpr float kNeg = -1e30f;
constexpr int kNoCluster = 0x7fffffff;

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

struct PopRecord {
  int cluster;  // popped cluster
  int base;     // its pointer before the pop
  int offset;   // first output slot of the pop's items
};

__global__ void merge_serve_kernel(const float* __restrict__ cs,
                                   const float* __restrict__ bias,
                                   const int* __restrict__ lengths,
                                   int* __restrict__ out_pos,
                                   float* __restrict__ out_sc, int C, int L,
                                   int chunk, int target, int n_steps) {
  extern __shared__ PopRecord s_rec[];  // min(n_steps, target) records
  __shared__ int s_len[kMaxC];
  __shared__ float s_cs[kMaxC];
  __shared__ int s_ptr[kMaxC];
  __shared__ float s_wv[32];
  __shared__ int s_wi[32];
  __shared__ int s_best, s_nout, s_nrec;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const bool active = tid < C;
  const float* rows = bias + static_cast<size_t>(b) * C * L;
  const float* row = rows + static_cast<size_t>(tid) * L;

  // head bias and the heads one and two chunks ahead, loaded early
  float my_cs = 0.f, head_b = 0.f, next1 = 0.f, next2 = 0.f;
  int my_len = 0, ptr = 0;
  if (active) {
    my_cs = cs[static_cast<size_t>(b) * C + tid];
    my_len = lengths[static_cast<size_t>(b) * C + tid];
    head_b = row[0];
    next1 = row[min(chunk, L - 1)];
    next2 = row[min(2 * chunk, L - 1)];
    s_len[tid] = my_len;
    s_cs[tid] = my_cs;
    s_ptr[tid] = 0;
  }
  if (tid == 0) {
    s_nout = 0;
    s_nrec = 0;
  }
  // lanes past C never win: -inf loses to every head, ties go to lower ids
  float head_s = active ? (ptr < my_len ? my_cs + head_b : kNeg) : -INFINITY;
  __syncthreads();

  // Pop loop: only the argmax and the bookkeeping of each pop are on the
  // dependent chain; the popped items are written after the loop.
  int n_out = 0;
  for (int t = 0; t < n_steps && n_out < target; ++t) {
    float v = head_s;
    int i = active ? tid : kNoCluster;
    warp_argmax(v, i);
    if (lane == 0) {
      s_wv[warp] = v;
      s_wi[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < n_warps ? s_wv[lane] : -INFINITY;
      i = lane < n_warps ? s_wi[lane] : kNoCluster;
      warp_argmax(v, i);
      if (lane == 0) {
        const int base = s_ptr[i];
        s_ptr[i] = base + chunk;
        s_best = i;
        const int cnt = v > kNeg / 2 ? max(0, min(chunk, s_len[i] - base)) : 0;
        if (cnt > 0) {
          s_rec[s_nrec++] = PopRecord{i, base, s_nout};
          s_nout += cnt;
        }
      }
    }
    __syncthreads();
    n_out = s_nout;
    if (tid == s_best) {
      ptr += chunk;
      head_b = next1;
      next1 = next2;
      next2 = row[min(ptr + 2 * chunk, L - 1)];
      head_s = ptr < my_len ? my_cs + head_b : kNeg;
    }
  }

  // Emit: output slot o belongs to the last pop whose offset is <= o
  // (offsets strictly increase, each pop emits at least one item).
  const int n_rec = s_nrec, n_valid = min(n_out, target);
  int* pos_row = out_pos + static_cast<size_t>(b) * target;
  float* sc_row = out_sc + static_cast<size_t>(b) * target;
  for (int o = tid; o < target; o += blockDim.x) {
    if (o >= n_valid) {
      pos_row[o] = -1;
      sc_row[o] = kNeg;
      continue;
    }
    int lo = 0, hi = n_rec - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_rec[mid].offset <= o) lo = mid; else hi = mid - 1;
    }
    const PopRecord r = s_rec[lo];
    const int idx = r.base + (o - r.offset);
    pos_row[o] = r.cluster * L + idx;
    sc_row[o] = s_cs[r.cluster] + rows[static_cast<size_t>(r.cluster) * L +
                                       min(idx, L - 1)];
  }
}

}  // namespace

extern "C" size_t merge_serve_smem_bytes(int target, int n_steps) {
  return static_cast<size_t>(min(target, n_steps)) * sizeof(PopRecord);
}

// cs (B, C) fp32, bias (B, C, L) fp32, lengths (B, C) int32 ->
// out_pos (B, target) int32, out_sc (B, target) fp32.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int merge_serve_launch(const float* cs, const float* bias,
                                  const int* lengths, int* out_pos,
                                  float* out_sc, int B, int C, int L,
                                  int chunk, int target, int n_steps,
                                  cudaStream_t stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = merge_serve_smem_bytes(target, n_steps);
  cudaError_t err = cudaFuncSetAttribute(
      merge_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_serve_kernel<<<B, threads, smem, stream>>>(cs, bias, lengths, out_pos,
                                                   out_sc, C, L, chunk, target,
                                                   n_steps);
  return static_cast<int>(cudaGetLastError());
}
