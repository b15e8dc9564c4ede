// fused_gather_rank: the batched Alg. 1 merge fused with the candidate
// gather and the exact Eq. 11 score, over the flat serving-index arrays.
//
// Replaces: src/repro/kernels/merge_serve.py, _fused_gather_rank_kernel /
//   fused_gather_rank_pallas (one grid step per query; each pop reads an
//   aligned chunk window of the flat bias / ids / emb arrays with pl.ds
//   and realigns its lanes with a one-hot select, then scores the chunk
//   against u).
//
// Bound on Hopper: bytes, in principle: per output slot one bias, one id
//   and one d-float embedding row gathered from the flat index (about
//   69 MB at the serve shape B=512, S=512, d=64), against next to no
//   arithmetic.  In practice the pop loop's dependent chain of block-wide
//   argmax reductions (see merge_serve.cu) comes first.
//
// Design: the pop loop of merge_pop.cuh, with the heads and their
//   prefetches read from the flat bias array at min(start_c + ptr,
//   limit_c) instead of from a (C, L) slab.  The loop only records its
//   pops.  After it, one thread per output slot finds its pop by binary
//   search, and gathers from the lane's address a = min(start_c + idx,
//   limit_c): pos = c*L + idx, merge score = cs_c + bias[a] (the
//   reference's single fp32 add: bitwise), cand id = ids[a], and exact
//   score = dot(emb[a], u) + bias[a], summed over d as ordered fp32 FMAs
//   (u staged in shared memory; no TF32).  Slots past the valid items get
//   (-1, NEG, id of the first lane's first slot, NEG), as in the
//   reference.  The TPU kernel's aligned window and one-hot realignment
//   are a VMEM device and are not carried over: a thread reads its lane's
//   address directly, so no padding is needed for N < chunk either.
//   Addresses are also clamped into [0, N), so a limit past the arrays
//   cannot read out of bounds.

#include "merge_pop.cuh"

#include <stdint.h>

namespace {

using merge_pop::PopRecord;
using merge_pop::PopShared;

// The lane address min(start + i, limit), kept inside [0, n).
__device__ __forceinline__ long long lane_addr(int start, int limit, int i,
                                               long long n) {
  long long a = static_cast<long long>(start) + i;
  a = min(a, static_cast<long long>(limit));
  return max(0LL, min(a, n - 1));
}

__global__ void fused_gather_rank_kernel(
    const float* __restrict__ u, const float* __restrict__ cs,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    const int* __restrict__ limits, const float* __restrict__ bias,
    const int* __restrict__ ids, const float* __restrict__ emb,
    int* __restrict__ out_pos, float* __restrict__ out_sc,
    int* __restrict__ out_id, float* __restrict__ out_rk, int C, int L,
    int d, long long n, int chunk, int target, int n_steps) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  PopRecord* s_rec = reinterpret_cast<PopRecord*>(s_dyn);
  float* s_u = reinterpret_cast<float*>(
      s_dyn + merge_pop::records_bytes(target, n_steps));
  __shared__ PopShared sh;

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t q = static_cast<size_t>(b) * C;
  for (int k = tid; k < d; k += blockDim.x)
    s_u[k] = u[static_cast<size_t>(b) * d + k];

  float my_cs = 0.f;
  int my_len = 0, my_start = 0, my_limit = 0;
  if (tid < C) {
    my_cs = cs[q + tid];
    my_len = lengths[q + tid];
    my_start = starts[q + tid];
    my_limit = limits[q + tid];
  }
  const auto head = [&](int p) {
    return bias[lane_addr(my_start, my_limit, p, n)];
  };
  // run_pops ends in a barrier, so s_u is complete after it
  merge_pop::run_pops(sh, s_rec, C, my_cs, my_len, head, chunk, target,
                      n_steps);

  const int n_rec = sh.n_rec, n_valid = min(sh.n_out, target);
  const size_t out = static_cast<size_t>(b) * target;
  const int id_clip = ids[lane_addr(starts[q], limits[q], 0, n)];
  const bool vec4 = (d & 3) == 0;
  for (int o = tid; o < target; o += blockDim.x) {
    if (o >= n_valid) {
      out_pos[out + o] = -1;
      out_sc[out + o] = merge_pop::kNeg;
      out_id[out + o] = id_clip;
      out_rk[out + o] = merge_pop::kNeg;
      continue;
    }
    const PopRecord r = merge_pop::find_pop(s_rec, n_rec, o);
    const int idx = r.base + (o - r.offset);
    const long long a =
        lane_addr(starts[q + r.cluster], limits[q + r.cluster], idx, n);
    const float bv = bias[a];
    const float* row = emb + a * d;
    float acc = 0.f;
    if (vec4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int k = 0; k < d / 4; ++k) {
        const float4 e = __ldg(row4 + k);
        acc = fmaf(e.x, s_u[4 * k], acc);
        acc = fmaf(e.y, s_u[4 * k + 1], acc);
        acc = fmaf(e.z, s_u[4 * k + 2], acc);
        acc = fmaf(e.w, s_u[4 * k + 3], acc);
      }
    } else {
      for (int k = 0; k < d; ++k) acc = fmaf(__ldg(row + k), s_u[k], acc);
    }
    out_pos[out + o] = r.cluster * L + idx;
    out_sc[out + o] = sh.cs[r.cluster] + bv;
    out_id[out + o] = ids[a];
    out_rk[out + o] = acc + bv;
  }
}

size_t smem_bytes(int target, int n_steps, int d) {
  return merge_pop::records_bytes(target, n_steps) +
         static_cast<size_t>(d) * sizeof(float);
}

}  // namespace

extern "C" size_t fused_gather_rank_smem_bytes(int target, int n_steps,
                                               int d) {
  return smem_bytes(target, n_steps, d);
}

// u (B, d) fp32; cs (B, C) fp32; starts, lengths, limits (B, C) int32;
// bias (N,) fp32, ids (N,) int32, emb (N, d) fp32 ->
// out_pos (B, target) int32, out_sc (B, target) fp32, out_id (B, target)
// int32, out_rk (B, target) fp32.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fused_gather_rank_launch(
    const float* u, const float* cs, const int* starts, const int* lengths,
    const int* limits, const float* bias, const int* ids, const float* emb,
    int* out_pos, float* out_sc, int* out_id, float* out_rk, int B, int C,
    int L, int d, long long n, int chunk, int target, int n_steps,
    cudaStream_t stream) {
  if (C < 1 || C > merge_pop::kMaxC || L < 1 || d < 1 || n < 1 ||
      chunk < 1 || target < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = smem_bytes(target, n_steps, d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gather_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gather_rank_kernel<<<B, threads, smem, stream>>>(
      u, cs, starts, lengths, limits, bias, ids, emb, out_pos, out_sc, out_id,
      out_rk, C, L, d, n, chunk, target, n_steps);
  return static_cast<int>(cudaGetLastError());
}
