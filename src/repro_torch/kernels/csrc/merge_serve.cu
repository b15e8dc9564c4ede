// merge_serve and merge_serve_ds: batched Alg. 1, the k-way chunked merge
// of the serve path, over (B, C, L) bias slabs.
//
// Replaces: src/repro/kernels/merge_serve.py, _merge_serve_kernel /
//   merge_serve_pallas (one grid step per query; head pointers carried
//   through a fori_loop; the wrapper compacts the chunked emissions), and
//   _merge_serve_ds_kernel / merge_serve_ds_pallas (the same merge, with
//   dynamic-slice reads instead of masked scans).
//
// Why the two share a body here: on the TPU the difference is how a pop
//   reads its cluster's head and chunk: iota-mask reductions over the
//   whole (C, L) slab (O(C*L) vector work a pop) against dynamic slices
//   (O(C + chunk^2)).  On Hopper a thread reads any address directly, so
//   the loop below already does O(1) work a pop outside the C-wide argmax,
//   and there is nothing left to choose between.  merge_serve_ds_kernel
//   is its own launch, with its own counter in the wrapper, over the same
//   body; its outputs are the same bits by contract, as in the reference.
//   The reference's ds wrapper pads L up to chunk for its window reads;
//   this body clamps reads at L - 1 and needs no padding.
//
// Bound on Hopper: not bytes.  The function needs only the C head biases,
//   the popped chunks and its (B, S) outputs (a few MB at the serve shape
//   B=512, C=128, L=256, chunk=8, S=512), but every pop depends on the
//   one before it: per query a chain of up to ceil(S/chunk)+C block-wide
//   argmax reductions.  Latency of that chain bounds it.
//
// Design: the pop loop of merge_pop.cuh (one block per query, one thread
//   per cluster, heads prefetched two chunks ahead, no item touched in the
//   loop).  After it, one thread per output slot finds its pop by binary
//   search over the offsets and writes pos = c*L + idx and score =
//   cs_c + bias: the compacted output directly.  The score is the same
//   fp32 add as the reference's, so the result is bitwise equal to it.

#include "merge_pop.cuh"

#include <stdint.h>

namespace {

using merge_pop::PopRecord;
using merge_pop::PopShared;

__device__ __forceinline__ void merge_serve_block(
    const float* __restrict__ cs, const float* __restrict__ bias,
    const int* __restrict__ lengths, int* __restrict__ out_pos,
    float* __restrict__ out_sc, int C, int L, int chunk, int target,
    int n_steps, PopShared& sh, PopRecord* s_rec) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* rows = bias + static_cast<size_t>(b) * C * L;
  const float* row = rows + static_cast<size_t>(tid) * L;
  float my_cs = 0.f;
  int my_len = 0;
  if (tid < C) {
    my_cs = cs[static_cast<size_t>(b) * C + tid];
    my_len = lengths[static_cast<size_t>(b) * C + tid];
  }
  const auto head = [&](int p) { return row[min(p, L - 1)]; };
  merge_pop::run_pops(sh, s_rec, C, my_cs, my_len, head, chunk, target,
                      n_steps);

  const int n_rec = sh.n_rec, n_valid = min(sh.n_out, target);
  int* pos_row = out_pos + static_cast<size_t>(b) * target;
  float* sc_row = out_sc + static_cast<size_t>(b) * target;
  for (int o = tid; o < target; o += blockDim.x) {
    if (o >= n_valid) {
      pos_row[o] = -1;
      sc_row[o] = merge_pop::kNeg;
      continue;
    }
    const PopRecord r = merge_pop::find_pop(s_rec, n_rec, o);
    const int idx = r.base + (o - r.offset);
    pos_row[o] = r.cluster * L + idx;
    sc_row[o] = sh.cs[r.cluster] + rows[static_cast<size_t>(r.cluster) * L +
                                        min(idx, L - 1)];
  }
}

__global__ void merge_serve_kernel(const float* __restrict__ cs,
                                   const float* __restrict__ bias,
                                   const int* __restrict__ lengths,
                                   int* __restrict__ out_pos,
                                   float* __restrict__ out_sc, int C, int L,
                                   int chunk, int target, int n_steps) {
  extern __shared__ PopRecord s_rec[];  // min(n_steps, target) records
  __shared__ PopShared sh;
  merge_serve_block(cs, bias, lengths, out_pos, out_sc, C, L, chunk, target,
                    n_steps, sh, s_rec);
}

__global__ void merge_serve_ds_kernel(const float* __restrict__ cs,
                                      const float* __restrict__ bias,
                                      const int* __restrict__ lengths,
                                      int* __restrict__ out_pos,
                                      float* __restrict__ out_sc, int C,
                                      int L, int chunk, int target,
                                      int n_steps) {
  extern __shared__ PopRecord s_rec_ds[];
  __shared__ PopShared sh;
  merge_serve_block(cs, bias, lengths, out_pos, out_sc, C, L, chunk, target,
                    n_steps, sh, s_rec_ds);
}

using Kernel = void (*)(const float*, const float*, const int*, int*, float*,
                        int, int, int, int, int);

int launch(Kernel kernel, const float* cs, const float* bias,
           const int* lengths, int* out_pos, float* out_sc, int B, int C,
           int L, int chunk, int target, int n_steps, cudaStream_t stream) {
  if (C < 1 || C > merge_pop::kMaxC || L < 1 || chunk < 1 || target < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = merge_pop::records_bytes(target, n_steps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(cs, bias, lengths, out_pos, out_sc, C,
                                       L, chunk, target, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t merge_serve_smem_bytes(int target, int n_steps) {
  return merge_pop::records_bytes(target, n_steps);
}

extern "C" size_t merge_serve_ds_smem_bytes(int target, int n_steps) {
  return merge_pop::records_bytes(target, n_steps);
}

// cs (B, C) fp32, bias (B, C, L) fp32, lengths (B, C) int32 ->
// out_pos (B, target) int32, out_sc (B, target) fp32.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int merge_serve_launch(const float* cs, const float* bias,
                                  const int* lengths, int* out_pos,
                                  float* out_sc, int B, int C, int L,
                                  int chunk, int target, int n_steps,
                                  cudaStream_t stream) {
  return launch(merge_serve_kernel, cs, bias, lengths, out_pos, out_sc, B, C,
                L, chunk, target, n_steps, stream);
}

// The same arguments and the same bits as merge_serve_launch.
extern "C" int merge_serve_ds_launch(const float* cs, const float* bias,
                                     const int* lengths, int* out_pos,
                                     float* out_sc, int B, int C, int L,
                                     int chunk, int target, int n_steps,
                                     cudaStream_t stream) {
  return launch(merge_serve_ds_kernel, cs, bias, lengths, out_pos, out_sc, B,
                C, L, chunk, target, n_steps, stream);
}
