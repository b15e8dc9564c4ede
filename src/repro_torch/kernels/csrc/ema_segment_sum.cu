// ema_segment_sum: the per-cluster batch sums of the streaming EMA update
// (Eq. 7-8 / Eq. 12-13),
//   w_add[k] = sum_{j: a_j = k} wt_j * v_j    (K, d)
//   c_add[k] = sum_{j: a_j = k} wt_j          (K,)
// Rows assigned outside [0, K) contribute nothing.
//
// Replaces: src/repro/kernels/vq_ema.py, _ema_segment_kernel /
//   ema_segment_sum_pallas (a one-hot (bB, K) matmul per batch block,
//   accumulated into a (K, d) output carried across the sequential grid).
//
// Bound on Hopper: at the train shape (B=65536, K=16384, d=64) the
//   function does about 4 M multiply-adds and must move about 20.5 MB (v,
//   a, wt and the outputs), so it is bound by device memory: about 6 us at
//   3.35 TB/s.  The one-hot matmul of the TPU would turn that into
//   2*B*K*d = 137 GFLOP, so it is not carried over.
//
// Design: deterministic, no float atomics: two launches on the same inputs
//   are bitwise equal.  Two kernels:
//   1. segment_kernel: block (t, s) owns a tile of 128 clusters and one
//      of kSlices = 16 slices of the rows, and keeps the tile's sums in
//      shared memory.  It walks its slice of the assignment array in row
//      order, 256 rows a step (the next step's ids prefetched into
//      registers), and compacts the rows that fall in its tile, in row
//      order, with a warp ballot and an ordered block scan.  Each cluster
//      of the tile belongs to one group of threads, which adds that
//      cluster's rows in row order, one thread per dimension (coalesced
//      reads of v).  The tile's partial sums go to a (kSlices, K, d)
//      scratch buffer.  Each v row is read by exactly one block.
//   2. combine_kernel adds the kSlices partials of each output in slice
//      order.
//   Adding a cluster's rows one after another is a dependent chain; the
//   slices cut the chain of a hot cluster 16-fold, which matters because
//   assignments are skewed (early in training a few dozen clusters take
//   a whole batch).  The price is the scratch: 16 * K * (d + 1) floats
//   written and read once (68 MB each way at the train shape, about 40 us
//   at 3.35 TB/s), about 6x the function's own bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kTileK = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 16;

// w_part (kSlices, K, d), c_part (kSlices, K): the sums of slice
// blockIdx.y of the rows, for the clusters of tile blockIdx.x
__global__ void __launch_bounds__(kThreads)
segment_kernel(const float* __restrict__ v, const int* __restrict__ a,
               const float* __restrict__ wt, float* __restrict__ w_part,
               float* __restrict__ c_part, int B, int K, int d) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                  // (kTileK, d)
  float* c_s = w_s + kTileK * d;                      // (kTileK,)
  int* row_l = reinterpret_cast<int*>(c_s + kTileK);  // compacted rows
  int* k_l = row_l + kThreads;                        // their tile cluster
  int* warp_n = k_l + kThreads;                       // (kWarps,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kTileK;
  const int nk = min(kTileK, K - k0);
  const int per_slice = (B + kSlices - 1) / kSlices;
  const int lo = blockIdx.y * per_slice;
  const int hi = min(B, lo + per_slice);
  // groups of gsize threads (a power of two >= d, at most kThreads); the
  // tile's cluster c belongs to group c % n_groups
  int gsize = 32;
  while (gsize < d && gsize < kThreads) gsize <<= 1;
  const int n_groups = kThreads / gsize;
  const int group = tid / gsize, glane = tid % gsize;

  for (int i = tid; i < kTileK * d; i += kThreads) w_s[i] = 0.f;
  if (tid < kTileK) c_s[tid] = 0.f;

  int k_next = lo + tid < hi ? a[lo + tid] : -1;
  for (int base = lo; base < hi; base += kThreads) {
    const int row = base + tid;
    const int k = k_next;
    k_next = row + kThreads < hi ? a[row + kThreads] : -1;
    const bool hit = k >= k0 && k < k0 + nk;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();  // also: the previous step's lists are consumed
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (hit) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      row_l[pos] = row;
      k_l[pos] = k - k0;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const int c = k_l[i];
      if (c % n_groups != group) continue;
      const int r = row_l[i];
      const float w = wt[r];
      const float* vr = v + static_cast<size_t>(r) * d;
      float* ws = w_s + c * d;
      for (int j = glane; j < d; j += gsize)
        ws[j] = __fadd_rn(ws[j], __fmul_rn(w, vr[j]));
      if (glane == 0) c_s[c] = __fadd_rn(c_s[c], w);
    }
    __syncthreads();  // warp_n is rewritten by the next step
  }
  const size_t part = static_cast<size_t>(blockIdx.y) * K + k0;
  for (int i = tid; i < nk * d; i += kThreads) w_part[part * d + i] = w_s[i];
  if (tid < nk) c_part[part + tid] = c_s[tid];
}

// out[i] = sum over s of part[s * n + i], in slice order; w then c
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ w_part,
               const float* __restrict__ c_part, float* __restrict__ w_add,
               float* __restrict__ c_add, int K, int d) {
  const size_t nw = static_cast<size_t>(K) * d;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nw + K) return;
  const bool is_w = i < nw;
  const float* part = is_w ? w_part + i : c_part + (i - nw);
  const size_t stride = is_w ? nw : K;
  float s = 0.f;
  for (int t = 0; t < kSlices; ++t) s = __fadd_rn(s, part[t * stride]);
  if (is_w)
    w_add[i] = s;
  else
    c_add[i - nw] = s;
}

}  // namespace

extern "C" int ema_segment_sum_slices() { return kSlices; }

extern "C" size_t ema_segment_sum_smem_bytes(int d) {
  return static_cast<size_t>(kTileK) * (d + 1) * sizeof(float) +
         (2 * kThreads + kWarps) * sizeof(int);
}

// v (B, d) fp32, a (B,) int32, wt (B,) fp32; scratch w_part (16, K, d),
// c_part (16, K) -> w_add (K, d), c_add (K,) fp32.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int ema_segment_sum_launch(const float* v, const int* a,
                                      const float* wt, float* w_part,
                                      float* c_part, float* w_add,
                                      float* c_add, int B, int K, int d,
                                      cudaStream_t stream) {
  const size_t smem = ema_segment_sum_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kTileK - 1) / kTileK, kSlices);
  segment_kernel<<<grid, kThreads, smem, stream>>>(v, a, wt, w_part, c_part,
                                                   B, K, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(K) * (d + 1);
  combine_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                   kThreads, 0, stream>>>(w_part, c_part, w_add, c_add, K,
                                          d);
  return static_cast<int>(cudaGetLastError());
}
