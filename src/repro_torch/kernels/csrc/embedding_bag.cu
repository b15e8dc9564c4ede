// embedding_bag: the fixed-size bag lookup of the recsys families,
//   out[b, :] = sum_{t < bag} table[ids[b, t], :]   (fp32),
// divided by bag for combiner "mean".
//
// Replaces: src/repro/kernels/embedding_bag.py, _embag_kernel /
//   embedding_bag_pallas (a grid over blocks of 8 batch rows; the ids ride
//   the scalar-prefetch channel and each row's bag rows are DMA'd from the
//   table in HBM into a VMEM slab, then summed in fp32).
//
// Bound on Hopper: bytes.  The function reads B*bag*d*s bytes of gathered
//   rows (s = 4 for fp32, 2 for bf16), B*bag*8 bytes of ids and writes
//   B*d*4 bytes; it does one add per gathered element, far below any
//   compute limit.  At DLRM-RM2's multi-hot tables (d=64, bag=20) and
//   B=262,144 that is 1.45 GB, 0.433 ms at 3.35 TB/s.
//
// Design: tpr threads own one output row (tpr = the power of two >= the
//   row's 16-byte slots, at most a warp; a thread loops over slots tpr
//   apart when the row has more).  A block holds up to 64 rows and stages
//   their ids in shared memory, 64 ids a row at a time, with coalesced
//   loads.  Each thread then issues the loads of 4 table rows before it
//   adds them, so several rows are in flight.  A slot is 4 elements (a
//   16-byte float4, or 8 bytes of bf16) when d % 4 == 0 and the table's
//   base is aligned to a slot, else 1 element.  bf16 is widened to fp32
//   on load, which is exact.  Every column is summed in the fixed order
//   t = 0..bag-1, so launches are bitwise repeatable; the mean divides by
//   bag (a rounded IEEE division, not a multiply by 1/bag).  Row offsets
//   are int64: id * d passes 2^31 on the larger tables.  The ragged edge
//   of B is masked; no row is padded.  An id outside [0, V) reads nothing
//   and makes its output row NaN.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block at most
constexpr int kMaxRows = 64;   // output rows a block at most
constexpr int kIdChunk = 64;   // ids of a row staged at once
constexpr int kUnroll = 4;     // table rows a thread has in flight

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

// element slot s (W elements from column s*W) of one table row -> fp32
template <typename T, int W>
__device__ __forceinline__ void load_slot(const T* row, int s, float* v);

template <>
__device__ __forceinline__ void load_slot<float, 4>(const float* row, int s,
                                                    float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + s);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <>
__device__ __forceinline__ void load_slot<float, 1>(const float* row, int s,
                                                    float* v) {
  v[0] = __ldg(row + s);
}

template <>
__device__ __forceinline__ void load_slot<uint16_t, 4>(const uint16_t* row,
                                                       int s, float* v) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + s);
  v[0] = bf16_bits_to_f32(x.x & 0xffffu);
  v[1] = bf16_bits_to_f32(x.x >> 16);
  v[2] = bf16_bits_to_f32(x.y & 0xffffu);
  v[3] = bf16_bits_to_f32(x.y >> 16);
}

template <>
__device__ __forceinline__ void load_slot<uint16_t, 1>(const uint16_t* row,
                                                       int s, float* v) {
  v[0] = bf16_bits_to_f32(__ldg(row + s));
}

template <typename T, int W>
__device__ __forceinline__ void load_row(const T* table, long long id,
                                         long long V, int d, int s,
                                         float* v) {
  if (id >= 0 && id < V) {
    load_slot<T, W>(table + id * static_cast<long long>(d), s, v);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __int_as_float(0x7fc00000);  // NaN
  }
}

__host__ __device__ inline int tpr_log2_of(int slots) {
  int lg = 0;
  while ((1 << lg) < slots && lg < 5) ++lg;
  return lg;
}

__host__ __device__ inline int rows_of(int tpr_log2) {
  const int rows = kThreads >> tpr_log2;
  return rows < kMaxRows ? rows : kMaxRows;
}

template <typename T, typename Id, int W>
__global__ void __launch_bounds__(kThreads)
embag_kernel(const T* __restrict__ table, const Id* __restrict__ ids,
             float* __restrict__ out, long long B, long long V, int bag,
             int d, int tpr_log2, int mean) {
  extern __shared__ long long ids_s[];
  const int tpr = 1 << tpr_log2;
  const int rows = rows_of(tpr_log2);
  const int chunk = bag < kIdChunk ? bag : kIdChunk;
  const int r = threadIdx.x >> tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const long long b0 = static_cast<long long>(blockIdx.x) * rows;
  const long long b = b0 + r;
  const bool live = b < B;
  const int slots = d / W;
  const float fbag = static_cast<float>(bag);

  // the same number of slot passes in every thread: ceil(slots / tpr)
  for (int s0 = 0; s0 < slots; s0 += tpr) {
    const int s = s0 + lane;
    const bool mine = live && s < slots;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.f;
    for (int t0 = 0; t0 < bag; t0 += chunk) {
      const int n = bag - t0 < chunk ? bag - t0 : chunk;
      __syncthreads();  // the previous chunk's ids are read
      for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
        const int rr = i / n, tt = i - rr * n;
        const long long bb = b0 + rr;
        ids_s[rr * chunk + tt] =
            bb < B ? static_cast<long long>(ids[bb * bag + t0 + tt]) : 0;
      }
      __syncthreads();
      if (!mine) continue;
      const long long* my = ids_s + r * chunk;
      int t = 0;
      for (; t + kUnroll <= n; t += kUnroll) {
        float v[kUnroll][W];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          load_row<T, W>(table, my[t + u], V, d, s, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = __fadd_rn(acc[w], v[u][w]);
      }
      for (; t < n; ++t) {
        float v[W];
        load_row<T, W>(table, my[t], V, d, s, v);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = __fadd_rn(acc[w], v[w]);
      }
    }
    if (!mine) continue;
    float* o = out + b * static_cast<long long>(d) + s * W;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (mean) acc[w] = __fdiv_rn(acc[w], fbag);
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    } else {
      o[0] = acc[0];
    }
  }
}

template <typename T, typename Id, int W>
int launch(const void* table, const void* ids, float* out, long long B,
           long long V, int bag, int d, int mean, cudaStream_t stream) {
  const int lg = tpr_log2_of(d / W);
  const int rows = rows_of(lg);
  const long long grid = (B + rows - 1) / rows;
  const int chunk = bag < kIdChunk ? bag : kIdChunk;
  const size_t smem = static_cast<size_t>(rows) * chunk * sizeof(long long);
  embag_kernel<T, Id, W><<<static_cast<unsigned>(grid), rows << lg, smem,
                           stream>>>(
      static_cast<const T*>(table), static_cast<const Id*>(ids), out, B, V,
      bag, d, lg, mean);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Id>
int launch_w(const void* table, const void* ids, float* out, long long B,
             long long V, int bag, int d, int mean, int vec,
             cudaStream_t stream) {
  return vec ? launch<T, Id, 4>(table, ids, out, B, V, bag, d, mean, stream)
             : launch<T, Id, 1>(table, ids, out, B, V, bag, d, mean, stream);
}

}  // namespace

// Dynamic shared memory of a launch whose rows have ``slots`` slots.
extern "C" size_t embedding_bag_smem_bytes(int slots, int bag) {
  const int chunk = bag < kIdChunk ? bag : kIdChunk;
  return static_cast<size_t>(rows_of(tpr_log2_of(slots))) * chunk *
         sizeof(long long);
}

// table (V, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), row-major; ids (B, bag)
// int32 (ids64 = 0) or int64 (ids64 = 1), row-major; out (B, d) fp32.
// vec = 1 takes 4-element slots: d % 4 == 0 and a table base aligned to 16
// bytes (fp32) or 8 bytes (bf16).  Needs B >= 1, bag >= 1, d >= 1 and
// ceil(B / rows) < 2^31.  Returns the CUDA error code of the launch.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    float* out, long long B, long long V,
                                    int bag, int d, int bf16, int ids64,
                                    int mean, int vec, cudaStream_t stream) {
  if (bf16) {
    return ids64 ? launch_w<uint16_t, long long>(table, ids, out, B, V, bag,
                                                  d, mean, vec, stream)
                 : launch_w<uint16_t, int>(table, ids, out, B, V, bag, d,
                                           mean, vec, stream);
  }
  return ids64 ? launch_w<float, long long>(table, ids, out, B, V, bag, d,
                                            mean, vec, stream)
               : launch_w<float, int>(table, ids, out, B, V, bag, d, mean,
                                      vec, stream);
}
