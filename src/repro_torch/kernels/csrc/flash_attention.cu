// flash_attention: causal (or full) attention with the online softmax,
// per (batch, head), over q (B, S, H, hd) and k, v (B, T, Hk, hd):
//   o[b, i, h] = sum_j p_ij v[b, j, h / (H / Hk)],
//   p_ij = exp(s_ij - m_i) / l_i,  s_ij = (q_i . k_j) * hd^-0.5,
// key j taking part where j < T and, if causal, j <= i + (T - S).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
//   flash_attention_pallas (one head (S, hd); a sequential grid over
//   (q block, kv block) that carries the running (m, l, acc) in VMEM
//   scratch, runs the fully masked blocks above the diagonal, and needs
//   S to divide by the blocks).
//
// Bound on Hopper: operations.  For each (query, key) pair the causal
//   function keeps it does 2 * hd flop of q.k^T, one exp and 2 * hd flop
//   of P.V.  With bf16 inputs q.k^T could run on the tensor cores (an fp32
//   accumulate of bf16 products is exact), but P is fp32, so P.V runs at
//   the 67 TFLOP/s of the fp32 pipes: at Qwen3-0.6B's 32,768-token layer
//   (B=1, H=16, Hk=8, hd=128) 2.2 TFLOP of P.V take 32.8 ms, against
//   2.2 ms of q.k^T at 989 TFLOP/s, 2.1 ms of exps and 0.04 ms for the
//   0.13 GB of q, k, v and o.  This kernel runs both products in the fp32
//   pipes (65.6 ms).
//
// Design (simple first; no tensor cores): a block of 256 threads owns 64
//   query rows of one (b, h) and walks the key tiles of 64 from the first
//   up to the one that holds its last row's diagonal; tiles wholly above
//   the diagonal are skipped (they add exp(-1e30 - m) = 0 in the
//   reference).  The q tile, and each k and v tile, are staged in shared
//   memory as fp32 (bf16 widened on load, which is exact); k and v are
//   read at the query head's kv head h / (H / Hk), so the GQA repeat is
//   never made.  A thread owns 4 rows (ty) and every 16th column (tx):
//   its 4 x 4 scores are sequential fp32 FMAs over d, then scaled after
//   the product, as the TPU kernel does.  The row max and row sum go
//   over the 16 lanes of a half-warp with shuffles; m, l and the 4 x
//   hd/16 accumulator stay in registers, in fp32.  The probabilities
//   pass through shared memory (over the k tile, which the scores no
//   longer need) into the P.V product, also sequential fp32 FMAs.  The
//   output is acc / max(l, 1e-30), rounded to the input's type.  Query
//   tiles run last-first, so the long rows of the causal triangle start
//   first.  Any S >= 1 and T >= 1 (T >= S when causal); ragged tails are
//   masked, nothing is padded in memory.  Offsets are int64.
//   Shared memory: the q, k and v tiles in fp32, the k tile's region at
//   least the 64 x 68 probabilities: 98,816 bytes at hd = 128 (two
//   blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 (ty: 4 rows each) x 16 (tx: columns)
constexpr int kPStride = kBK + 4;  // rows 4 apart sit 16 banks apart
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max and sum over the 16 lanes of a half-warp (the tx of one ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// output columns a thread (the launch's NC): hd <= 16 * nc_of(hd)
__host__ __device__ inline int nc_of(int hd) {
  return hd <= 16 ? 1 : hd <= 32 ? 2 : hd <= 64 ? 4 : hd <= 128 ? 8 : 16;
}
__host__ __device__ inline int qk_stride(int hd) { return hd | 1; }
// the P.V loop reads columns tx + 16 c for every c < NC: the v tile is
// 16 * NC wide, its columns from hd zeroed
__host__ __device__ inline int v_stride(int hd) { return 16 * nc_of(hd); }

// floats of the k tile's region, which the probabilities reuse
__host__ __device__ inline int k_region(int hd) {
  const int kt = kBK * qk_stride(hd), pt = kBQ * kPStride;
  return kt > pt ? kt : pt;
}

inline size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * qk_stride(hd) +
                          k_region(hd) + static_cast<size_t>(kBK) *
                                             v_stride(hd));
}

// NC: output columns a thread, hd <= 16 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
             int H, int Hk, int hd, int causal, float scale, int n_qt) {
  extern __shared__ float smem[];
  const int ld = qk_stride(hd);
  const int ldv = v_stride(hd);
  float* qs = smem;               // kBQ x ld
  float* ks = qs + kBQ * ld;      // kBK x ld; then the probabilities
  float* vs = ks + k_region(hd);  // kBK x ldv, columns from hd zeroed
  float* ps = ks;                 // kBQ x kPStride

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int off = Tk - S;  // absolute position of query i is i + off
  const long long q_row = static_cast<long long>(H) * hd;
  const long long kv_row = static_cast<long long>(Hk) * hd;
  const T* qb = q + (static_cast<long long>(b) * S) * q_row +
                static_cast<long long>(h) * hd;
  const T* kb = k + (static_cast<long long>(b) * Tk) * kv_row +
                static_cast<long long>(hk) * hd;
  const T* vb = v + (static_cast<long long>(b) * Tk) * kv_row +
                static_cast<long long>(hk) * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    qs[r * ld + d] = s < S ? to_f32(qb[s * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int n_kt = (Tk + kBK - 1) / kBK;
  int kt_end = n_kt;
  if (causal) {
    const int last_q = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
    const int need = (last_q + off) / kBK + 1;
    kt_end = need < n_kt ? need : n_kt;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's probabilities and v are read
    for (int i = tid; i < kBK * ldv; i += kThreads) {
      const int j = i / ldv, d = i - j * ldv;
      const int t = k0 + j;
      const bool live = t < Tk && d < hd;
      if (d < hd) ks[j * ld + d] = live ? to_f32(kb[t * kv_row + d]) : 0.f;
      vs[j * ldv + d] = live ? to_f32(vb[t * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    const float* qrow = qs + (ty * 4) * ld;
    const float* kcol = ks + tx * ld;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qrow[r * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kcol[(16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r + off;
      bool keep[4];
      float mb = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        keep[c] = kpos < Tk && (!causal || kpos <= qpos);
        sc[r][c] *= scale;
        if (keep[c]) mb = fmaxf(mb, sc[r][c]);
      }
      mb = half_warp_max(mb);
      const float m_new = fmaxf(m[r], mb);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = keep[c] ? expf(sc[r][c] - m_new) : 0.f;
        rs += p[r][c];
      }
      rs = half_warp_sum(rs);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every thread has read its k columns
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty * 4 + r) * kPStride + tx + 16 * c] = p[r][c];
    __syncthreads();

    const int n_j = Tk - k0 < kBK ? Tk - k0 : kBK;
    const float* prow = ps + (ty * 4) * kPStride;
    for (int j = 0; j < n_j; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = prow[r * kPStride + j];
      const float* vrow = vs + j * ldv + tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = vrow[16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], x, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + ty * 4 + r;
    if (s >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + (static_cast<long long>(b) * S + s) * q_row +
              static_cast<long long>(h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(__fdiv_rn(acc[r][c], den));
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Tk, int H, int Hk, int hd, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_kernel<T, NC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const dim3 grid(n_qt, B * H);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, Hk, hd, causal,
      scale, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int Hk, int hd, int causal, float scale,
           cudaStream_t stream) {
  switch (nc_of(hd)) {
    case 1:
      return launch_nc<T, 1>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 2:
      return launch_nc<T, 2>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 4:
      return launch_nc<T, 4>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 8:
      return launch_nc<T, 8>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    default:
      return launch_nc<T, 16>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                              stream);
  }
}

}  // namespace

// Dynamic shared memory of a launch at head dim hd.
extern "C" size_t flash_attention_smem_bytes(int hd) { return smem_bytes(hd); }

// The largest head dim the kernel takes.
extern "C" int flash_attention_max_hd() { return 256; }

// q (B, S, H, hd), k and v (B, T, Hk, hd), o (B, S, H, hd), row-major, all
// fp32 (bf16 = 0) or all bf16 (bf16 = 1).  Needs B, S, T >= 1,
// 1 <= hd <= 256, H % Hk == 0, B * H <= 65,535 and T >= S when causal;
// scale is the logits' factor (hd^-0.5 rounded to fp32 by the caller).
// Returns the CUDA error code of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int Hk, int hd, int causal,
                                      float scale, int bf16,
                                      cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, Hk, hd, causal,
                                 scale, stream);
  return launch<float>(q, k, v, o, B, S, T, H, Hk, hd, causal, scale, stream);
}
