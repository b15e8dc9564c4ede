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
//   S to divide by the blocks).  The TPU kernel widens q, k and v to
//   fp32, takes q.k^T in fp32, scales after the product, keeps P in fp32
//   and takes P.V in fp32.  Both routes below keep that function.
//
// Two routes, picked by dtype; neither falls back to the other.
//
// bf16 route (the LM configs' prefill): tensor cores.
//   Bound on Hopper: operations on the tensor cores.  For each (query,
//   key) pair the causal function keeps there are 2 hd flop of q.k^T,
//   one exp and 3 x 2 hd flop of P.V (below).  At Qwen3-0.6B's
//   32,768-token layer (B=1, H=16, Hk=8, hd=128; 8.59e9 pairs) that is
//   2.2 TFLOP of q.k^T and 6.6 TFLOP of P.V at 989 TFLOP/s: 8.89 ms,
//   against 2.05 ms of exps on MUFU and 0.04 ms for the bytes.
//   Why the function holds: q.k^T takes the bf16 operands as they sit in
//   memory with an fp32 accumulate; a product of two bf16 values is exact
//   in fp32, so this is the TPU kernel's fp32 dot up to summation order.
//   P stays fp32 and is split in registers into three bf16 parts,
//   p1 = bf16_rn(p), p2 = bf16_rn(p - p1), p3 = bf16_rn(p - p1 - p2):
//   both subtractions are exact in fp32 and the three 8-bit significands
//   cover p's 24 bits, so p1 + p2 + p3 = p exactly (bf16 has fp32's
//   exponent range; only p below about 2^-110 loses bits, far below the
//   fp32 sum's own rounding).  v is bf16, so every p_i v is exact, and
//   three tensor-core passes into one fp32 accumulator give the TPU
//   kernel's fp32 P.V up to summation order.  (A bf16 P, as the library
//   uses, rounds P; TF32 keeps only 22 bits in two parts at half the
//   bf16 rate.)
//   Design: a block of two consumer warpgroups and one producer warp owns
//   128 query rows of one (b, h), 64 a warpgroup; query tiles run
//   last-first, so the long rows of the causal triangle start first.
//   The producer fills a ring of 4 stages of k and v tiles (64 keys; 32
//   at hd > 128, where the P.V accumulator alone takes 96 or 128
//   registers a thread), kept bf16 in shared memory in the 128-byte
//   swizzled layout wgmma reads, with mbarriers (full: the producer;
//   empty: the 8 consumer warps).  One lane issues TMA copies: 4-D tensor
//   maps (hd, heads, rows, B) with a box of 64 columns of one head, so the
//   kv head h / (H / Hk) is read in place, and the columns from hd and
//   the rows from T (or S) come in as zeros; the map comes from
//   cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint, so
//   the library links no -lcuda.  A tensor map needs 16-byte strides:
//   where hd % 8 != 0 (or a pointer is not 16-byte aligned) the producer
//   warp's 32 lanes copy the same layout element by element instead.  A
//   head dim that is not a multiple of 64 is thus zero-padded in shared
//   memory, not in device memory (zeros add nothing, exactly).
//   Each warpgroup runs S = q.k^T as wgmma m64nBKk16 with q and k from
//   shared memory (both K-major); the online softmax on the fp32
//   accumulator fragment in registers (row max and sum by quad shuffles;
//   the logits scaled after the product, then exp(x - m) as
//   ex2.approx((x - m) log2(e))); masks only the diagonal and tail tiles
//   and skips the tiles above its diagonal; splits P into its three bf16
//   parts; and runs three passes of wgmma m64nHDk16 with the parts as
//   the register A operand (the S accumulator's fragment is the A
//   fragment, so P never touches shared memory) and v from shared memory
//   as the MN-major B operand (the unit transposes 16-bit B).  The
//   output is acc / max(l, 1e-30), rounded to bf16.  No overlap of the
//   softmax with the products inside a warpgroup (the two warpgroups
//   overlap each other): a FlashAttention-3 style ping-pong is later
//   work.  Shared memory at hd = 128: 32 KB of q, 4 x 32 KB of k and v;
//   one block an SM.
//
// fp32 route (the smoke configs, the full-width fp32 check): SIMT, as
//   the port's first kernel had it.  On tensor cores an fp32 q.k^T would
//   not be exact (TF32 rounds the operands).
//   Bound on Hopper: operations in the fp32 pipes, 4 hd flop a pair (both
//   products; 65.6 ms at Qwen3's layer).
//   Design (no tensor cores): a block of 256 threads owns 64 query rows
//   of one (b, h) and walks the key tiles of 64 from the first up to the
//   one that holds its last row's diagonal; tiles wholly above the
//   diagonal are skipped (they add exp(-1e30 - m) = 0 in the reference).
//   The q tile, and each k and v tile, are staged in shared memory as
//   fp32; k and v are read at the query head's kv head h / (H / Hk), so
//   the GQA repeat is never made.  A thread owns 4 rows (ty) and every
//   16th column (tx): its 4 x 4 scores are sequential fp32 FMAs over d,
//   then scaled after the product, as the TPU kernel does.  The row max
//   and row sum go over the 16 lanes of a half-warp with shuffles; m, l
//   and the 4 x hd/16 accumulator stay in registers, in fp32.  The
//   probabilities pass through shared memory (over the k tile, which the
//   scores no longer need) into the P.V product, also sequential fp32
//   FMAs.  The output is acc / max(l, 1e-30).  Query tiles run
//   last-first.  Shared memory: the q, k and v tiles in fp32, the k
//   tile's region at least the 64 x 68 probabilities: 98,816 bytes at
//   hd = 128 (two blocks an SM).
//
// Both routes: any S >= 1 and T >= 1 (T >= S when causal); ragged tails
// are masked, nothing is padded in device memory; offsets are int64.

#include <cuda.h>  // CUtensorMap and its enums (types only, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32 route: SIMT
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 (ty: 4 rows each) x 16 (tx: columns)
constexpr int kPStride = kBK + 4;  // rows 4 apart sit 16 banks apart
constexpr float kNeg = -1e30f;

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
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int Tk,
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
  const float* qb = q + (static_cast<long long>(b) * S) * q_row +
                static_cast<long long>(h) * hd;
  const float* kb = k + (static_cast<long long>(b) * Tk) * kv_row +
                static_cast<long long>(hk) * hd;
  const float* vb = v + (static_cast<long long>(b) * Tk) * kv_row +
                static_cast<long long>(hk) * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    qs[r * ld + d] = s < S ? qb[s * q_row + d] : 0.f;
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
      if (d < hd) ks[j * ld + d] = live ? kb[t * kv_row + d] : 0.f;
      vs[j * ldv + d] = live ? vb[t * kv_row + d] : 0.f;
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
    float* orow = o + (static_cast<long long>(b) * S + s) * q_row +
              static_cast<long long>(h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = __fdiv_rn(acc[r][c], den);
    }
  }
}

template <int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Tk, int H, int Hk, int hd, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_kernel<NC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const dim3 grid(n_qt, B * H);
  flash_kernel<NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, Hk, hd,
      causal, scale, n_qt);
  return static_cast<int>(cudaGetLastError());
}

int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int H, int Hk, int hd, int causal, float scale,
                cudaStream_t stream) {
  switch (nc_of(hd)) {
    case 1:
      return launch_nc<1>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 2:
      return launch_nc<2>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 4:
      return launch_nc<4>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    case 8:
      return launch_nc<8>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                             stream);
    default:
      return launch_nc<16>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                              stream);
  }
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // query rows a block, 64 a warpgroup
constexpr int kTcThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kStages = 4;       // k/v tiles in the ring
constexpr int kBarBytes = 8 * (2 * kStages + 1);  // full, empty, q
constexpr float kLog2e = 1.44269504088896341f;

// keys a tile at padded head dim hdp
__host__ __device__ constexpr int tc_bk(int hdp) {
  return hdp <= 128 ? 64 : 32;
}
// head dim padded to the 64-column slabs of the swizzled tiles
__host__ __device__ inline int hdp_of(int hd) { return (hd + 63) / 64 * 64; }

// barriers, the alignment of the tiles to 1,024 bytes, the q tile and the
// ring of k and v tiles
inline size_t tc_smem_bytes(int hdp) {
  return 1024 + kBarBytes + static_cast<size_t>(kTcRows) * hdp * 2 +
         static_cast<size_t>(kStages) * 2 * tc_bk(hdp) * hdp * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on bar that also expects `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// TMA: the box of map at (c0, c1, c2, c3) into shared memory at dst,
// completing `bar`'s transaction bytes; elements outside the tensor are 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps registers that an in-flight wgmma reads or writes from being
// moved across its wait
template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// descriptor of a matrix in shared memory in the 128-byte swizzle: the
// start address, the leading and the stride byte offsets, in 16 bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d (64 x 32) = (scale_d ? d : 0) + a (64 x 16) . b (32 x 16)^T, a and b
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + a (64 x 16) . b (64 x 16)^T, a and b
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64), b MN-major in
// shared memory (transposed by the unit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += a (64 x 16, registers) . b (16 x 128), b MN-major in
// shared memory (transposed by the unit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 192) += a (64 x 16, registers) . b (16 x 192), b MN-major in
// shared memory (transposed by the unit)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256) += a (64 x 16, registers) . b (16 x 256), b MN-major in
// shared memory (transposed by the unit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// 2^x on the MUFU unit, one instruction (relative error about 2^-22; a
// result below 2^-126 is 0, which moves the normalised output by less
// than 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) = (x1 + x2 + x3, y1 + y2 + y3) exactly, each part a bf16 pair
// (module note): both subtractions are exact in fp32
__device__ __forceinline__ void split3(float x, float y, uint32_t& a,
                                       uint32_t& b, uint32_t& c) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  float2 f = __bfloat1622float2(h);
  a = bf16x2_bits(h);
  x -= f.x;
  y -= f.y;
  h = __floats2bfloat162_rn(x, y);
  f = __bfloat1622float2(h);
  b = bf16x2_bits(h);
  x -= f.x;
  y -= f.y;
  c = bf16x2_bits(__floats2bfloat162_rn(x, y));
}

// The narrow-head copy (hd % 8 != 0, where a tensor map cannot stride):
// rows [row0, row0 + R) of a bf16 matrix with row stride `stride`, columns
// [0, hd), by the 32 lanes of a warp into the layout TMA writes, the
// 128-byte-swizzled tile of HDP / 64 slabs of R rows x 128 bytes at gdst:
// the 16-byte chunk c of row r lies in slab c / 8 at chunk (c % 8) ^ (r %
// 8).  Rows from n_rows and columns from hd are zeros.
template <int HDP, int R>
__device__ __forceinline__ void load_tile_narrow(unsigned char* gdst,
                                                 const __nv_bfloat16* src,
                                                 int row0, int n_rows,
                                                 long long stride, int hd,
                                                 int lane) {
  constexpr int kChunks = HDP / 8;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int i = lane; i < R * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    const uint32_t off =
        (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    const int g = row0 + r;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * c + 2 * e;
      const uint32_t lo = g < n_rows && d < hd ? s16[g * stride + d] : 0u;
      const uint32_t hi =
          g < n_rows && d + 1 < hd ? s16[g * stride + d + 1] : 0u;
      w[e] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(gdst + off) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (BK == 64)
    wgmma_ss_n64(s, a, b, scale_d);
  else
    wgmma_ss_n32(s, a, b, scale_d);
}

template <int HDP>
__device__ __forceinline__ void mma_pv(float (&acc)[HDP / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HDP == 64)
    wgmma_rs_n64(acc, a, b);
  else if constexpr (HDP == 128)
    wgmma_rs_n128(acc, a, b);
  else if constexpr (HDP == 192)
    wgmma_rs_n192(acc, a, b);
  else
    wgmma_rs_n256(acc, a, b);
}

// HDP: head dim padded to 64, 128, 192 or 256
template <int HDP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int Tk, int H, int Hk,
                int hd, int causal, float scale, int n_qt, int tma) {
  constexpr int BK = tc_bk(HDP);
  constexpr int NS = HDP / 64;                 // 64-column slabs a tile
  constexpr uint32_t kQSlab = kTcRows * 128;   // bytes of a q slab
  constexpr uint32_t kKSlab = BK * 128;        // bytes of a k or v slab
  constexpr uint32_t kKV = NS * kKSlab;        // bytes of a k or v tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  // barriers at raw: full[st] at 8 st, empty[st] at 8 (kStages + st), the
  // q tile's at 16 kStages; the tiles from the next 1,024-byte boundary
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t base = (raw + kBarBytes + 1023) & ~1023u;
  unsigned char* const gbase = tc_smem + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + NS * kQSlab;    // stage st: k, then v
  const uint32_t q_bar = raw + 16 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTcRows;
  const int off = Tk - S;  // absolute position of query i is i + off
  const long long q_row = static_cast<long long>(H) * hd;
  const long long kv_row = static_cast<long long>(Hk) * hd;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * S) * q_row +
                            static_cast<long long>(h) * hd;
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * Tk) * kv_row +
                            static_cast<long long>(hk) * hd;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * Tk) * kv_row +
                            static_cast<long long>(hk) * hd;

  const int n_kt = (Tk + BK - 1) / BK;
  int kt_end = n_kt;  // tiles the block loads: up to its last row's diagonal
  if (causal) {
    const int last = (q0 + kTcRows < S ? q0 + kTcRows : S) - 1;
    const int need = (last + off) / BK + 1;
    kt_end = need < n_kt ? need : n_kt;
  }

  if (tid == 0) {
    const int loaders = tma ? 1 : 32;
    for (int st = 0; st < kStages; ++st) {
      mbar_init(raw + 8 * st, loaders);
      mbar_init(raw + 8 * (kStages + st), 8);
    }
    mbar_init(q_bar, loaders);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues TMA, or 32 lanes copy
    if (tma && lane != 0) return;
    if (tma) {
      mbar_expect(q_bar, NS * kQSlab);
      for (int j = 0; j < NS; ++j)
        tma_load(q_s + j * kQSlab, tq, 64 * j, h, q0, b, q_bar);
    } else {
      load_tile_narrow<HDP, kTcRows>(gbase, qb, q0, S, q_row, hd, lane);
      fence_proxy_async();  // generic stores, read by wgmma (async proxy)
      mbar_arrive(q_bar);
    }
    for (int kt = 0; kt < kt_end; ++kt) {
      const int st = kt % kStages;
      const uint32_t full = raw + 8 * st, ks = kv_s + 2 * st * kKV;
      mbar_wait(raw + 8 * (kStages + st), ((kt / kStages) & 1) ^ 1);
      if (tma) {
        mbar_expect(full, 2 * kKV);
        for (int j = 0; j < NS; ++j) {
          tma_load(ks + j * kKSlab, tk, 64 * j, hk, kt * BK, b, full);
          tma_load(ks + kKV + j * kKSlab, tv, 64 * j, hk, kt * BK, b, full);
        }
      } else {
        load_tile_narrow<HDP, BK>(gbase + (ks - base), kb, kt * BK, Tk,
                                  kv_row, hd, lane);
        load_tile_narrow<HDP, BK>(gbase + (ks + kKV - base), vb, kt * BK, Tk,
                                  kv_row, hd, lane);
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [rw, rw + 64); a thread the rows row
  // and row + 8 and, of every 8 columns, col and col + 1 (the wgmma
  // accumulator fragment: element 4 j + 2 r + e at row + 8 r, column
  // 8 j + col + e)
  const int wg = warp >> 2;
  const int rw = q0 + 64 * wg;
  int kt_wg = 0;  // tiles the warpgroup computes; it waits out the rest
  if (rw < S) {
    kt_wg = n_kt;
    if (causal) {
      const int last = (rw + 64 < S ? rw + 64 : S) - 1;
      const int need = (last + off) / BK + 1;
      kt_wg = need < n_kt ? need : n_kt;
    }
  }
  const int row = rw + 16 * (warp & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt % kStages;
    mbar_wait(raw + 8 * st, (kt / kStages) & 1);
    if (kt < kt_wg) {
      fence_proxy_async();
      const uint32_t ks = kv_s + 2 * st * kKV, vs = ks + kKV;
      const int k0 = kt * BK;

      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        mma_qk<BK>(s,
                   sw128_desc(q_s + (kk >> 2) * kQSlab + wg * 64 * 128 +
                                  (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(ks + (kk >> 2) * kKSlab + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      keep(s);

      if (k0 + BK > Tk || (causal && k0 + BK - 1 > rw + off)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + col + e;
              if (key >= Tk || (causal && key > row + 8 * r + off))
                s[4 * j + 2 * r + e] = -INFINITY;
            }
      }
      // the logits, scaled after the product as the TPU kernel scales them
      // (so rounded as its fp32 logits are); exp(x - m) as 2^((x - m)
      // log2(e)), where x - m is exact for every x that adds to the sum
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * j + 2 * r + e] *= scale;
            mx = fmaxf(mx, s[4 * j + 2 * r + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2((s[4 * j + 2 * r + e] - m_new) * kLog2e);
            s[4 * j + 2 * r + e] = p;
            sum += p;
          }
        l[r] = l[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= alpha[r];
          acc[4 * j + 2 * r + 1] *= alpha[r];
        }

      // the A fragment of keys [16 kk, 16 kk + 16): elements 8 kk .. 8 kk + 7
      // of the S fragment, two to a register
      uint32_t pa[3][BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split3(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], pa[0][kk][i],
                 pa[1][kk][i], pa[2][kk][i]);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_pv<HDP>(acc, pa[part][kk],
                      sw128_desc(vs + kk * 16 * 128, kKSlab, 1024));
      wgmma_commit();
      wgmma_wait_all();
      keep(acc);
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) keep(pa[part][kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(raw + 8 * (kStages + st));
  }

  if (rw >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int srow = row + 8 * r;
    if (srow >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * S + srow) * q_row +
                          static_cast<long long>(h) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + col + e;
        if (d < hd)
          orow[d] = __float2bfloat16_rn(__fdiv_rn(acc[4 * j + 2 * r + e], den));
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the bf16 tensor (B, rows, heads, hd) as a 4-D map (hd, heads, rows, B)
// with a box of 64 columns of one head over box_rows rows, 128-byte
// swizzled: one slab of a tile; columns from hd and rows from `rows` read 0
int encode_map(CUtensorMap* map, const void* p, int B, int rows, int heads,
               int hd, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads,
                                 2ull * hd * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                             const_cast<void*>(p), dims, strides, box, unit,
                             CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Tk, int H, int Hk, int hd, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(HDP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // a tensor map needs 16-byte strides and base addresses
  const int tma = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  CUtensorMap tq{}, tk{}, tv{};
  if (tma) {
    int code = encode_map(&tq, q, B, S, H, hd, kTcRows);
    if (code == 0) code = encode_map(&tk, k, B, Tk, Hk, hd, tc_bk(HDP));
    if (code == 0) code = encode_map(&tv, v, B, Tk, Hk, hd, tc_bk(HDP));
    if (code != 0) return code;
  }
  const int n_qt = (S + kTcRows - 1) / kTcRows;
  const dim3 grid(n_qt, B * H);
  flash_tc_kernel<HDP><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Tk, H, Hk, hd, causal, scale, n_qt, tma);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int H, int Hk, int hd, int causal, float scale,
                cudaStream_t stream) {
  switch (hdp_of(hd)) {
    case 64:
      return launch_tc<64>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                           stream);
    case 128:
      return launch_tc<128>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                            stream);
    case 192:
      return launch_tc<192>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                            stream);
    default:
      return launch_tc<256>(q, k, v, o, B, S, Tk, H, Hk, hd, causal, scale,
                            stream);
  }
}

}  // namespace

// Dynamic shared memory of a launch at head dim hd, fp32 (bf16 = 0) or
// bf16 (bf16 = 1).
extern "C" size_t flash_attention_smem_bytes(int hd, int bf16) {
  return bf16 ? tc_smem_bytes(hdp_of(hd)) : smem_bytes(hd);
}

// The largest head dim the kernel takes.
extern "C" int flash_attention_max_hd() { return 256; }

// q (B, S, H, hd), k and v (B, T, Hk, hd), o (B, S, H, hd), row-major, all
// fp32 (bf16 = 0: the SIMT route) or all bf16 (bf16 = 1: the tensor-core
// route).  Needs B, S, T >= 1, 1 <= hd <= 256, H % Hk == 0,
// B * H <= 65,535 and T >= S when causal; scale is the logits' factor
// (hd^-0.5 rounded to fp32 by the caller).  Returns the CUDA error code of
// the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int Hk, int hd, int causal,
                                      float scale, int bf16,
                                      cudaStream_t stream) {
  if (bf16)
    return launch_bf16(q, k, v, o, B, S, T, H, Hk, hd, causal, scale, stream);
  return launch_simt(q, k, v, o, B, S, T, H, Hk, hd, causal, scale, stream);
}
