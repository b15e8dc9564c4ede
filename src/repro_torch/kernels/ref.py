"""Plain PyTorch versions of the hand-written kernels.

A kernel wrapper in ``ops.py`` runs these on CPU tensors; the CPU tests
hold them to the JAX package, and ``chip_smoke.py`` holds each kernel to
its plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def cluster_rank_ref(u: torch.Tensor, e: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 5/11 cluster ranking: top-n of u @ e.T per query row.

    Sorted by descending score; exact ties go to the lower cluster id (a
    stable sort, since ``torch.topk`` promises no order among ties).
    """
    if n > e.shape[0]:
        raise ValueError(f"top-n {n} exceeds codebook size {e.shape[0]}")
    scores = u.to(torch.float32) @ e.to(torch.float32).T
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :n].contiguous(), idx[:, :n].to(torch.int32)


def topk_dot_ref(u: torch.Tensor, items: torch.Tensor, bias: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores = items @ u + bias in fp32 (bf16 inputs upcast) -> the top-k
    (values fp32, indices int32) by descending score, ties to the lower
    index (a stable sort).  u: (d,) -> (k,) each; u: (B, d) -> (B, k)."""
    if not 0 < k <= items.shape[0]:
        raise ValueError(f"top-k {k} must lie in [1, N={items.shape[0]}]")
    items32, u32 = items.to(torch.float32), u.to(torch.float32)
    scores = (items32 @ u32 if u.dim() == 1 else (items32 @ u32.T).T) \
        + bias.to(torch.float32)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def merge_serve_ref(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                    lengths: torch.Tensor, chunk: int, target: int,
                    exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Alg. 1 merge: the batched loop of pops."""
    from repro_torch.core import merge_sort
    return merge_sort.merge_sort_serve(cluster_scores, bias_lists, lengths,
                                       chunk, target, exact)


# The reference promises that merge_serve_ds returns the bits of
# merge_serve, for every L (its wrapper pads L < chunk up to chunk).
merge_serve_ds_ref = merge_serve_ref


def fused_gather_rank_ref(u: torch.Tensor, cluster_scores: torch.Tensor,
                          starts: torch.Tensor, lengths: torch.Tensor,
                          limits: torch.Tensor, bias_flat: torch.Tensor,
                          ids_flat: torch.Tensor, emb_flat: torch.Tensor,
                          chunk: int, target: int, l: int,
                          exact: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Fused merge + gather + Eq. 11 score: the batched loop of pops."""
    from repro_torch.core import merge_sort
    return merge_sort.fused_gather_rank(u, cluster_scores, starts, lengths,
                                        limits, bias_flat, ids_flat,
                                        emb_flat, chunk, target, l, exact)


def index_sort_ref(cluster: torch.Tensor, bias: torch.Tensor
                   ) -> torch.Tensor:
    """Appendix-B index order: stable (cluster asc, bias desc) argsort.

    One stable sort on a composite int64 key: the cluster id in the high
    32 bits, and in the low 32 the bias mapped to a monotone uint32 and
    inverted for descending.  +/-0.0 collapse to one key (they tie, like
    an IEEE comparison) and NaN takes the largest key, so it sorts last
    in its segment.  ``cluster`` holds empty slots as the sentinel id.
    """
    bias = bias.to(torch.float32)
    bias = torch.where(bias == 0.0, torch.zeros_like(bias), bias)
    b = bias.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    asc = torch.where((b >> 31) == 1, b ^ 0xFFFFFFFF, b | 0x80000000)
    desc = torch.where(torch.isnan(bias),
                       torch.full_like(b, 0xFFFFFFFF), asc ^ 0xFFFFFFFF)
    key = (cluster.to(torch.int64) << 32) | desc
    return torch.sort(key, stable=True).indices


def vq_assign_ref(v: torch.Tensor, e: torch.Tensor, r: torch.Tensor
                  ) -> torch.Tensor:
    """Eq. 10: argmin_k max(||v||^2 - 2 v.e_k + ||e_k||^2, 0) * r_k, the
    first minimum.  v: (B, d), e: (K, d), r: (K,) -> (B,) int32."""
    v = v.to(torch.float32)
    e = e.to(torch.float32)
    d2 = (torch.sum(v * v, dim=-1, keepdim=True) - 2.0 * (v @ e.T)
          + torch.sum(e * e, dim=-1)[None, :])
    scores = torch.clamp(d2, min=0.0) * r.to(torch.float32)[None, :]
    return torch.argmin(scores, dim=-1).to(torch.int32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """At least float32: float64 stays, so autograd.gradcheck can run."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


def _inbatch_logits(u, v, bias, log_q):
    return _f32(u) @ _f32(v).T + _f32(bias)[None, :] - _f32(log_q)[None, :]


def inbatch_softmax_ref(u: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        log_q: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row in-batch CE of Eq. 1 + Eq. 11 + logQ, with the softmax
    stats: z = u v^T + bias - logQ (B, B) -> (loss, m, l), where
    m = max_r z_or, l = sum_r exp(z_or - m) and
    loss = m + log(l) - z_oo.  ``log_q=None`` means zeros."""
    if log_q is None:
        log_q = torch.zeros_like(bias)
    z = _inbatch_logits(u, v, bias, log_q)
    m = torch.max(z, dim=-1).values
    l = torch.sum(torch.exp(z - m[:, None]), dim=-1)
    return m + torch.log(l) - torch.diagonal(z), m, l


_ROWS = 4096  # rows of p a block of the backward's fp64 sums takes


def inbatch_softmax_bwd_ref(u: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, log_q: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """VJP of the per-row CE from the saved lse, with p = exp(z - lse):

        du_o    = g_o (sum_r p_or v_r - v_o)
        dv_r    = sum_o g_o p_or u_o  -  g_r u_r
        dbias_r = sum_o g_o p_or  -  g_r          (dlogq = -dbias)

    z and p are fp32; the three sums over the batch accumulate in fp64,
    a block of rows at a time, and are rounded to fp32 before the rank-one
    terms.  (On an H100, cuBLAS's fp32 p @ v over the train batch of
    65,536 rows put du up to 2.8e-5 off its fp64 value: beyond rtol 1e-4
    / atol 1e-5, so no yardstick for the kernel.)
    """
    u32, v32, g32 = _f32(u), _f32(v), _f32(g)
    p = torch.exp(_inbatch_logits(u, v, bias, log_q) - _f32(lse)[:, None])
    gp = g32[:, None] * p
    u64, v64 = u32.double(), v32.double()
    pv = torch.cat([p[i:i + _ROWS].double() @ v64
                    for i in range(0, p.shape[0], _ROWS)])
    gpu = torch.zeros_like(u64)
    gps = torch.zeros((p.shape[1],), dtype=torch.float64, device=p.device)
    for i in range(0, p.shape[0], _ROWS):
        block = gp[i:i + _ROWS].double()
        gpu += block.T @ u64[i:i + _ROWS]
        gps += block.sum(dim=0)
    du = g32[:, None] * (pv.to(u32.dtype) - v32)
    dv = gpu.to(u32.dtype) - g32[:, None] * u32
    dbias = gps.to(u32.dtype) - g32
    return du, dv, dbias, -dbias


def ema_segment_sum_ref(v: torch.Tensor, assignment: torch.Tensor,
                        weight: torch.Tensor, k: int,
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7-8 batch reductions: w_add[k] = sum_{a_j = k} wt_j v_j (K, d),
    c_add[k] = sum_{a_j = k} wt_j (K,).  Rows assigned outside [0, K)
    add nothing, as in ``segment_sum``.  ``dtype=torch.float64`` gives a
    near-exact sum to measure a float32 result's error against."""
    v32 = v.to(dtype)
    w32 = weight.to(dtype)
    a = assignment.long()
    keep = (a >= 0) & (a < k)
    w_add = torch.zeros((k, v.shape[1]), dtype=dtype, device=v.device)
    c_add = torch.zeros((k,), dtype=dtype, device=v.device)
    w_add.index_add_(0, a[keep], (w32[:, None] * v32)[keep])
    c_add.index_add_(0, a[keep], w32[keep])
    return w_add, c_add


def ema_segment_sum_sliced_ref(v: torch.Tensor, assignment: torch.Tensor,
                               weight: torch.Tensor, k: int, slices: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ema_segment_sum_ref`` in the card kernel's summation order, on
    the CPU: the rows cut into ``slices`` equal slices, each slice's sums
    taken in row order (the CPU's ``index_add_``), the slices' sums added
    in slice order.  The result is on the CPU."""
    v, a, w = v.cpu(), assignment.cpu().long(), weight.cpu()
    wv = w[:, None] * v
    keep = (a >= 0) & (a < k)
    per = -(-v.shape[0] // slices)
    tw, tc = torch.zeros((k, v.shape[1])), torch.zeros((k,))
    for s in range(slices):
        rows = slice(s * per, (s + 1) * per)
        m = keep[rows]
        tw = tw + torch.zeros_like(tw).index_add_(0, a[rows][m], wv[rows][m])
        tc = tc + torch.zeros_like(tc).index_add_(0, a[rows][m], w[rows][m])
    return tw, tc


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      combiner: str = "sum") -> torch.Tensor:
    """table (V, d) fp32 or bf16, ids (B, bag) row indices in [0, V) ->
    (B, d) fp32: the sum of each row's ``bag`` table rows, divided by
    ``bag`` for ``combiner="mean"``.  The divisor is a tensor on the
    table's device, so the card divides too (PyTorch multiplies by the
    reciprocal of a host scalar), as the kernel does."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner {combiner!r}")
    s = table.to(torch.float32)[ids.long()].sum(-2)
    if combiner == "mean":
        return s / torch.tensor(float(ids.shape[-1]), device=s.device)
    return s


def split_bf16x3(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The bf16 flash_attention kernel's split of its fp32 probabilities
    (``csrc/flash_attention.cu``, ``split3``): ``p1 = bf16_rn(p)``, ``p2 =
    bf16_rn(p - p1)``, ``p3 = bf16_rn(p - p1 - p2)``, both subtractions
    exact in fp32.  The three 8-bit significands cover p's 24, so ``p1 +
    p2 + p3 == p`` exactly where p >= 2^-110 (below that the last part
    falls under bf16's smallest subnormal, 2^-133); the kernel's three
    tensor-core passes over the parts then take P.V with P in fp32.  Not
    on any path: it documents and tests the kernel's arithmetic."""
    p = p.to(torch.float32)
    p1 = p.to(torch.bfloat16)
    r = p - p1.to(torch.float32)
    p2 = r.to(torch.bfloat16)
    p3 = (r - p2.to(torch.float32)).to(torch.bfloat16)
    return p1, p2, p3


# a chunk of query rows of the plain attention keeps its fp32 logits under
# this many elements (each row's softmax is its own, so chunks change no
# arithmetic)
_ATTN_CHUNK_ELEMS = 2 ** 28


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain attention in fp32: logits ``(q . k^T) * hd^-0.5`` (the scale
    after the product, as the TPU kernel applies it), masked to -1e30
    where key j lies above query i's diagonal (j > i + T - S), softmax,
    times v, cast to q's dtype.  q, k, v (S, hd): one head, as the
    reference's ``flash_attention_ref``; or q (B, S, H, hd) with k, v
    (B, T, Hk, hd), query head h reading kv head h // (H // Hk)."""
    if q.dim() == 2:
        return flash_attention_ref(q[None, :, None], k[None, :, None],
                                   v[None, :, None], causal)[0, :, 0]
    b, s, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = hd ** -0.5
    q32 = q.to(torch.float32).reshape(b, s, hk, rep, hd).permute(0, 2, 3, 1, 4)
    k32 = k.to(torch.float32).permute(0, 2, 3, 1)            # (B, Hk, hd, T)
    v32 = v.to(torch.float32).permute(0, 2, 1, 3)            # (B, Hk, T, hd)
    out = torch.empty((b, hk, rep, s, hd), dtype=torch.float32,
                      device=q.device)
    kpos = torch.arange(t, device=q.device)
    rows = max(1, _ATTN_CHUNK_ELEMS // max(1, b * h * t))
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qc = q32[:, :, :, i0:i1].reshape(b, hk, rep * (i1 - i0), hd)
        logits = ((qc @ k32) * scale).reshape(b, hk, rep, i1 - i0, t)
        if causal:
            qpos = torch.arange(i0, i1, device=q.device) + (t - s)
            logits = logits.masked_fill(kpos[None, :] > qpos[:, None],
                                        -1e30)
        w = torch.softmax(logits, dim=-1).reshape(b, hk, rep * (i1 - i0), t)
        out[:, :, :, i0:i1] = (w @ v32).reshape(b, hk, rep, i1 - i0, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
