"""Plain PyTorch versions of the hand-written kernels.

A kernel wrapper in ``ops.py`` runs these on CPU tensors; the CPU tests
hold them to the JAX package, and ``chip_smoke.py`` holds each kernel to
its plain version on the card.
"""
from __future__ import annotations

from typing import Tuple

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


def merge_serve_ref(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                    lengths: torch.Tensor, chunk: int, target: int,
                    exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Alg. 1 merge: the batched loop of pops."""
    from repro_torch.core import merge_sort
    return merge_sort.merge_sort_serve(cluster_scores, bias_lists, lengths,
                                       chunk, target, exact)


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
                        log_q: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row in-batch CE of Eq. 1 + Eq. 11 + logQ, with the softmax
    stats: z = u v^T + bias - logQ (B, B) -> (loss, m, l), where
    m = max_r z_or, l = sum_r exp(z_or - m) and
    loss = m + log(l) - z_oo."""
    z = _inbatch_logits(u, v, bias, log_q)
    m = torch.max(z, dim=-1).values
    l = torch.sum(torch.exp(z - m[:, None]), dim=-1)
    return m + torch.log(l) - torch.diagonal(z), m, l


def inbatch_softmax_bwd_ref(u: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, log_q: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """VJP of the per-row CE from the saved lse, with p = exp(z - lse):

        du_o    = g_o (sum_r p_or v_r - v_o)
        dv_r    = sum_o g_o p_or u_o  -  g_r u_r
        dbias_r = sum_o g_o p_or  -  g_r          (dlogq = -dbias)
    """
    u32, v32, g32 = _f32(u), _f32(v), _f32(g)
    p = torch.exp(_inbatch_logits(u, v, bias, log_q) - _f32(lse)[:, None])
    gp = g32[:, None] * p
    du = g32[:, None] * (p @ v32 - v32)
    dv = gp.T @ u32 - g32[:, None] * u32
    dbias = torch.sum(gp, dim=0) - g32
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
