"""K-way chunked merge-sort serving (paper §3.4, Alg. 1, Fig. 2).

Per query, clusters are scored by u.Q(v_emb) and items inside a cluster
are pre-ranked by popularity bias, so each cluster's list is sorted by
the combined score u.Q(v_emb) + v_bias (Eq. 11) and the global top-S is a
k-way merge.  Alg. 1 pops the max-head cluster and takes a whole chunk of
its items per pop.  A heap pop is an argmax over the C head scores, so
the batched form below runs ``n_steps`` argmax pops for all queries at
once; the numpy heap oracle is kept for verification.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

NEG = -1e30


def merge_sort_serve_np(cluster_scores: np.ndarray,
                        bias_lists: np.ndarray,
                        lengths: np.ndarray,
                        chunk: int,
                        target: int) -> Tuple[np.ndarray, np.ndarray]:
    """Faithful Alg. 1 with a real heap, one query.

    cluster_scores: (C,) personality score per selected cluster.
    bias_lists: (C, L) per-cluster item biases sorted desc (padded).
    lengths: (C,) valid lengths.
    Returns (flat_positions, combined_scores) of <= target items; positions
    are c * L + i.
    """
    C, L = bias_lists.shape
    heap = []  # (-score, cluster)
    ptr = np.zeros(C, np.int64)
    for c in range(C):
        if lengths[c] > 0:
            heapq.heappush(
                heap, (-(cluster_scores[c] + bias_lists[c, 0]), c))
    out_pos, out_score = [], []
    while heap and len(out_pos) < target:
        _, c = heapq.heappop(heap)
        take = min(chunk, int(lengths[c]) - int(ptr[c]))
        for i in range(int(ptr[c]), int(ptr[c]) + take):
            out_pos.append(c * L + i)
            out_score.append(cluster_scores[c] + bias_lists[c, i])
        ptr[c] += take
        if ptr[c] < lengths[c]:
            heapq.heappush(
                heap, (-(cluster_scores[c] + bias_lists[c, ptr[c]]), c))
    out_pos = np.asarray(out_pos[:target], np.int64)
    out_score = np.asarray(out_score[:target], np.float64)
    return out_pos, out_score


def n_pops(c: int, chunk: int, target: int, exact: bool = True) -> int:
    """Pop budget: ceil(target/chunk), plus C when ``exact``.

    Each pop either yields a full chunk or exhausts one of the C clusters,
    so the exact budget reproduces the heap oracle; the inexact one is
    cheaper and may under-fill when many clusters hold < chunk items.
    """
    return -(-target // chunk) + (c if exact else 0)


def merge_sort_serve(cluster_scores: torch.Tensor,
                     bias_lists: torch.Tensor,
                     lengths: torch.Tensor,
                     chunk: int,
                     target: int,
                     exact: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Alg. 1: (B,C), (B,C,L), (B,C) -> ((B,target) pos, scores).

    Every pop takes the first-max head (the heap's lowest-cluster
    tie-break); the output is padded with (-1, NEG) where fewer than
    ``target`` items exist.  Valid chunks are compacted forward, stably.
    """
    B, C = cluster_scores.shape
    L = bias_lists.shape[-1]
    dev = cluster_scores.device
    cs = cluster_scores.to(torch.float32)
    bl = bias_lists.to(torch.float32)
    ln = lengths.to(torch.int64)
    rows = torch.arange(B, device=dev)
    ar = torch.arange(chunk, device=dev)
    ptr = torch.zeros((B, C), dtype=torch.int64, device=dev)
    n_out = torch.zeros((B,), dtype=torch.int64, device=dev)
    pos_all, sc_all = [], []
    for _ in range(n_pops(C, chunk, target, exact)):
        head_b = torch.gather(bl, 2, ptr.clamp(max=L - 1)[..., None])[..., 0]
        scores = torch.where(ptr < ln, cs + head_b, NEG)
        c = torch.argmax(scores, dim=1)
        idx = ptr[rows, c][:, None] + ar                      # (B, chunk)
        valid = ((idx < ln[rows, c][:, None])
                 & (scores[rows, c] > NEG / 2)[:, None]
                 & (n_out < target)[:, None])
        pos_all.append(torch.where(valid, c[:, None] * L + idx, -1))
        vals = bl[rows[:, None], c[:, None], idx.clamp(max=L - 1)]
        sc_all.append(torch.where(valid, cs[rows, c][:, None] + vals, NEG))
        ptr[rows, c] += chunk
        n_out += valid.sum(dim=1)
    pos = torch.cat(pos_all, dim=1)
    sc = torch.cat(sc_all, dim=1)
    order = torch.argsort((pos < 0).to(torch.int8), dim=1, stable=True)
    pos = torch.gather(pos, 1, order)[:, :target].to(torch.int32)
    sc = torch.gather(sc, 1, order)[:, :target]
    return pos, sc


def fused_gather_rank(u: torch.Tensor, cluster_scores: torch.Tensor,
                      starts: torch.Tensor, lengths: torch.Tensor,
                      limits: torch.Tensor, bias_flat: torch.Tensor,
                      ids_flat: torch.Tensor, emb_flat: torch.Tensor,
                      chunk: int, target: int, l: int, exact: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Batched fused Alg. 1: merge + candidate gather + Eq. 11 score.

    u: (B, d); cluster_scores, starts, lengths, limits: (B, C), ``starts``
    flat addresses into the index arrays and ``limits`` each lane's clamp
    bound; bias_flat, ids_flat: (N,); emb_flat: (N, d).  Each pop reads
    its chunk straight from the flat arrays at ``min(start_c + idx,
    limit_c)`` (no (B, C, L) slab) and scores it against ``u``.  Returns
    (pos, merge_scores, cand_ids, exact_scores), each (B, target), with
    pos encoded ``c * l + idx`` like ``merge_sort_serve``; invalid lanes
    are (-1, NEG, the id at the first cluster's first slot, NEG).
    """
    B, C = cluster_scores.shape
    dev = cluster_scores.device
    cs = cluster_scores.to(torch.float32)
    st = starts.to(torch.int64)
    ln = lengths.to(torch.int64)
    lim = limits.to(torch.int64)
    bias = bias_flat.to(torch.float32)
    emb = emb_flat.to(torch.float32)
    u32 = u.to(torch.float32)
    rows = torch.arange(B, device=dev)
    ar = torch.arange(chunk, device=dev)
    ptr = torch.zeros((B, C), dtype=torch.int64, device=dev)
    n_out = torch.zeros((B,), dtype=torch.int64, device=dev)
    head_b = bias[torch.minimum(st, lim)]
    # invalid lanes report the clip-to-first-slot id of the unfused gather
    id_clip = ids_flat[torch.minimum(st[:, 0], lim[:, 0])]
    outs = ([], [], [], [])
    for _ in range(n_pops(C, chunk, target, exact)):
        head_s = torch.where(ptr < ln, cs + head_b, NEG)
        c = torch.argmax(head_s, dim=1)
        base = ptr[rows, c]
        idx = base[:, None] + ar                              # (B, chunk)
        st_c, lim_c = st[rows, c][:, None], lim[rows, c][:, None]
        addr = torch.minimum(st_c + idx, lim_c)
        bias_v = bias[addr]
        dot_v = torch.einsum("bkd,bd->bk", emb[addr], u32)
        valid = ((idx < ln[rows, c][:, None])
                 & (head_s[rows, c] > NEG / 2)[:, None]
                 & (n_out < target)[:, None])
        outs[0].append(torch.where(valid, c[:, None] * l + idx, -1))
        outs[1].append(torch.where(valid, cs[rows, c][:, None] + bias_v, NEG))
        outs[2].append(torch.where(valid, ids_flat[addr], id_clip[:, None]))
        outs[3].append(torch.where(valid, dot_v + bias_v, NEG))
        head_b[rows, c] = bias[torch.minimum(st_c[:, 0] + base + chunk,
                                             lim_c[:, 0])]
        ptr[rows, c] += chunk
        n_out += valid.sum(dim=1)
    pos, sc, ids, rk = (torch.cat(o, dim=1) for o in outs)
    order = torch.argsort((pos < 0).to(torch.int8), dim=1, stable=True)
    keep = order[:, :target]
    return (torch.gather(pos, 1, keep).to(torch.int32),
            torch.gather(sc, 1, keep), torch.gather(ids, 1, keep),
            torch.gather(rk, 1, keep))


def full_sort_topk(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                   lengths: torch.Tensor, target: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``target`` over all (cluster, item) pairs (quality ref).

    (..., C), (..., C, L), (..., C) -> ((..., target) flat positions
    c * L + i, -1 where fewer items exist; (..., target) scores).  Ties go
    to the lower flat position, as ``lax.top_k`` breaks them.
    """
    L = bias_lists.shape[-1]
    combined = cluster_scores[..., None] + bias_lists
    mask = torch.arange(L, device=bias_lists.device) < lengths[..., None]
    flat = torch.where(mask, combined, NEG).flatten(-2)
    sc, pos = torch.sort(flat, dim=-1, descending=True, stable=True)
    sc, pos = sc[..., :target], pos[..., :target].to(torch.int32)
    return torch.where(sc > NEG / 2, pos, -1), sc
