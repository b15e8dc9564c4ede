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
