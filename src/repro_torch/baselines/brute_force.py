"""Brute-force MIPS oracle: exact top-k over the full corpus.

Ground truth for the recall readings and the shadow probes, and the
``retrieval_cand`` scoring path (one query against 10^6 candidates).  On
a CUDA tensor ``mips_topk`` launches the hand-written ``topk_dot`` kernel
(``kernels/csrc/topk_dot.cu``); on a CPU tensor it runs its plain version.

This module also keeps the port's copy of the cross-retriever ordering
contract (``order_desc_stable`` / ``search_topk``): scores descending,
ties broken by ascending item id, in numpy, bitwise the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


def mips_topk(u: torch.Tensor, items: torch.Tensor,
              bias: Optional[torch.Tensor], k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, d); items: (N, d); bias: (N,) or None (zero) -> (B, k)
    values fp32 and (B, k) int32 ids, by descending u.item + bias, ties
    to the lower slot (as ``lax.top_k``)."""
    if bias is None:
        bias = torch.zeros(items.shape[0], dtype=torch.float32,
                           device=items.device)
    return ops.topk_dot(u, items, bias, k, block_n=None)


def order_desc_stable(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Permutation sorting ``scores`` DESC with ties by ASCENDING id
    (finite scores assumed): ``np.lexsort`` sorts by the last key first."""
    scores = np.asarray(scores, np.float64)
    ids = np.asarray(ids)
    return np.lexsort((ids, -scores))


def search_topk(u: np.ndarray, items: np.ndarray,
                bias: Optional[np.ndarray], k: int,
                ids: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact MIPS top-k under the cross-retriever ordering contract.

    u: (B, d); items: (N, d); bias: (N,) or None; ``ids`` maps corpus
    positions to item ids (default ``arange(N)``).  Returns ((B, k) ids
    int64, (B, k) scores f64), scores descending, ties by ascending id
    (not position), in float64 numpy.
    """
    vals = np.asarray(u, np.float64) @ np.asarray(items, np.float64).T
    if bias is not None:
        vals = vals + np.asarray(bias, np.float64)[None, :]
    pos_ids = (np.arange(items.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64))
    out_ids = np.empty((vals.shape[0], k), np.int64)
    out_scores = np.empty((vals.shape[0], k), np.float64)
    for i in range(vals.shape[0]):
        order = order_desc_stable(vals[i], pos_ids)[:k]
        out_ids[i] = pos_ids[order]
        out_scores[i] = vals[i][order]
    return out_ids, out_scores


def recall_at_k(retrieved, truth) -> float:
    """retrieved: (B, K) ids; truth: (B, K*) ground-truth ids -> the share
    of truth ids retrieved, over all rows."""
    r = np.asarray(retrieved)
    t = np.asarray(truth)
    hits = sum(len(set(r[i].tolist()) & set(t[i].tolist()))
               for i in range(r.shape[0]))
    return hits / max(r.shape[0] * t.shape[1], 1)
