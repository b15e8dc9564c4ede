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
