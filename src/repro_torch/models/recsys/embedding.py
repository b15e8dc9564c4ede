"""Embedding tables and the bag lookups of the recsys path.

``lookup`` is the hashed single-hot lookup; ``embedding_bag`` the
fixed-size multi-hot bag (nn.EmbeddingBag on rectangular bags), which
goes through the ``embedding_bag`` kernel (``kernels/ops.py``) when it
has neither per-id weights nor a validity mask; ``embedding_bag_ragged``
the CSR-style ragged bag.  The mesh-only helpers of the reference
(``table_partition_spec``, ``lookup_manual_psum``, ``constrain_tables``)
wait for ROADMAP.md item A9.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import EmbeddingSpec
from repro_torch.core.freq_estimator import hash_ids
from repro_torch.kernels import ops as kops


def init_device(gen: torch.Generator, device=None) -> torch.device:
    """The device a recsys family's ``init`` builds on: ``cuda`` unless
    ``device`` names another (no card and none named raises).  ``gen``
    draws every weight and must lie on that device."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, init on {device}")
    return device


def init_tables(gen: torch.Generator, specs: Sequence[EmbeddingSpec],
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """N(0, 1/dim) tables, drawn in fp32 on the generator's device and
    scaled in place (a full-width table is not copied)."""
    out = {}
    for s in specs:
        t = torch.randn((s.vocab, s.dim), generator=gen, device=gen.device)
        out[s.name] = t.mul_(s.dim ** -0.5).to(dtype)
    return out


def _rows(table: torch.Tensor, ids: torch.Tensor,
          hashed: bool) -> torch.Tensor:
    """Table rows of ``ids``: hashed into [0, V), or clamped into it."""
    vocab = table.shape[0]
    return hash_ids(ids, vocab) if hashed else ids.long().clamp(0, vocab - 1)


def lookup(table: torch.Tensor, ids: torch.Tensor,
           hashed: bool = True) -> torch.Tensor:
    """Single-hot lookup; ids of any shape -> (..., dim).

    ``hashed=True`` maps arbitrary id spaces into the table capacity with
    the multiplicative hash.
    """
    return table[_rows(table, ids, hashed)]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum",
                  weights: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None,
                  hashed: bool = True) -> torch.Tensor:
    """Fixed-size bag lookup: ids (..., bag) -> (..., dim).

    Without ``weights`` and ``valid`` the bag goes through the
    ``embedding_bag`` kernel, which sums in fp32, and comes out in the
    table's dtype as the reference's does; with either, through torch ops
    as the reference computes it (the kernel has neither): rows scaled by
    ``weights``, rows where ``valid`` is False left out and the mean
    taken over the valid ones (at least 1).
    """
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner {combiner!r}")
    rows = _rows(table, ids, hashed)
    if weights is None and valid is None:
        bag = ids.shape[-1]
        out = kops.embedding_bag(table, rows.reshape(-1, bag), combiner)
        return out.to(table.dtype).reshape(*ids.shape[:-1], table.shape[1])
    emb = table[rows]                                     # (..., bag, d)
    if weights is not None:
        emb = emb * weights[..., None]
    denom = ids.shape[-1]
    if valid is not None:
        emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
        denom = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
    s = torch.sum(emb, dim=-2)
    return s / denom if combiner == "mean" else s


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, n_segments: int,
                         combiner: str = "sum",
                         weights: Optional[torch.Tensor] = None,
                         hashed: bool = True) -> torch.Tensor:
    """Ragged EmbeddingBag: CSR-style (values, segment_ids) -> (n, dim).
    Segment ids outside [0, n_segments) add nothing (``segment_sum``'s
    rule); an empty segment's mean is 0."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner {combiner!r}")
    emb = lookup(table, flat_ids, hashed)
    if weights is not None:
        emb = emb * weights[:, None]
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < n_segments)
    seg = seg[keep]
    s = torch.zeros((n_segments, emb.shape[-1]), dtype=emb.dtype,
                    device=emb.device).index_add_(0, seg, emb[keep])
    if combiner == "sum":
        return s
    cnt = torch.zeros((n_segments,), dtype=torch.float32,
                      device=emb.device).index_add_(
        0, seg, torch.ones(seg.shape, dtype=torch.float32, device=emb.device))
    return s / torch.clamp(cnt, min=1.0)[:, None]
