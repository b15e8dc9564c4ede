"""Embedding tables and the hashed single-hot lookup of the recsys path."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.configs.base import EmbeddingSpec
from repro_torch.core.freq_estimator import hash_ids


def init_tables(gen: torch.Generator,
                specs: Sequence[EmbeddingSpec]) -> Dict[str, torch.Tensor]:
    return {s.name: torch.randn((s.vocab, s.dim), generator=gen,
                                device=gen.device) * (s.dim ** -0.5)
            for s in specs}


def lookup(table: torch.Tensor, ids: torch.Tensor,
           hashed: bool = True) -> torch.Tensor:
    """Single-hot lookup; ids of any shape -> (..., dim).

    ``hashed=True`` maps arbitrary id spaces into the table capacity with
    the multiplicative hash.
    """
    vocab = table.shape[0]
    idx = hash_ids(ids, vocab) if hashed else ids.long().clamp(0, vocab - 1)
    return table[idx]
