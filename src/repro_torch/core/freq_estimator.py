"""Streaming item-frequency estimation state and the id hash (serving
needs only ``hash_ids``; the update rule is ported with the train step).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Knuth multiplicative hashing constant (fits in uint32).
_HASH_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def hash_ids(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Multiply-shift hash of int ids into [0, capacity) (int64).

    The uint32 wrapping multiply of the reference is done in int64: a
    negative id hashes as its uint32 wrap, and the 32x32-bit product is
    split in two 16-bit halves of the constant so no int64 overflows.
    """
    x = ids.to(torch.int64) & _MASK32
    lo = x * (_HASH_MULT & 0xFFFF)
    hi = ((x * (_HASH_MULT >> 16)) & 0xFFFF) << 16
    h = (lo + hi) & _MASK32
    h = h ^ (h >> 16)
    return h % capacity


class FreqState(NamedTuple):
    last_seen: torch.Tensor  # (capacity,) float32 step of last occurrence
    interval: torch.Tensor   # (capacity,) float32 EMA'd interval (delta)

    @property
    def capacity(self) -> int:
        return self.last_seen.shape[0]


def init_freq(capacity: int, init_interval: float = 1000.0,
              device=None) -> FreqState:
    return FreqState(
        last_seen=torch.zeros((capacity,), dtype=torch.float32,
                              device=device),
        interval=torch.full((capacity,), init_interval,
                            dtype=torch.float32, device=device))
