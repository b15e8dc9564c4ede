"""Streaming item-frequency estimation (Yi et al., RecSys'19).

Two fixed-capacity hashed arrays per id space:
  A[h(id)] = global step when id was last sampled
  B[h(id)] = EMA estimate of the sampling interval delta

On each occurrence at step t:  B <- (1-gamma)*B + gamma*(t - A);  A <- t.
p(id) ~= 1/B[h(id)] feeds the logQ correction of the in-batch softmax and
the popularity term delta^beta of the EMA (Eq. 7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def last_of_slot(slots: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mask of the rows that are the last to hash to their slot: the rows
    a scatter-last keeps (a CUDA ``index_put_`` with repeated indices
    writes in no fixed order, so only these are scattered)."""
    rows = torch.arange(slots.shape[0], device=slots.device)
    last = torch.full((capacity,), -1, dtype=torch.int64,
                      device=slots.device)
    last.scatter_reduce_(0, slots, rows, reduce="amax")
    return last[slots] == rows


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


def lookup_delta(state: FreqState, ids: torch.Tensor) -> torch.Tensor:
    """Current interval estimate delta for each id (before update)."""
    return state.interval[hash_ids(ids, state.capacity)]


def update(state: FreqState, ids: torch.Tensor, step,
           gamma: float = 0.05, valid: Optional[torch.Tensor] = None
           ) -> Tuple[FreqState, torch.Tensor]:
    """Record occurrences of ``ids`` at ``step``; returns (state, delta).

    delta is the post-update interval estimate of each row.  Rows that
    share a slot read the same old state, so with ``valid=None`` they all
    write the same value and the scatter order does not matter.  With a
    mask, only the last row of each slot is scattered (the reference's
    scatter-last).
    """
    slots = hash_ids(ids, state.capacity)
    t = torch.as_tensor(step, dtype=torch.float32, device=slots.device)
    prev_seen = state.last_seen[slots]
    prev_int = state.interval[slots]
    observed = torch.clamp(t - prev_seen, min=1.0)
    # first occurrence (last_seen == 0): keep the prior interval estimate
    fresh = prev_seen <= 0.0
    new_int = torch.where(fresh, prev_int,
                          (1.0 - gamma) * prev_int + gamma * observed)
    write_int, write_seen = new_int, t.expand_as(prev_seen)
    if valid is not None:
        write_int = torch.where(valid, new_int, prev_int)
        write_seen = torch.where(valid, t, prev_seen)
        keep = last_of_slot(slots, state.capacity)
        slots, write_int, write_seen = (slots[keep], write_int[keep],
                                        write_seen[keep])
    last_seen = state.last_seen.clone()
    interval = state.interval.clone()
    last_seen[slots] = write_seen
    interval[slots] = write_int
    return FreqState(last_seen=last_seen, interval=interval), new_int


def log_q(delta: torch.Tensor) -> torch.Tensor:
    """log sampling probability: log p = -log delta."""
    return -torch.log(torch.clamp(delta, min=1e-6))
