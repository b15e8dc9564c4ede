"""Lock-exact log-spaced latency histograms (the observability base).

The port's copy of the reference's ``obs/histogram.py``.
``LatencyHistogram`` keeps log-spaced buckets (8 per decade from 1 us to
~17 min) with an internal lock, so concurrent recorders stay EXACT:
after N threads record M samples each, ``count == N * M``.  Percentiles
are resolved to the bucket's upper edge, clamped by the exact maximum (a
conservative bound: the true quantile is <= the reported value).

Two lock-exact derived forms:

  ``snapshot()``   an immutable, JSON-normalizable copy taken under one
                   lock acquisition (empty histograms report ``min`` as
                   None instead of ``math.inf``),
  ``diff(prev)``   the INTERVAL histogram between a past snapshot and
                   now: bucket counts / count / sum are exactly the
                   samples recorded since ``prev`` was taken.

The interval's maximum is exact too, so an interval percentile equals
the percentile of a histogram that recorded only the interval's samples.
The reference clamps it by the lifetime maximum or the bucket edge
instead (ROADMAP.md C3), which is what this copy repairs: each bucket
keeps the stack of its suffix maxima, ``(position, value)`` pairs of
samples larger than every later sample of the bucket, where a sample's
position is the count once it was recorded.  The interval after ``prev``
starts after position ``prev.count``, and its maximum in a bucket is the
first stack entry past that position.  A stack holds at most ``KEEP``
entries (samples in no particular order keep about the logarithm of the
bucket's count); past that its oldest entry is dropped, and an interval
that begins before a dropped entry falls back to the bucket's upper
edge, still a bound from above.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

Stack = Tuple[Tuple[int, float], ...]
KEEP = 32          # suffix maxima a bucket keeps


def _bucket_percentile(counts, total: int, q: float, lo: float,
                       growth: float, max_cap: float) -> float:
    """Upper edge of the bucket holding the q-quantile (0 < q <= 1)."""
    if total == 0:
        return 0.0
    rank = max(1, math.ceil(q * total))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            # clamp the edge to the exact max (tighter + finite even
            # when the sample hit the unbounded last bucket)
            return min(lo * growth ** i, max_cap)
    return max_cap                               # pragma: no cover


class HistogramSnapshot(NamedTuple):
    """Immutable point-in-time copy of a ``LatencyHistogram``.

    ``min`` is None for an empty snapshot; ``max`` is 0.0.  ``since``
    outputs are also snapshots, with ``min`` resolved to a bucket edge
    and ``max`` exact.  ``tops`` and ``cut`` carry the per-bucket suffix
    maxima and the position of each bucket's last dropped entry (empty
    for a snapshot made by hand, whose interval maxima fall back to the
    bucket edges).
    """
    lo: float
    growth: float
    counts: Tuple[int, ...]
    count: int
    sum: float
    min: Optional[float]
    max: float
    tops: Tuple[Stack, ...] = ()
    cut: Tuple[int, ...] = ()

    def percentile(self, q: float) -> float:
        return _bucket_percentile(self.counts, self.count, q, self.lo,
                                  self.growth, self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, float]:
        return dict(count=self.count, mean_ms=self.mean * 1e3,
                    p50_ms=self.percentile(0.50) * 1e3,
                    p95_ms=self.percentile(0.95) * 1e3,
                    p99_ms=self.percentile(0.99) * 1e3,
                    min_ms=(self.min if self.min is not None else 0.0) * 1e3,
                    max_ms=self.max * 1e3)

    def _edge(self, bucket: int) -> float:
        return self.lo * self.growth ** bucket

    def _max_after(self, bucket: int, pos: int) -> float:
        """Largest sample of ``bucket`` recorded after position ``pos``
        (the bucket must hold one): exact while the stack reaches back
        that far, else the bucket's upper edge."""
        if self.tops and self.cut[bucket] <= pos:
            for p, value in self.tops[bucket]:
                if p > pos:
                    return value
        return min(self._edge(bucket), self.max)

    def since(self, prev: Optional["HistogramSnapshot"]
              ) -> "HistogramSnapshot":
        """Interval histogram: the samples recorded between ``prev`` (a
        snapshot of the same histogram) and this snapshot.  Bucket
        counts, ``count``, ``sum`` and ``max`` are exact; ``min`` is the
        lower edge of the lowest nonzero interval bucket.  ``prev=None``
        means the interval since the start: this snapshot."""
        if prev is None:
            return self
        if (prev.lo, prev.growth, len(prev.counts)) != \
                (self.lo, self.growth, len(self.counts)):
            raise ValueError("histogram bucket layouts differ")
        dcounts = tuple(c - p for c, p in zip(self.counts, prev.counts))
        if any(d < 0 for d in dcounts) or self.count < prev.count:
            raise ValueError("prev snapshot is not a prefix of this "
                             "histogram (was it reset?)")
        dcount = self.count - prev.count
        if dcount == 0:
            return HistogramSnapshot(self.lo, self.growth, dcounts, 0, 0.0,
                                     None, 0.0)
        nz = [i for i, d in enumerate(dcounts) if d]
        dmin = 0.0 if nz[0] == 0 else self._edge(nz[0] - 1)
        dmax = self._max_after(nz[-1], prev.count)
        tops = tuple(tuple(e for e in s if e[0] > prev.count)
                     for s in self.tops)
        return HistogramSnapshot(self.lo, self.growth, dcounts, dcount,
                                 self.sum - prev.sum, dmin, dmax, tops,
                                 self.cut)


class LatencyHistogram:
    """Lock-exact latency histogram over log-spaced buckets.

    Bucket 0 holds everything <= ``lo`` seconds; bucket i covers
    (lo * growth^(i-1), lo * growth^i]; the last bucket is unbounded
    above.  Exact count / sum / min / max ride along so the mean stays
    exact even though quantiles are bucket-resolved; the per-bucket
    suffix maxima make interval maxima exact.
    """

    def __init__(self, lo: float = 1e-6, growth: float = 10 ** 0.125,
                 n_buckets: int = 72):
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.counts: List[int] = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self._tops: List[List[Tuple[int, float]]] = \
            [[] for _ in range(n_buckets)]
        self._cut: List[int] = [0] * n_buckets
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def bucket_of(self, seconds: float) -> int:
        if seconds <= self.lo:
            return 0
        i = 1 + int(math.log(seconds / self.lo) / self._log_growth)
        return min(i, len(self.counts) - 1)

    def upper_edge(self, bucket: int) -> float:
        return self.lo * self.growth ** bucket

    def _push(self, bucket: int, value: float) -> None:
        """Record ``value`` as the bucket's newest sample, at position
        ``self.count`` (under the lock)."""
        stack = self._tops[bucket]
        while stack and stack[-1][1] <= value:
            stack.pop()
        stack.append((self.count, value))
        if len(stack) > KEEP:
            self._cut[bucket] = stack.pop(0)[0]

    def record(self, seconds: float, n: int = 1) -> None:
        """Record ``n`` identical samples of ``seconds`` (n > 1 is the
        delta-batch case: every item in the batch became retrievable at
        the same publish instant)."""
        if n <= 0:
            return
        seconds = max(float(seconds), 0.0)
        b = self.bucket_of(seconds)
        with self._lock:
            self.counts[b] += n
            self.count += n
            self.sum += seconds * n
            if seconds < self.min:
                self.min = seconds
            if seconds > self.max:
                self.max = seconds
            self._push(b, seconds)

    # -- reading -----------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (0 < q <= 1)."""
        with self._lock:
            return _bucket_percentile(self.counts, self.count, q, self.lo,
                                      self.growth, self.max)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into self (matching bucket layout required).
        Its samples count as recorded now, each bucket's largest as the
        bucket's newest sample."""
        if other is self:
            raise ValueError("cannot merge a histogram into itself")
        if (other.lo, other.growth, len(other.counts)) != \
                (self.lo, self.growth, len(self.counts)):
            raise ValueError("histogram bucket layouts differ")
        # deterministic lock order (by object id) so concurrent
        # a.merge(b) / b.merge(a) cannot ABBA-deadlock
        first, second = sorted((self._lock, other._lock), key=id)
        with first, second:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            for i, c in enumerate(other.counts):
                if c:
                    top = (other._tops[i][0][1] if other._cut[i] == 0
                           else min(other.upper_edge(i), other.max))
                    self._push(i, top)

    def snapshot(self) -> HistogramSnapshot:
        """Immutable copy under ONE lock acquisition (so count / sum /
        buckets are mutually consistent even with concurrent recorders).
        Empty-histogram ``min`` normalizes to None (JSON-safe)."""
        with self._lock:
            return HistogramSnapshot(
                lo=self.lo, growth=self.growth, counts=tuple(self.counts),
                count=self.count, sum=self.sum,
                min=None if self.count == 0 else self.min,
                max=self.max if self.count else 0.0,
                tops=tuple(tuple(s) for s in self._tops),
                cut=tuple(self._cut))

    def diff(self, prev: Optional[HistogramSnapshot]) -> HistogramSnapshot:
        """Interval histogram: samples recorded since ``prev`` was taken
        (``HistogramSnapshot.since``); ``prev=None`` means "diff against
        empty" == ``snapshot()``."""
        return self.snapshot().since(prev)

    def to_dict(self) -> Dict[str, float]:
        return self.snapshot().to_dict()
