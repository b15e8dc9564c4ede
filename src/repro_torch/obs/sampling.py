"""Deterministic counter sampling — ONE decision shape for every
sampled observability surface.

The reference's request tracer (``obs/trace.py``, not ported yet:
ROADMAP.md item A8) and the shadow-probe sampler (``obs/quality.py``)
need the same primitive: "take every k-th event",
decided by a shared atomic counter rather than a PRNG, so

  - tests and benchmarks are exactly reproducible (event i is sampled
    iff ``i % k == 0``, no seed plumbing),
  - two samplers constructed with the same ``every`` pick the SAME
    event indices — a traced request and a quality probe of the same
    serve call coincide, so a recall regression surfaced by a probe
    comes with the span breakdown of the very request that showed it,
  - a single sampler can be SHARED outright (``Tracer(sampler=s)`` +
    ``QualityProber(sampler=s)``), in which case one ``should_sample``
    call per request decides both (the service makes one decision and
    fans it out).

``itertools.count`` is a C-level atomic iterator under CPython, so
``should_sample`` is thread-safe without a lock and adds one increment
plus one modulo to the hot path.
"""
from __future__ import annotations

import itertools


class CounterSampler:
    """Every ``every``-th call to ``should_sample`` returns True.

    ``every=1`` samples everything; ``enabled=False`` short-circuits to
    False without consuming a tick (so disabling one consumer does not
    shift the phase of another sampler created with the same period).
    """

    __slots__ = ("every", "enabled", "_tick")

    def __init__(self, every: int = 1, enabled: bool = True):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.every = every
        self.enabled = enabled
        self._tick = itertools.count()

    def should_sample(self) -> bool:
        """One deterministic sampling decision (call once per event)."""
        if not self.enabled:
            return False
        return next(self._tick) % self.every == 0

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        return (f"CounterSampler(every={self.every}, "
                f"enabled={self.enabled})")
