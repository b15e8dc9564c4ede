"""Labeled metric registry: one substrate for every telemetry source.

The port's copy of the reference's ``obs/registry.py``, without
``register_serve_stats`` (its ``ServeStats`` waits for ROADMAP.md item
A8).  Three instrument kinds:

  counter     monotone float, native (``inc``) or callback-backed
              (``counter_fn`` wraps an existing exact counter in place),
  gauge       point-in-time float, native (``set``) or callback-backed,
  histogram   a ``LatencyHistogram`` (registered as-is, so a recording
              path keeps recording into the object it already owns).

Labels are first-class: ``reg.counter("x_total", labels=("shard",))``
returns a family whose ``labels(shard="3")`` children are created on
demand.  ``register_collector`` covers dynamic families computed at
scrape time (the shadow-probe gauges of ``obs/quality.py``).

Two read views:

  ``snapshot()``        current value of everything (histograms as
                        ``HistogramSnapshot``),
  ``diff(prev)``        interval view between a past snapshot and now:
                        counter deltas and interval histograms
                        (``HistogramSnapshot.since``), i.e. rates and
                        "p99 over the last scrape period".

The registry never imports serving code: it duck-types over histogram
objects.
"""
from __future__ import annotations

import re
import threading
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

from repro_torch.obs.histogram import HistogramSnapshot, LatencyHistogram

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotone native counter (own lock -> exact under concurrency)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time native gauge."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


LabelDict = Dict[str, str]
# one exported time series: (label dict, float | HistogramSnapshot)
SeriesValue = Tuple[LabelDict, object]


class Family(NamedTuple):
    """One metric family ready for export."""
    name: str
    mtype: str                     # "counter" | "gauge" | "histogram"
    help: str
    series: List[SeriesValue]


class _Instrument:
    """Registered family of native / callback instruments."""

    def __init__(self, name: str, mtype: str, help_: str,
                 label_names: Tuple[str, ...], factory=None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.mtype = mtype
        self.help = help_
        self.label_names = label_names
        self._factory = factory
        self._fn = fn
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if factory is not None and not label_names:
            self._children[()] = factory()

    # -- label handling ----------------------------------------------------
    def labels(self, **kv: str):
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._factory()
            return child

    @property
    def default(self):
        """The unlabeled child (only for label-less families)."""
        if self.label_names:
            raise ValueError(f"{self.name} requires labels "
                             f"{self.label_names}")
        return self._children[()]

    # convenience passthroughs for the common unlabeled case
    def inc(self, n: float = 1.0) -> None:
        self.default.inc(n)

    def set(self, v: float) -> None:
        self.default.set(v)

    def record(self, seconds: float, n: int = 1) -> None:
        self.default.record(seconds, n)

    # -- reading -----------------------------------------------------------
    def _value_of(self, child) -> object:
        if hasattr(child, "snapshot"):           # histogram
            return child.snapshot()
        return child.value

    def family(self) -> Family:
        if self._fn is not None:
            return Family(self.name, self.mtype, self.help,
                          [({}, float(self._fn()))])
        with self._lock:
            items = sorted(self._children.items())
        series = [(dict(zip(self.label_names, key)), self._value_of(ch))
                  for key, ch in items]
        return Family(self.name, self.mtype, self.help, series)


Collector = Callable[[], Iterable[Family]]


class MetricRegistry:
    """Name-unique registry of instruments + scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Collector] = []

    # -- registration ------------------------------------------------------
    def _register(self, inst: _Instrument,
                  exist_ok: bool = False) -> _Instrument:
        _check_name(inst.name)
        for ln in inst.label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            have = self._instruments.get(inst.name)
            if have is not None:
                if exist_ok:
                    return have
                raise ValueError(f"metric {inst.name!r} already registered")
            self._instruments[inst.name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = (),
                exist_ok: bool = False) -> _Instrument:
        return self._register(
            _Instrument(name, "counter", help, tuple(labels), Counter),
            exist_ok)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              exist_ok: bool = False) -> _Instrument:
        return self._register(
            _Instrument(name, "gauge", help, tuple(labels), Gauge),
            exist_ok)

    def counter_fn(self, name: str, fn: Callable[[], float],
                   help: str = "", exist_ok: bool = False) -> _Instrument:
        """Callback counter: wraps an existing exact counter in place."""
        return self._register(
            _Instrument(name, "counter", help, (), fn=fn), exist_ok)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "",
                 exist_ok: bool = False) -> _Instrument:
        return self._register(
            _Instrument(name, "gauge", help, (), fn=fn), exist_ok)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  hist: Optional[LatencyHistogram] = None,
                  exist_ok: bool = False) -> _Instrument:
        """Register a (new or EXISTING) ``LatencyHistogram`` family.

        Passing ``hist`` adopts an already-recording histogram without
        copying or re-locking it.
        """
        if hist is not None and labels:
            raise ValueError("hist= and labels= are mutually exclusive")
        inst = _Instrument(name, "histogram", help, tuple(labels),
                           LatencyHistogram)
        if hist is not None:
            inst._children[()] = hist
        return self._register(inst, exist_ok)

    def register_collector(self, fn: Collector) -> Collector:
        """Scrape-time family source (dynamic labels, computed gauges)."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._instruments.pop(name, None) is not None

    # -- reading -----------------------------------------------------------
    def collect(self) -> List[Family]:
        """Every family, instruments first then collectors, name-sorted
        within each source for deterministic export."""
        with self._lock:
            insts = sorted(self._instruments.values(),
                           key=lambda i: i.name)
            collectors = list(self._collectors)
        fams = [i.family() for i in insts]
        for c in collectors:
            fams.extend(c())
        return fams

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{series key: {"type", "value"}}; histograms keep their
        ``HistogramSnapshot`` so ``diff`` can subtract buckets."""
        out: Dict[str, Dict[str, object]] = {}
        for fam in self.collect():
            for labels, value in fam.series:
                out[_series_key(fam.name, labels)] = dict(
                    type=fam.mtype, value=value)
        return out

    def diff(self, prev: Dict[str, Dict[str, object]]
             ) -> Dict[str, Dict[str, object]]:
        """Interval (rate) view vs a previous ``snapshot()``:

          counters    value - prev value (new series diff vs 0),
          gauges      current value (a gauge has no rate),
          histograms  interval snapshot via bucket subtraction.
        """
        cur = self.snapshot()
        out: Dict[str, Dict[str, object]] = {}
        for key, entry in cur.items():
            mtype, value = entry["type"], entry["value"]
            p = prev.get(key)
            if mtype == "counter":
                pv = float(p["value"]) if p else 0.0
                out[key] = dict(type=mtype, value=float(value) - pv)
            elif mtype == "histogram":
                pv = p["value"] if p else None
                out[key] = dict(type=mtype,
                                value=value.since(pv))
            else:
                out[key] = dict(type=mtype, value=value)
        return out

    def snapshot_jsonable(self) -> Dict[str, object]:
        """JSON-safe flattening (histograms -> summary dicts)."""
        return to_jsonable(self.snapshot())


def _series_key(name: str, labels: LabelDict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def to_jsonable(snap: Dict[str, Dict[str, object]]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, entry in snap.items():
        v = entry["value"]
        out[key] = v.to_dict() if isinstance(v, HistogramSnapshot) else v
    return out
