"""Observability: the parts of the reference's ``obs/`` package the port
has copied so far.

  ``histogram``  lock-exact log-spaced latency histograms, their
                 immutable snapshots and exact interval diffs,
  ``sampling``   deterministic counter sampling,
  ``registry``   labeled counter/gauge/histogram registry with snapshot
                 and interval-rate views,
  ``quality``    shadow recall probes: sampled serves re-scored against
                 the exact MIPS oracle off the hot path, windowed
                 Recall@K / score-gap / contribution estimators.

Tracing, index health, SLOs and the exporter wait for ROADMAP.md item A8.
"""
from repro_torch.obs.histogram import HistogramSnapshot, LatencyHistogram
from repro_torch.obs.quality import (
    ContributionEstimator,
    OracleAnswer,
    ProbeJob,
    ProbeResult,
    QualityProber,
    WindowedStat,
    probe_metrics,
)
from repro_torch.obs.registry import (
    Counter,
    Family,
    Gauge,
    MetricRegistry,
    to_jsonable,
)
from repro_torch.obs.sampling import CounterSampler

__all__ = [
    "ContributionEstimator",
    "Counter",
    "CounterSampler",
    "Family",
    "Gauge",
    "HistogramSnapshot",
    "LatencyHistogram",
    "MetricRegistry",
    "OracleAnswer",
    "ProbeJob",
    "ProbeResult",
    "QualityProber",
    "WindowedStat",
    "probe_metrics",
    "to_jsonable",
]
