"""Shadow recall probes: live retrieval QUALITY, measured online.

The port's copy of the reference's ``obs/quality.py``.  Latency and
occupancy do not show whether the served candidates are the RIGHT
candidates: a drifting codebook or a stale index degrades Recall@K while
every serve still returns ``candidates_out`` ids.  This module audits the
index against an exact oracle, as scrape-able numbers:

  shadow probing
    ``QualityProber`` deterministically samples live ``serve_batch``
    calls (the ``obs/sampling.py`` counter decision) and re-scores them
    OFF the hot path: a bounded queue feeds one worker thread that
    replays each sampled query against the exact brute-force MIPS oracle
    (``baselines/brute_force.py``, wired in by the serving layer as the
    ``oracle_fn`` callback; this module never imports serving code).
    The serve path pays one enqueue; a full queue drops the probe and
    counts it, never blocks.  An oracle that raises is counted
    (``n_errors``) and the worker goes on.

  streaming estimators (all windowed, so they respond to drift)
    Recall@K          fraction of the oracle's top-k the serve output
                      retrieved, per probed query row, with sample
                      counts and a 95% confidence interval,
    score gap         mean oracle top-k exact score minus mean served
                      top-k exact score (Eq. 11 scoring on both sides;
                      0 when retrieval is perfect),
    contribution      per-cluster / per-shard share of served
                      candidates: normalized entropy, max share, and
                      labeled per-shard ratios.

Everything is registered into a ``MetricRegistry`` via ``register()``
(gauges + counters + a probe-lag histogram).
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.registry import Family, MetricRegistry
from repro_torch.obs.sampling import CounterSampler


class ProbeJob(NamedTuple):
    """One sampled serve() call, captured as host arrays.

    ``served_ids`` / ``served_valid`` are the final ranked output
    (``item_ids`` / ``valid``); ``served_exact`` carries the exact
    Eq. 11 scores the serve path already computed for its candidate set
    (merge order — order does not matter to the estimators, membership
    and magnitude do).  ``n_valid`` excludes the micro-batcher's bucket
    padding rows (the batcher probe tagging: padded rows repeat row 0
    and would double-count its contribution).
    """
    batch: Dict[str, np.ndarray]       # the query batch (host copies)
    served_ids: np.ndarray             # (B, S) int — final ranked ids
    served_valid: np.ndarray           # (B, S) bool
    served_exact: np.ndarray           # (B, S) float — Eq. 11 scores
    task: int
    generation: int                    # index epoch that served it
    t_serve: float                     # time.monotonic() at serve
    n_valid: Optional[int] = None      # leading real rows (batcher pad)


class OracleAnswer(NamedTuple):
    """What the serving layer's ``oracle_fn(job)`` must return.

    ``exact_ids``/``exact_scores`` are the brute-force MIPS top-k over
    the live corpus for the job's queries ((B, k) each, k = the
    oracle's choice, typically ``QualityProber.k``).  ``cluster_of`` is
    the per-served-candidate owning cluster ((B, S) int, -1 where the
    candidate is invalid/unknown), used for contribution accounting;
    ``shard_of`` is optional ((B, S) int) for sharded deployments.
    The callback MUST read its corpus snapshot consistently (the
    service reads store + generation under its locks) — the estimators
    trust it never to see a half-published index.
    """
    exact_ids: np.ndarray
    exact_scores: np.ndarray
    cluster_of: np.ndarray
    n_clusters: int
    shard_of: Optional[np.ndarray] = None
    n_shards: int = 0


class ProbeResult(NamedTuple):
    """Per-job metrics (row-mean recall/gap + contribution counts)."""
    n_rows: int
    recalls: np.ndarray                # (rows,) per-query Recall@K
    gaps: np.ndarray                   # (rows,) per-query score gap
    cluster_counts: np.ndarray         # (n_clusters,) served-candidate
    shard_counts: Optional[np.ndarray]


class WindowedStat:
    """Sliding-window mean / CI over per-query samples (lock-exact).

    Keeps the last ``window`` scalar samples in a deque plus running
    window sum / sum-of-squares (O(1) update), and lifetime count.  The
    95% CI uses the normal approximation ``mean ± 1.96 * sqrt(var/n)``
    — honest for the >=30-sample windows probes accumulate quickly.
    """

    def __init__(self, window: int = 512):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._lock = threading.Lock()
        self._buf: Deque[float] = collections.deque()
        self._sum = 0.0
        self._sumsq = 0.0
        self.lifetime_count = 0

    def update(self, values: np.ndarray) -> None:
        with self._lock:
            for v in np.asarray(values, np.float64).ravel():
                v = float(v)
                self._buf.append(v)
                self._sum += v
                self._sumsq += v * v
                if len(self._buf) > self.window:
                    old = self._buf.popleft()
                    self._sum -= old
                    self._sumsq -= old * old
                self.lifetime_count += 1

    def snapshot(self) -> Dict[str, float]:
        """{mean, ci_low, ci_high, stderr, n, lifetime} (n = window)."""
        with self._lock:
            n = len(self._buf)
            if n == 0:
                return dict(mean=0.0, ci_low=0.0, ci_high=0.0,
                            stderr=0.0, n=0,
                            lifetime=self.lifetime_count)
            mean = self._sum / n
            var = max(self._sumsq / n - mean * mean, 0.0)
            # sample variance (n-1) once there is more than one sample
            if n > 1:
                var = var * n / (n - 1)
            stderr = math.sqrt(var / n)
            half = 1.96 * stderr
            return dict(mean=mean, ci_low=mean - half,
                        ci_high=mean + half, stderr=stderr, n=n,
                        lifetime=self.lifetime_count)

    @property
    def mean(self) -> float:
        return self.snapshot()["mean"]


class ContributionEstimator:
    """Windowed per-bucket candidate-contribution shares (MERGE signal).

    Accumulates per-probe bucket count vectors (cluster or shard) over
    the last ``window`` probes with an O(buckets) incremental update.
    ``ratios()`` is each bucket's share of all served candidates in the
    window; ``entropy_ratio`` is the share distribution's entropy
    normalized by ln(buckets) (1.0 = perfectly even contribution, the
    balance property §3.2 predicts; a collapse toward one mega
    contributor shows up as a falling entropy ratio and a rising
    ``max_ratio`` before recall visibly moves).
    """

    def __init__(self, window: int = 512):
        self.window = window
        self._lock = threading.Lock()
        self._buf: Deque[np.ndarray] = collections.deque()
        self._total: Optional[np.ndarray] = None

    def update(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts, np.int64)
        with self._lock:
            if self._total is None or self._total.shape != counts.shape:
                # bucket space changed (resharded / new cluster count):
                # restart the window rather than mix incompatible vectors
                self._buf.clear()
                self._total = np.zeros_like(counts)
            self._buf.append(counts)
            self._total = self._total + counts
            if len(self._buf) > self.window:
                self._total = self._total - self._buf.popleft()

    def ratios(self) -> np.ndarray:
        with self._lock:
            if self._total is None:
                return np.zeros(0)
            tot = int(self._total.sum())
            if tot == 0:
                return np.zeros_like(self._total, np.float64)
            return self._total.astype(np.float64) / tot

    def snapshot(self) -> Dict[str, float]:
        r = self.ratios()
        nz = r[r > 0]
        n = int(r.size)
        entropy = float(-(nz * np.log(nz)).sum()) if nz.size else 0.0
        return dict(
            n_buckets=float(n),
            max_ratio=float(r.max(initial=0.0)),
            entropy=entropy,
            entropy_ratio=entropy / math.log(n) if n > 1 else 0.0,
            active_buckets=float((r > 0).sum()),
        )


def probe_metrics(job: ProbeJob, ans: OracleAnswer, k: int) -> ProbeResult:
    """Pure numpy scoring of one probe against the oracle answer."""
    rows = job.served_ids.shape[0] if job.n_valid is None \
        else min(job.n_valid, job.served_ids.shape[0])
    served_ids = np.asarray(job.served_ids)[:rows]
    valid = np.asarray(job.served_valid, bool)[:rows]
    served_exact = np.asarray(job.served_exact, np.float64)[:rows]
    exact_ids = np.asarray(ans.exact_ids)[:rows, :k]
    exact_scores = np.asarray(ans.exact_scores, np.float64)[:rows, :k]

    recalls = np.empty(rows, np.float64)
    gaps = np.empty(rows, np.float64)
    for i in range(rows):
        got = set(served_ids[i][valid[i]].tolist())
        want = exact_ids[i].tolist()
        recalls[i] = (sum(1 for w in want if w in got)
                      / max(len(want), 1))
        # top-k served exact scores vs the oracle's top-k, truncated to
        # the served row's valid count so a short row is compared
        # against the same number of oracle entries (no NEG padding
        # leaking into the mean)
        sv = np.sort(served_exact[i][valid[i]])[::-1]
        m = min(k, sv.size)
        if m == 0:
            gaps[i] = float(exact_scores[i].mean()) if k else 0.0
            continue
        gaps[i] = float(exact_scores[i][:m].mean() - sv[:m].mean())

    clof = np.asarray(ans.cluster_of)[:rows]
    mask = valid & (clof >= 0)
    cluster_counts = np.bincount(clof[mask].ravel(),
                                 minlength=ans.n_clusters)
    shard_counts = None
    if ans.shard_of is not None and ans.n_shards:
        shof = np.asarray(ans.shard_of)[:rows]
        smask = valid & (shof >= 0)
        shard_counts = np.bincount(shof[smask].ravel(),
                                   minlength=ans.n_shards)
    return ProbeResult(n_rows=rows, recalls=recalls, gaps=gaps,
                       cluster_counts=cluster_counts,
                       shard_counts=shard_counts)


class QualityProber:
    """Async shadow-probe pipeline: sample -> enqueue -> oracle -> gauges.

    ``oracle_fn(job) -> OracleAnswer`` is supplied by the serving layer
    (see ``RetrievalService.enable_probes``) and runs ONLY on the
    private worker thread, so the exact-oracle matmul never shares the
    hot path.  ``submit`` is the only serve-path call: one sampling
    check plus (for sampled requests) one bounded-queue append; when
    the queue is full the probe is dropped and counted
    (``n_dropped``), the serve is never blocked.

    Estimator updates happen on the worker; reads (``snapshot``,
    registry collectors) are lock-exact against it.
    """

    def __init__(self, oracle_fn: Callable[[ProbeJob], OracleAnswer],
                 k: int = 20, sample_every: int = 1,
                 sampler: Optional[CounterSampler] = None,
                 window: int = 512, max_queue: int = 64,
                 enabled: bool = True):
        if k < 1:
            raise ValueError("k must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.oracle_fn = oracle_fn
        self.k = k
        self.enabled = enabled
        self.sampler = sampler if sampler is not None \
            else CounterSampler(every=sample_every)
        self.sample_every = self.sampler.every
        self.max_queue = max_queue
        self.recall = WindowedStat(window)
        self.score_gap = WindowedStat(window)
        self.cluster_contribution = ContributionEstimator(window)
        self.shard_contribution = ContributionEstimator(window)
        self.probe_lag = LatencyHistogram()
        # counters (mutated under _cond's lock -> exact)
        self.n_sampled = 0
        self.n_scored = 0                  # probes fully scored
        self.n_rows_scored = 0             # query rows folded in
        self.n_dropped = 0                 # queue-full drops
        self.n_errors = 0                  # oracle_fn raised
        self._cond = threading.Condition()
        self._queue: Deque[ProbeJob] = collections.deque()
        self._inflight = 0                 # queued + being scored
        self._closed = False
        self._clock = None                 # test seam (monotonic)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="quality-prober")
        self._worker.start()

    # -- serve-path side ---------------------------------------------------
    def should_sample(self) -> bool:
        """One deterministic decision per serve call (counter-shared
        with the tracer when constructed over the same sampler)."""
        if not self.enabled:
            return False
        return self.sampler.should_sample()

    def submit(self, job: ProbeJob) -> bool:
        """Enqueue a sampled serve for shadow scoring; False = dropped."""
        with self._cond:
            if self._closed:
                return False
            self.n_sampled += 1
            if len(self._queue) >= self.max_queue:
                self.n_dropped += 1
                return False
            self._queue.append(job)
            self._inflight += 1
            self._cond.notify_all()
        return True

    # -- worker side -------------------------------------------------------
    def _now(self) -> float:
        import time
        return time.monotonic() if self._clock is None else self._clock()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                job = self._queue.popleft()
            try:
                ans = self.oracle_fn(job)
                res = probe_metrics(job, ans, self.k)
                self.recall.update(res.recalls)
                self.score_gap.update(res.gaps)
                self.cluster_contribution.update(res.cluster_counts)
                if res.shard_counts is not None:
                    self.shard_contribution.update(res.shard_counts)
                self.probe_lag.record(max(self._now() - job.t_serve, 0.0))
                with self._cond:
                    self.n_scored += 1
                    self.n_rows_scored += res.n_rows
            except Exception:
                with self._cond:
                    self.n_errors += 1
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted probe is scored (tests/benches)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    def close(self) -> None:
        """Finish queued probes, then stop the worker (idempotent)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    def __enter__(self) -> "QualityProber":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly estimator view (benchmarks / dashboards)."""
        with self._cond:
            counters = dict(n_sampled=self.n_sampled,
                            n_scored=self.n_scored,
                            n_rows_scored=self.n_rows_scored,
                            n_dropped=self.n_dropped,
                            n_errors=self.n_errors,
                            queue_depth=len(self._queue))
        return dict(
            k=self.k, sample_every=self.sample_every, **counters,
            recall=self.recall.snapshot(),
            score_gap=self.score_gap.snapshot(),
            cluster_contribution=self.cluster_contribution.snapshot(),
            shard_contribution=self.shard_contribution.snapshot(),
            probe_lag=self.probe_lag.to_dict(),
        )

    def register(self, reg: MetricRegistry,
                 namespace: str = "svq") -> MetricRegistry:
        """Export the probe estimators through a registry collector.

        Series (all under ``{namespace}_probe_``): windowed Recall@K
        mean + CI bounds + window sample count, score gap mean + CI,
        contribution entropy-ratio / max-share (cluster and, when
        sharded, per-shard labeled shares), pipeline counters, and the
        serve->scored lag histogram.
        """
        ns = namespace
        prober = self

        def _collect() -> List[Family]:
            fams: List[Family] = []

            def g(name: str, value: float, help_: str = "") -> None:
                fams.append(Family(f"{ns}_{name}", "gauge", help_,
                                   [({}, float(value))]))

            rec = prober.recall.snapshot()
            g("probe_recall", rec["mean"],
              f"windowed shadow-probe Recall@{prober.k} vs the exact "
              "MIPS oracle")
            g("probe_recall_ci_low", rec["ci_low"])
            g("probe_recall_ci_high", rec["ci_high"])
            g("probe_recall_window", rec["n"],
              "query rows in the recall window")
            gap = prober.score_gap.snapshot()
            g("probe_score_gap", gap["mean"],
              "mean oracle-top-k minus served-top-k exact score")
            g("probe_score_gap_ci_high", gap["ci_high"])
            cc = prober.cluster_contribution.snapshot()
            g("probe_contribution_entropy_ratio", cc["entropy_ratio"],
              "normalized entropy of per-cluster candidate contribution")
            g("probe_contribution_max_ratio", cc["max_ratio"],
              "largest single-cluster share of served candidates")
            sh = prober.shard_contribution.ratios()
            if sh.size:
                fams.append(Family(
                    f"{ns}_probe_shard_contribution", "gauge",
                    "per-shard share of served candidates",
                    [({"shard": str(d)}, float(v))
                     for d, v in enumerate(sh)]))
            with prober._cond:
                counters = [
                    ("probes_sampled_total", prober.n_sampled,
                     "serve calls sampled for shadow probing"),
                    ("probes_scored_total", prober.n_scored,
                     "probes fully scored against the oracle"),
                    ("probe_rows_total", prober.n_rows_scored,
                     "query rows folded into the estimators"),
                    ("probes_dropped_total", prober.n_dropped,
                     "probes dropped on a full queue"),
                    ("probe_errors_total", prober.n_errors,
                     "oracle callback failures"),
                ]
            for name, v, help_ in counters:
                fams.append(Family(f"{ns}_{name}", "counter", help_,
                                   [({}, float(v))]))
            fams.append(Family(
                f"{ns}_probe_lag_seconds", "histogram",
                "serve -> shadow-scored latency",
                [({}, prober.probe_lag.snapshot())]))
            return fams

        reg.register_collector(_collect)
        return reg
