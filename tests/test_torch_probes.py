"""PyTorch port vs the JAX reference: the shadow recall probes.

The port's copies of ``obs/{histogram,sampling,registry,quality}.py``
against the reference's on the same inputs (estimators, probe metrics,
the prober's queue, drop and error accounting, the registered series),
the repair of ROADMAP.md C3 in the port's ``LatencyHistogram.diff``, and
the live service's probes: the reference's tiny obs service
(``tests/_obs_svc.py``, ``delta_spare=0`` since the port has no deltas
yet) bridged into the port's service, which runs on the CPU.
"""
import dataclasses
import math
import threading
import time

import jax
import numpy as np
import pytest

from _obs_svc import make_service
from repro.obs import histogram as j_hist
from repro.obs import quality as j_quality
from repro.obs import registry as j_registry

from repro_torch import bridge
from repro_torch.configs import svq as t_svq
from repro_torch.obs import histogram as t_hist
from repro_torch.obs import quality as t_quality
from repro_torch.obs import registry as t_registry
from repro_torch.obs.sampling import CounterSampler
from repro_torch.serving.service import RetrievalService

NEG = -1e30


def _random_jobs(pkg, g, n_jobs=4, rows=5, s=12, k=6, n_clusters=9,
                 n_shards=3):
    """(job, answer) pairs of ``pkg``'s types from the same numpy draws:
    some invalid slots, a padded tail (n_valid), shard owners."""
    out = []
    for i in range(n_jobs):
        served = g.integers(0, 40, size=(rows, s))
        valid = g.random((rows, s)) > 0.2
        exact = np.where(valid, g.normal(size=(rows, s)), NEG)
        job = pkg.ProbeJob(batch={}, served_ids=served, served_valid=valid,
                           served_exact=exact, task=0, generation=i,
                           t_serve=0.0, n_valid=None if i % 2 else rows - 1)
        clof = np.where(valid, g.integers(0, n_clusters, (rows, s)), -1)
        ans = pkg.OracleAnswer(
            exact_ids=g.integers(0, 40, size=(rows, k)),
            exact_scores=-np.sort(-g.normal(size=(rows, k)), axis=1),
            cluster_of=clof, n_clusters=n_clusters,
            shard_of=np.where(clof >= 0, clof % n_shards, -1),
            n_shards=n_shards)
        out.append((job, ans))
    return out


# ---------------------------------------------------------------------------
# estimators and probe metrics against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_metrics_equal_reference(seed):
    jobs_t = _random_jobs(t_quality, np.random.default_rng(seed))
    jobs_j = _random_jobs(j_quality, np.random.default_rng(seed))
    for (tj, ta), (jj, ja) in zip(jobs_t, jobs_j):
        got = t_quality.probe_metrics(tj, ta, 6)
        want = j_quality.probe_metrics(jj, ja, 6)
        assert got.n_rows == want.n_rows
        for f in ("recalls", "gaps", "cluster_counts", "shard_counts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


@pytest.mark.parametrize("window", [1, 7, 512])
def test_windowed_stat_and_contribution_equal_reference(window):
    g = np.random.default_rng(window)
    ts, js = t_quality.WindowedStat(window), j_quality.WindowedStat(window)
    tc = t_quality.ContributionEstimator(window)
    jc = j_quality.ContributionEstimator(window)
    for i in range(20):
        vals = g.random(int(g.integers(0, 9)))
        ts.update(vals)
        js.update(vals)
        counts = g.integers(0, 5, size=4 if i < 15 else 6)  # re-bucketed
        tc.update(counts)
        jc.update(counts)
        assert ts.snapshot() == js.snapshot()
        assert tc.snapshot() == jc.snapshot()
        np.testing.assert_array_equal(tc.ratios(), jc.ratios())


def test_counter_sampler_every_kth_and_disabled():
    s = CounterSampler(every=3)
    assert [s.should_sample() for _ in range(9)] == [True, False, False] * 3
    s.enabled = False
    assert not s.should_sample()
    with pytest.raises(ValueError):
        CounterSampler(every=0)


# ---------------------------------------------------------------------------
# the prober: queue, drops, error isolation, registered series
# ---------------------------------------------------------------------------

def _perfect_oracle(pkg):
    def oracle(job):
        return pkg.OracleAnswer(
            job.served_ids, np.sort(job.served_exact)[:, ::-1],
            np.zeros_like(job.served_ids), 4,
            np.zeros_like(job.served_ids), 2)
    return oracle


def _job(pkg):
    return pkg.ProbeJob(batch={}, served_ids=np.array([[0, 1]]),
                        served_valid=np.ones((1, 2), bool),
                        served_exact=np.array([[2.0, 1.0]]), task=0,
                        generation=0, t_serve=time.monotonic())


def test_prober_queue_full_drops_not_blocks():
    gate = threading.Event()
    perfect = _perfect_oracle(t_quality)

    def slow_oracle(job):
        gate.wait(10.0)
        return perfect(job)

    p = t_quality.QualityProber(slow_oracle, k=2, max_queue=1)
    try:
        p.submit(_job(t_quality))              # the worker takes this one
        deadline = time.monotonic() + 5.0
        while len(p._queue) and time.monotonic() < deadline:
            time.sleep(0.001)
        assert p.submit(_job(t_quality))       # fills the queue
        t0 = time.monotonic()
        assert p.submit(_job(t_quality)) is False
        assert time.monotonic() - t0 < 1.0     # never blocks
        gate.set()
        assert p.drain(10.0)
    finally:
        gate.set()
        p.close()
    assert (p.n_sampled, p.n_scored, p.n_dropped) == (3, 2, 1)
    assert p.submit(_job(t_quality)) is False  # closed


def test_prober_oracle_error_isolated():
    calls = []

    def flaky(job):
        calls.append(job)
        if len(calls) == 1:
            raise RuntimeError("oracle down")
        return _perfect_oracle(t_quality)(job)

    with t_quality.QualityProber(flaky, k=2) as p:
        for _ in range(2):
            p.submit(_job(t_quality))
        assert p.drain(10.0)
        assert p.n_errors == 1 and p.n_scored == 1
    assert p.recall.snapshot()["n"] == 1


def test_prober_registers_the_reference_series():
    fams, snaps = {}, {}
    for name, pkg, reg_pkg in (("port", t_quality, t_registry),
                               ("ref", j_quality, j_registry)):
        reg = reg_pkg.MetricRegistry()
        with pkg.QualityProber(_perfect_oracle(pkg), k=2, window=8) as p:
            p.register(reg)
            p.submit(_job(pkg))
            assert p.drain(10.0)
            fams[name] = [(f.name, f.mtype, f.help,
                           [labels for labels, _ in f.series])
                          for f in reg.collect()]
            snaps[name] = {key: entry["value"] for key, entry in
                           reg.snapshot().items()
                           if entry["type"] != "histogram"}
    assert fams["port"] == fams["ref"]
    assert snaps["port"] == snaps["ref"]
    assert snaps["port"]["svq_probe_recall"] == 1.0


# ---------------------------------------------------------------------------
# C3: the interval histogram's maximum and percentiles are exact
# ---------------------------------------------------------------------------

def _samples(rng, n):
    return rng.lognormal(mean=-7.0, sigma=2.5, size=n)


def _interval(pkg, seed, n_before, n_after):
    rng = np.random.default_rng(seed)
    before, after = _samples(rng, n_before), _samples(rng, n_after)
    h, only = pkg.LatencyHistogram(), pkg.LatencyHistogram()
    for x in before:
        h.record(x)
    prev = h.snapshot()
    for y in after:
        h.record(y)
        only.record(y)
    return h.diff(prev), only.snapshot()


def test_c3_recorded_example_interval_p99():
    """ROADMAP.md C3: Hypothesis's recorded failing example (seed=0,
    n_before=1, n_after=1) of the reference's
    test_diff_is_the_interval_histogram.  The reference's interval
    resolves its max to the bucket edge and reports p99 = 0.75 ms for a
    sample of 0.655 ms; the port's is the sample itself."""
    d, only = _interval(t_hist, 0, 1, 1)
    assert d.max == only.max
    assert d.percentile(0.99) == only.percentile(0.99)
    jd, jonly = _interval(j_hist, 0, 1, 1)
    assert jd.percentile(0.99) != jonly.percentile(0.99)


@pytest.mark.parametrize("seed,n_before,n_after", [
    (1, 0, 5), (2, 300, 1), (3, 300, 300), (4, 5, 0), (5, 1, 300),
    (6, 50, 3), (7, 200, 20)])
def test_diff_is_the_interval_histogram(seed, n_before, n_after):
    d, only = _interval(t_hist, seed, n_before, n_after)
    assert d.counts == only.counts and d.count == only.count == n_after
    assert math.isclose(d.sum, only.sum, rel_tol=1e-9, abs_tol=1e-12)
    if n_after == 0:
        assert d.min is None and d.max == 0.0
        return
    assert d.min <= only.min and d.max == only.max
    for q in (0.5, 0.9, 0.99, 1.0):
        assert d.percentile(q) == only.percentile(q)


def test_interval_max_after_merge_and_in_the_registry():
    """A merged histogram's samples count as recorded at the merge; the
    registry's interval view carries the exact interval maximum."""
    a, b = t_hist.LatencyHistogram(), t_hist.LatencyHistogram()
    a.record(0.004)
    prev = a.snapshot()
    b.record(0.0031)
    b.record(0.0033)
    a.merge(b)
    assert a.diff(prev).max == 0.0033
    reg = t_registry.MetricRegistry()
    h = reg.histogram("lat_seconds").default
    h.record(0.009)
    snap = reg.snapshot()
    h.record(0.0071)
    d = reg.diff(snap)["lat_seconds"]["value"]
    assert d.count == 1 and d.max == 0.0071
    assert d.percentile(0.99) == 0.0071


def test_interval_max_falls_back_to_the_edge_past_dropped_entries():
    """A bucket keeps KEEP suffix maxima; an interval that begins before
    a dropped one reports the bucket's upper edge, still a bound from
    above, and one that begins after it stays exact."""
    h = t_hist.LatencyHistogram()
    h.record(0.5)
    p0 = h.snapshot()
    h.record(0.00109)
    p1 = h.snapshot()
    # decreasing samples of one bucket: the stack drops 0.00109, its
    # oldest entry, when the next KEEP arrive
    falling = [0.00108 - 1e-7 * i for i in range(t_hist.KEEP)]
    for x in falling:
        h.record(x)
    b = h.bucket_of(0.00109)
    assert h.bucket_of(falling[-1]) == b
    assert h.diff(p0).max == h.upper_edge(b) > 0.00109
    assert h.diff(p1).max == 0.00108


# ---------------------------------------------------------------------------
# the live service's probes on bridged state
# ---------------------------------------------------------------------------

def _services(n_shards=None, fused=False, n_items=300, cfg_kw=None,
              items_per_cluster=32):
    """The reference's tiny obs service and the port's service on its
    bridged params and state (CPU)."""
    cfg, jsvc, batch = make_service(n_shards=n_shards, delta_spare=0,
                                    n_items=n_items)
    if cfg_kw:
        cfg = cfg.with_(**cfg_kw)
        jsvc = type(jsvc)(cfg, jsvc._params, jsvc._index_state,
                          items_per_cluster=items_per_cluster,
                          n_shards=n_shards, fused=fused)
    tsvc = RetrievalService(
        t_svq.SVQConfig(**dataclasses.asdict(cfg)),
        bridge.params_to_torch(jax.device_get(jsvc._params)),
        bridge.index_state_to_torch(jax.device_get(jsvc._index_state)),
        items_per_cluster=items_per_cluster, fused=fused,
        n_shards=n_shards, device="cpu")
    return cfg, jsvc, tsvc, batch


def test_user_embedding_matches_reference():
    _, jsvc, tsvc, batch = _services()
    np.testing.assert_allclose(tsvc.user_embedding(batch),
                               jsvc.user_embedding(batch), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fused,n_shards", [(False, None), (True, None),
                                            (False, 2)])
def test_probe_oracle_matches_reference(fused, n_shards):
    """The same ProbeJob (built from the reference's serve) through both
    oracles: exact ids, owning clusters and shards equal, exact scores
    within rtol 1e-5."""
    _, jsvc, tsvc, batch = _services(n_shards=n_shards, fused=fused)
    out = jsvc.serve_batch(batch)
    exact = out["exact_scores"]
    job = j_quality.ProbeJob(
        batch=batch, served_ids=out["index_ids"],
        served_valid=exact > NEG / 2, served_exact=exact, task=0,
        generation=0, t_serve=time.monotonic())
    jsvc.enable_probes(k=8, sample_every=1000)
    tsvc.enable_probes(k=8, sample_every=1000)
    try:
        want = jsvc._probe_oracle(job)
        got = tsvc._probe_oracle(t_quality.ProbeJob(*job))
    finally:
        jsvc.disable_probes()
        tsvc.disable_probes()
    np.testing.assert_array_equal(got.exact_ids, np.asarray(want.exact_ids))
    np.testing.assert_allclose(got.exact_scores, np.asarray(want.exact_scores),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.cluster_of, want.cluster_of)
    assert got.n_clusters == want.n_clusters
    assert got.n_shards == want.n_shards
    if n_shards:
        np.testing.assert_array_equal(got.shard_of, want.shard_of)
    else:
        assert got.shard_of is None and want.shard_of is None
    # and the port's serve gives the candidates the job was built from
    tout = tsvc.serve_batch(batch)
    np.testing.assert_array_equal(tout["index_ids"], out["index_ids"])


def test_service_probes_end_to_end_and_n_valid():
    _, _, tsvc, batch = _services()
    prober = tsvc.enable_probes(k=8, sample_every=1, window=64)
    try:
        for _ in range(3):
            tsvc.serve_batch(batch)
        tsvc.serve_batch(batch, n_valid=2)
        assert prober.drain(30.0)
        s = prober.snapshot()
        assert s["n_scored"] == 4 and s["n_errors"] == 0
        assert s["n_rows_scored"] == 3 * len(batch["user_id"]) + 2
        assert 0.0 <= s["recall"]["mean"] <= 1.0
        assert s["score_gap"]["mean"] >= -1e-5
        with pytest.raises(RuntimeError):
            tsvc.enable_probes(k=2)
    finally:
        tsvc.disable_probes()
    assert tsvc.prober is None
    tsvc.disable_probes()                       # idempotent


def test_service_probe_sampling_every_k():
    _, _, tsvc, batch = _services()
    prober = tsvc.enable_probes(k=4, sample_every=3)
    try:
        for _ in range(7):
            tsvc.serve_batch(batch)
        assert prober.drain(30.0)
        assert prober.n_sampled == 3            # serves 0, 3, 6
    finally:
        tsvc.disable_probes()


@pytest.mark.parametrize("n_shards", [None, 2])
def test_probe_recall_is_one_when_the_index_is_fresh(n_shards):
    """Every cluster probed, every live item within a cluster's list and
    candidates_out above the live count: the index serves every item the
    store holds, so the oracle's top-k is always served (recall 1.0, in
    both packages), before and after a rebuild; the generation counts
    rebuilds."""
    cfg_kw = dict(clusters_per_query=8, candidates_out=512)
    _, jsvc, tsvc, batch = _services(n_shards=n_shards, cfg_kw=cfg_kw,
                                     items_per_cluster=300)
    recalls = {}
    for name, svc in (("port", tsvc), ("ref", jsvc)):
        prober = svc.enable_probes(k=8, sample_every=1)
        try:
            svc.serve_batch(batch)
            svc.rebuild_index()
            svc.serve_batch(batch)
            assert prober.drain(30.0)
            assert prober.n_scored == 2 and prober.n_errors == 0
            recalls[name] = prober.recall.snapshot()["mean"]
        finally:
            svc.disable_probes()
    assert recalls == {"port": 1.0, "ref": 1.0}
    assert tsvc._generation == 1
