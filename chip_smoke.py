#!/usr/bin/env python3
"""Drive the PyTorch port's serve and train paths on one CUDA card.

    python3 chip_smoke.py

Builds the five hand-written kernel sources from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, all at once) and
holds each kernel to its plain PyTorch version at the shapes of the full
``SVQConfig()`` (K=16384 clusters, d=64; serve: C=128, L=256, chunk=8,
S=512, batches of 512 users; train: batches of 65536).  Then it serves
full-width batches through ``RetrievalService``, trains 3 full-width steps
with ``train_svq`` through the train kernels, serves a batch from the
trained state, and runs a small model on the card and on the CPU, for
serving and for 3 train steps, to compare them.  The launch counters show
that each path went through its kernels.  Prints one line per phase, then
a JSON line of per-kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits nonzero, without that last
line, if there is no card or any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory rate and fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_BATCHES = 4
BATCH = 512          # users per serve batch: the serve_p99 shape
SEED = 0
TRAIN_STEPS = 3
TRAIN_BATCH = 65536  # impressions (and candidates) per step: train_batch
SOFTMAX_CHECK_B = (TRAIN_BATCH, 16384, 1000)   # kernel vs plain
SERVE_KERNELS = ("cluster_rank", "merge_serve")
# launches of each train kernel in one train step (n_tasks = 1)
TRAIN_KERNELS = {"vq_assign": 2, "inbatch_softmax": 2,
                 "inbatch_softmax_bwd": 2, "ema_segment_sum": 1}
# record_function ranges of the port, not kernels
ANNOTATIONS = SERVE_KERNELS + ("vq_assign", "inbatch_softmax",
                               "ema_segment_sum", "index_sort")
# Adam's learning rate in the SVQ trainer (launch/train.py _svq_opt)
ADAM_LR = 1e-3


def phase(label: str, **fields) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median time per call over ``iters`` back-to-back calls, after
    ``warmup`` calls: a CUDA event is recorded between every two calls,
    and each call's time is the interval between its two events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_cluster_rank(ops, ref, cfg, dev, gen) -> dict:
    """Kernel vs plain at the serve shape, on random and on tied inputs."""
    b, k, d, n = BATCH, cfg.n_clusters, cfg.embed_dim, cfg.clusters_per_query
    u = torch.randn((b, d), generator=gen, device=dev)
    e = torch.randn((k, d), generator=gen, device=dev) * 0.1
    vals, idx = ops.cluster_rank(u, e, n)
    rv, ri = ref.cluster_rank_ref(u, e, n)
    torch.cuda.synchronize()
    if not torch.allclose(vals, rv, rtol=1e-5, atol=1e-6):
        raise AssertionError("cluster_rank scores differ from the plain "
                             "version beyond rtol 1e-5, atol 1e-6")
    if not torch.all(vals[:, 1:] <= vals[:, :-1]):
        raise AssertionError("cluster_rank scores are not descending")
    # ids may differ from the plain version only where its scores nearly
    # tie: the plain score of the kernel's id at a rank is within 1e-5 of
    # the plain score of the plain id at that rank
    scores = u @ e.T
    diff = idx != ri
    got = torch.gather(scores, 1, idx.long())
    want = torch.gather(scores, 1, ri.long())
    near = (got - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)
    if not torch.all(near[diff]):
        raise AssertionError("cluster_rank ids differ from the plain version "
                             "outside near-ties")
    dup = torch.sort(idx, 1).values
    if torch.any(dup[:, 1:] == dup[:, :-1]):
        raise AssertionError("cluster_rank repeats a cluster id in a row")
    boundary = int((torch.isin(idx, ri, invert=True)).sum())
    max_err = float((vals - rv).abs().max())
    # integer-valued inputs with planted ties: bitwise, tie order included
    ut = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    et = torch.randint(-1, 2, (k, d), generator=gen, device=dev).float()
    tv, ti = ops.cluster_rank(ut, et, n)
    trv, tri = ref.cluster_rank_ref(ut, et, n)
    torch.cuda.synchronize()
    if not (torch.equal(ti, tri) and
            torch.equal(tv.view(torch.int32), trv.view(torch.int32))):
        raise AssertionError("cluster_rank is not bitwise on tied integer "
                             "inputs")
    phase("cluster_rank", random_ids_reordered_in_near_ties=int(diff.sum()),
          ids_outside_plain_top_n=boundary, max_abs_err=max_err,
          tied_bitwise=True)
    ms = time_ms(lambda: ops.cluster_rank(u, e, n), iters=50)
    plain_ms = time_ms(lambda: ref.cluster_rank_ref(u, e, n), iters=50)
    lib_ms = time_ms(lambda: torch.topk(u @ e.T, n), iters=50)
    t_bound, by = bound_ms(4 * (b * d + k * d) + 8 * b * n, 2 * b * k * d)
    phase("cluster_rank_time", ms=ms, plain_ms=plain_ms, topk_ms=lib_ms,
          bound_ms=t_bound)
    return dict(name="cluster_rank", route="cuda",
                source="src/repro_torch/kernels/csrc/cluster_rank.cu",
                replaces="src/repro/kernels/merge_serve.py:101",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms)


def check_merge_serve(ops, ref, cfg, dev, gen, items_per_cluster) -> dict:
    """Kernel vs plain, bitwise, at the serve shape."""
    b, c, l = BATCH, cfg.clusters_per_query, items_per_cluster
    chunk, target = cfg.chunk_size, cfg.candidates_out

    def case(tied):
        if tied:
            cs = torch.randint(0, 2, (b, c), generator=gen, device=dev)
            bl = torch.randint(0, 3, (b, c, l), generator=gen, device=dev)
            cs, bl = cs.float(), bl.float()
        else:
            cs = torch.randn((b, c), generator=gen, device=dev)
            bl = torch.randn((b, c, l), generator=gen, device=dev)
        bl = torch.sort(bl, dim=-1, descending=True).values.contiguous()
        ln = torch.randint(0, l + 1, (b, c), generator=gen, device=dev,
                           dtype=torch.int32)
        return cs, bl, ln

    for tied in (False, True):
        args = case(tied)
        for exact in (True, False):
            pos, sc = ops.merge_serve(*args, chunk, target, exact=exact)
            rp, rs = ref.merge_serve_ref(*args, chunk, target, exact=exact)
            torch.cuda.synchronize()
            if not (torch.equal(pos, rp) and
                    torch.equal(sc.view(torch.int32), rs.view(torch.int32))):
                raise AssertionError(f"merge_serve differs from the plain "
                                     f"version (tied={tied}, exact={exact})")
    args = case(False)
    pos, sc = ops.merge_serve(*args, chunk, target)
    rp, rs = ref.merge_serve_ref(*args, chunk, target)
    torch.cuda.synchronize()
    max_err = float((sc - rs).abs().max())
    phase("merge_serve", bitwise_exact_and_inexact=True, tied_bitwise=True,
          max_abs_err=max_err)
    ms = time_ms(lambda: ops.merge_serve(*args, chunk, target), iters=50)
    plain_ms = time_ms(lambda: ref.merge_serve_ref(*args, chunk, target),
                       iters=5, warmup=1)
    # what these inputs need: cs, lengths and the C head biases of every
    # query, each emitted bias, and the outputs; one argmax over C per pop
    # that emits (each such pop starts at a multiple of chunk)
    valid = pos >= 0
    n_valid = int(valid.sum())
    n_pops = int((valid & ((pos % l) % chunk == 0)).sum())
    t_bound, by = bound_ms(12 * b * c + 4 * n_valid + 8 * b * target,
                           n_pops * c)
    phase("merge_serve_time", ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
          pops=n_pops)
    return dict(name="merge_serve", route="cuda",
                source="src/repro_torch/kernels/csrc/merge_serve.cu",
                replaces="src/repro/kernels/merge_serve.py:174",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=None)


def fill_store(retriever, astore, params, state, cfg, dev, gen):
    """Every item id through the item tower, into clusters drawn at random,
    written to the store."""
    from repro_torch.models.dense import mlp
    n = cfg.n_items
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    cate = torch.randint(0, 4096, (n,), generator=gen, device=dev)
    v_emb, v_bias = [], []
    for lo in range(0, n, 1 << 18):
        feat = retriever.item_features(params, ids[lo:lo + (1 << 18)],
                                       cate[lo:lo + (1 << 18)])
        v_all = mlp(params["item_tower"], feat)
        v_emb.append(v_all[:, :-1])
        v_bias.append(v_all[:, -1])
    clusters = torch.randint(0, cfg.n_clusters, (n,), generator=gen,
                             device=dev)
    store = astore.write(state.store, ids, clusters, torch.cat(v_emb),
                         torch.cat(v_bias))
    return state._replace(store=store)


def request_batch(cfg, rng, b):
    return dict(
        user_id=rng.integers(0, cfg.n_users, size=b).astype(np.int32),
        hist=rng.integers(0, cfg.n_items,
                          size=(b, cfg.user_hist_len)).astype(np.int32))


def check_outputs(out, cfg, b) -> None:
    s = cfg.candidates_out
    for k in ("item_ids", "index_ids", "scores", "merge_scores",
              "exact_scores", "valid"):
        if out[k].shape != (b, s):
            raise AssertionError(f"{k} has shape {out[k].shape}")
    if not out["valid"].all():
        raise AssertionError("a row has fewer than S valid candidates")
    for k in ("item_ids", "index_ids"):
        if not ((out[k] >= 0) & (out[k] < cfg.n_items)).all():
            raise AssertionError(f"{k} out of range")
    for k in ("scores", "merge_scores", "exact_scores"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"{k} not finite")
    if not (np.diff(out["scores"], axis=1) <= 0).all():
        raise AssertionError("ranking scores are not descending")
    if not all(np.array_equal(np.sort(a), np.sort(c)) for a, c in
               zip(out["item_ids"], out["index_ids"])):
        raise AssertionError("ranked ids are not the merged candidates")


def main_path(retriever, astore, ops, RetrievalService, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = retriever.init(gen, cfg, device=dev)
    with torch.no_grad():
        state = fill_store(retriever, astore, params, state, cfg, dev, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = RetrievalService(cfg, params, state, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_indexed = int(svc.index.counts.sum())
    rng = np.random.default_rng(SEED)
    batches = [request_batch(cfg, rng, BATCH) for _ in range(N_BATCHES)]
    t0 = time.perf_counter()
    svc.serve_batch(request_batch(cfg, rng, BATCH))   # first call: warm-up
    warmup_ms = (time.perf_counter() - t0) * 1e3
    ops.reset_launches()
    times = []
    outs = []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(svc.serve_batch(batch))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ops.LAUNCHES)
    for name, count in launches.items():
        want = N_BATCHES if name in SERVE_KERNELS else 0
        if count != want:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{N_BATCHES} serve batches, not {want}")
    for out in outs:
        check_outputs(out, cfg, BATCH)
    profile_batch(svc, batches[0])
    phase("main_path", batches=N_BATCHES, batch=BATCH,
          ms_per_batch_median=statistics.median(times),
          ms_per_batch=[round(t, 3) for t in times], warmup_ms=warmup_ms,
          init_and_fill_s=init_s, build_index_s=build_s,
          items_indexed=n_indexed,
          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
          launches=launches)
    return launches, svc


def profile_batch(svc, batch) -> None:
    """One more batch under torch.profiler: device time by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.serve_batch(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3

    busy_ms, top = device_breakdown(prof)
    stages = {e.key: round(dev_us(e, False) / 1e3, 4)
              for e in prof.key_averages()
              if e.key in ("cluster_rank", "merge_serve")}
    phase("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms, stage_device_ms=stages,
          top_kernels_ms=top)


def dev_us(evt, self_only):
    names = (("self_device_time_total", "self_cuda_time_total")
             if self_only else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(evt, n):
            return getattr(evt, n)
    return 0.0


def device_breakdown(prof, n_top: int = 10):
    """-> (ms the card was busy, the n_top kernels by device time as
    (name, ms, count)).  Device-side events only (kernels, copies): their
    self time is the time the card was busy; a host op's self device time
    would repeat it, and so would the device-side ranges of the
    ``record_function`` annotations, which are left out."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.key not in ANNOTATIONS]
    busy_ms = sum(dev_us(e, True) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:n_top]
    return busy_ms, [(e.key[:60], round(dev_us(e, True) / 1e3, 4), e.count)
                     for e in top]


def small_reference(retriever, astore, RetrievalService, smoke, dev) -> None:
    """The same small model served on the card and by the plain versions
    on the CPU: equal ids, close scores."""
    cfg = smoke()
    gen = torch.Generator().manual_seed(SEED)
    params, state = retriever.init(gen, cfg, device="cpu")
    state = fill_store(retriever, astore, params, state, cfg, "cpu", gen)
    batch = request_batch(cfg, np.random.default_rng(SEED), 32)
    ref = RetrievalService(cfg, params, state, device="cpu").serve_batch(batch)
    got = RetrievalService(cfg, params, state, device=dev).serve_batch(batch)
    for k in ("index_ids", "item_ids", "valid"):
        if not np.array_equal(ref[k], got[k]):
            raise AssertionError(f"small model: {k} differ from the CPU run")
    for k in ("scores", "merge_scores", "exact_scores"):
        if not np.allclose(ref[k], got[k], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"small model: {k} not close to the CPU run")
    phase("small_reference", ids_equal=True, scores_close="rtol=atol=1e-5")


def near_tie_ok(scores_of, got, want, rel=1e-5):
    """ids may differ from the plain version's only where the plain scores
    of the two ids lie within ``rel`` of each other (relative to
    max(|score|, 1)); ``scores_of(rows, ids)`` gives plain scores.
    -> (ok, rows that differ, max |score difference| over them)."""
    rows = torch.nonzero(got != want)[:, 0]
    if rows.numel() == 0:
        return True, 0, 0.0
    a = scores_of(rows, got[rows])
    b = scores_of(rows, want[rows])
    ok = bool(torch.all((a - b).abs() <= rel * b.abs().clamp(min=1.0)))
    return ok, int(rows.numel()), float((a - b).abs().max())


def check_vq_assign(ops, ref, cfg, dev, gen) -> dict:
    """Kernel vs plain at the train shape: near-tie contract on random
    inputs, bitwise on integer inputs with planted ties."""
    b, k, d = TRAIN_BATCH, cfg.n_clusters, cfg.embed_dim
    v = torch.randn((b, d), generator=gen, device=dev)
    e = torch.randn((k, d), generator=gen, device=dev)
    r = torch.rand((k,), generator=gen, device=dev) * 0.8 + 0.2
    got = ops.vq_assign(v, e, r)
    want = ref.vq_assign_ref(v, e, r)
    torch.cuda.synchronize()
    ee = (e * e).sum(-1)

    def scores_of(rows, ids):
        vr = v[rows]
        er = e[ids.long()]
        d2 = ((vr * vr).sum(-1) - 2.0 * (vr * er).sum(-1)
              + ee[ids.long()])
        return d2.clamp(min=0.0) * r[ids.long()]

    ok, n_diff, max_err = near_tie_ok(scores_of, got, want)
    if not ok:
        raise AssertionError("vq_assign ids differ from the plain version "
                             "outside near-ties")
    vt = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    et = torch.randint(-1, 2, (k, d), generator=gen, device=dev).float()
    et[k // 2:k // 2 + 8] = et[1]                  # planted ties
    rt = torch.where(torch.rand((k,), generator=gen, device=dev) < 0.5,
                     0.5, 1.0)
    if not torch.equal(ops.vq_assign(vt, et, rt),
                       ref.vq_assign_ref(vt, et, rt)):
        raise AssertionError("vq_assign is not bitwise on tied integer "
                             "inputs")
    phase("vq_assign", shape=(b, k, d), ids_differing_in_near_ties=n_diff,
          max_abs_score_err=max_err, tied_bitwise=True)
    ms = time_ms(lambda: ops.vq_assign(v, e, r), iters=10)
    plain_ms = time_ms(lambda: ref.vq_assign_ref(v, e, r), iters=3,
                       warmup=1)
    t_bound, by = bound_ms(4 * (b * d + k * d + k + b), 2 * b * k * d)
    phase("vq_assign_time", ms=ms, plain_ms=plain_ms, bound_ms=t_bound)
    return dict(name="vq_assign", route="cuda",
                source="src/repro_torch/kernels/csrc/vq_assign.cu",
                replaces="src/repro/kernels/vq_assign.py:24",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=None)


def softmax_inputs(b, d, dev, gen):
    u, v = (torch.randn((b, d), generator=gen, device=dev) * 0.5
            for _ in range(2))
    bias, lq, g = (torch.randn((b,), generator=gen, device=dev)
                   for _ in range(3))
    return u, v, bias, lq, g


def check_inbatch_softmax(ops, ref, cfg, dev, gen) -> list:
    """Forward and backward kernels vs plain (rtol 1e-4, atol 1e-5) at
    the train shape B=65536, at B=16384 and at a ragged B; then times at
    the train shape, on the inputs that were checked."""
    d = cfg.embed_dim
    err_f = err_b = 0.0
    for b in SOFTMAX_CHECK_B:
        u, v, bias, lq, g = softmax_inputs(b, d, dev, gen)
        got = ops.inbatch_softmax_stats(u, v, bias, lq)
        want = ref.inbatch_softmax_ref(u, v, bias, lq)
        lse = want[1] + torch.log(want[2])
        gotb = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
        wantb = ref.inbatch_softmax_bwd_ref(u, v, bias, lq, lse, g)
        torch.cuda.synchronize()
        for name, x, y in zip(("loss", "m", "l", "du", "dv", "dbias",
                               "dlogq"), got + gotb, want + wantb):
            if not torch.allclose(x, y, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"inbatch_softmax {name} differs from "
                                     f"the plain version at B={b}")
        err_f = max(err_f, max(float((x - y).abs().max())
                               for x, y in zip(got, want)))
        err_b = max(err_b, max(float((x - y).abs().max())
                               for x, y in zip(gotb, wantb)))
        again = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
        if not all(torch.equal(x, y) for x, y in zip(gotb, again)):
            raise AssertionError("inbatch_softmax_bwd differs between two "
                                 "launches")
        if b == TRAIN_BATCH:
            timed = (u, v, bias, lq, lse, g)
        del got, want, gotb, wantb, again
        torch.cuda.empty_cache()
    phase("inbatch_softmax", checked_b=SOFTMAX_CHECK_B, d=d,
          max_abs_err_fwd=err_f, max_abs_err_bwd=err_b,
          bwd_bitwise_across_launches=True)
    b = TRAIN_BATCH
    u, v, bias, lq, lse, g = timed
    ms_f = time_ms(lambda: ops.inbatch_softmax_stats(u, v, bias, lq),
                   iters=5, warmup=1)
    ms_b = time_ms(lambda: ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g),
                   iters=5, warmup=1)
    plain_f = time_ms(lambda: ref.inbatch_softmax_ref(u, v, bias, lq),
                      iters=3, warmup=1)
    torch.cuda.empty_cache()
    plain_b = time_ms(lambda: ref.inbatch_softmax_bwd_ref(u, v, bias, lq,
                                                          lse, g),
                      iters=3, warmup=1)
    torch.cuda.empty_cache()
    # bytes: each input read once, each output written once.  Operations:
    # the forward's logits z (2*B*B*d); the backward's z once and its two
    # contractions p.v and (g.p)^T.u (6*B*B*d; the kernels compute z
    # twice, which the bound does not count)
    bf, byf = bound_ms(4 * (2 * b * d + 5 * b), 2 * b * b * d)
    bb, byb = bound_ms(4 * (4 * b * d + 6 * b), 6 * b * b * d)
    phase("inbatch_softmax_time", b=b, fwd_ms=ms_f, bwd_ms=ms_b,
          plain_fwd_ms=plain_f, plain_bwd_ms=plain_b,
          bound_fwd_ms=bf, bound_bwd_ms=bb)
    src = "src/repro_torch/kernels/csrc/inbatch_softmax.cu"
    return [dict(name="inbatch_softmax", route="cuda", source=src,
                 replaces="src/repro/kernels/inbatch_softmax.py:37",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f,
                 bound_ms=bf, bound_by=byf, library_ms=None),
            dict(name="inbatch_softmax_bwd", route="cuda", source=src,
                 replaces="src/repro/kernels/inbatch_softmax.py:133",
                 max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=byb, library_ms=None)]


def segment_sum_errors(ref, v, a, wt, k, *results) -> list:
    """Each (w_add, c_add) result's largest error against the float64 sum,
    checked under n_k * eps * (sum of |wt_j v_j| over the cluster's n_k
    rows), eps = 2^-23: float32 sums of n terms, in any order and each
    product rounded, err by at most about n * eps / 2 times that.
    -> [(max |err| of w_add, of c_add)] per result."""
    ew, ec = ref.ema_segment_sum_ref(v, a, wt, k, torch.float64)
    aw, ac = ref.ema_segment_sum_ref(v.abs(), a, wt.abs(), k, torch.float64)
    keep = (a >= 0) & (a < k)
    n = torch.bincount(a[keep].long(), minlength=k).double() * 2.0 ** -23
    out = []
    for w, c in results:
        dw, dc = (w.double() - ew).abs(), (c.double() - ec).abs()
        if not (bool((dw <= n[:, None] * aw).all()) and
                bool((dc <= n * ac).all())):
            raise AssertionError("ema_segment_sum: a sum errs beyond "
                                 "n * eps of its float64 value")
        out.append((float(dw.max()), float(dc.max())))
    return out


def check_ema_segment_sum(ops, ref, cfg, dev, gen) -> dict:
    """Kernel vs plain (rtol 1e-5, atol 1e-6) at the train shape with
    uniform assignments, some rows assigned K; on those and on skewed
    assignments bitwise its own summation order done in plain PyTorch,
    and held with the plain version to the float64 sum; bitwise across
    two launches."""
    b, k, d = TRAIN_BATCH, cfg.n_clusters, cfg.embed_dim
    slices = ops.ema_segment_sum_slices()
    v = torch.randn((b, d), generator=gen, device=dev)
    a = torch.randint(0, k, (b,), generator=gen, device=dev,
                      dtype=torch.int32)
    a[::97] = k                                    # outside [0, K)
    wt = torch.rand((b,), generator=gen, device=dev) * 2.0
    w1, c1 = ops.ema_segment_sum(v, a, wt, k)
    w2, c2 = ops.ema_segment_sum(v, a, wt, k)
    rw, rc = ref.ema_segment_sum_ref(v, a, wt, k)
    torch.cuda.synchronize()
    if not (torch.allclose(w1, rw, rtol=1e-5, atol=1e-6) and
            torch.allclose(c1, rc, rtol=1e-5, atol=1e-6)):
        raise AssertionError("ema_segment_sum differs from the plain version")
    if not (torch.equal(w1, w2) and torch.equal(c1, c2)):
        raise AssertionError("ema_segment_sum differs between two launches")
    sw, sc = ref.ema_segment_sum_sliced_ref(v, a, wt, k, slices)
    if not (torch.equal(w1.cpu(), sw) and torch.equal(c1.cpu(), sc)):
        raise AssertionError("ema_segment_sum is not bitwise its summation "
                             "order")
    max_err = max(float((w1 - rw).abs().max()), float((c1 - rc).abs().max()))
    # skewed assignments, as in an early train step: 80 clusters, Zipf
    hot = torch.randperm(k, generator=gen, device=dev)[:80]
    pick = torch.multinomial(1.0 / torch.arange(1, 81, device=dev).float(),
                             b, replacement=True, generator=gen)
    a_skew = hot[pick].to(torch.int32)
    ws1, cs1 = ops.ema_segment_sum(v, a_skew, wt, k)
    rws, rcs = ref.ema_segment_sum_ref(v, a_skew, wt, k)
    torch.cuda.synchronize()
    sw, sc = ref.ema_segment_sum_sliced_ref(v, a_skew, wt, k, slices)
    if not (torch.equal(ws1.cpu(), sw) and torch.equal(cs1.cpu(), sc)):
        raise AssertionError("ema_segment_sum is not bitwise its summation "
                             "order on skewed assignments")
    # thousands of rows a cluster: the kernel's sliced sums of w_add err
    # less than the plain version's one long sum (atomics on the card);
    # c_add is not compared: some orders of adding positive weights beat
    # the slices
    (kw, kc), (pw, pc) = segment_sum_errors(ref, v, a_skew, wt, k,
                                            (ws1, cs1), (rws, rcs))
    if kw > pw:
        raise AssertionError(f"ema_segment_sum errs more than the plain "
                             f"version on skewed assignments: {kw} > {pw}")
    phase("ema_segment_sum", shape=(b, k, d), slices=slices,
          rows_outside=int((a == k).sum()), max_abs_err=max_err,
          skewed_bitwise_sliced_order=True,
          skewed_err_to_float64_w_c=(kw, kc),
          skewed_plain_err_to_float64_w_c=(pw, pc),
          largest_cluster_rows=int(torch.bincount(pick).max()),
          bitwise_across_launches=True)
    ms_skew = time_ms(lambda: ops.ema_segment_sum(v, a_skew, wt, k), iters=20)
    ms = time_ms(lambda: ops.ema_segment_sum(v, a, wt, k), iters=20)
    plain_ms = time_ms(lambda: ref.ema_segment_sum_ref(v, a, wt, k), iters=20)
    # the library call: index_add_ of wt.v for w_add, with the rows outside
    # [0, K) sent to cluster 0 at weight 0 (the same sums)
    inside = a < k
    a_in = torch.where(inside, a, 0).long()
    wv = (torch.where(inside, wt, 0.0)[:, None] * v).contiguous()
    w_lib = torch.zeros((k, d), device=dev)
    lib_ms = time_ms(lambda: w_lib.index_add_(0, a_in, wv), iters=20)
    t_bound, by = bound_ms(4 * (b * d + 2 * b + k * d + k), 3 * b * d)
    phase("ema_segment_sum_time", ms=ms, skewed_ms=ms_skew,
          plain_ms=plain_ms, index_add_ms=lib_ms, bound_ms=t_bound)
    return dict(name="ema_segment_sum", route="cuda",
                source="src/repro_torch/kernels/csrc/ema_segment_sum.cu",
                replaces="src/repro/kernels/vq_ema.py:34",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms)


class TimedStream:
    """A RecsysStream whose batch calls are timed (host data time)."""

    def __init__(self, stream):
        self.stream = stream
        self.seconds = []

    def impression_batch(self, n):
        t0 = time.perf_counter()
        out = self.stream.impression_batch(n)
        self.seconds.append(time.perf_counter() - t0)
        return out

    def candidate_batch(self, n):
        t0 = time.perf_counter()
        out = self.stream.candidate_batch(n)
        self.seconds[-1] += time.perf_counter() - t0
        return out


def train_path(ops, cfg, dev):
    """3 full-width train steps at batch 65536 through the four kernels."""
    from repro_torch.data.streaming import RecsysStream, StreamConfig
    from repro_torch.launch.train import train_svq
    from repro_torch.train import LoopConfig
    t0 = time.perf_counter()
    stream = TimedStream(RecsysStream(StreamConfig(
        n_items=cfg.n_items, n_users=cfg.n_users, hist_len=cfg.user_hist_len,
        seed=SEED)))
    stream_s = time.perf_counter() - t0
    marks = []

    def on_step(step, state, batch):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, index, res = train_svq(cfg, stream, n_steps=TRAIN_STEPS,
                                   batch=TRAIN_BATCH, seed=SEED, device=dev,
                                   loop=LoopConfig(sync_every=1,
                                                   on_step=on_step))
    launches = dict(ops.LAUNCHES)
    for name, count in launches.items():
        want = TRAIN_STEPS * TRAIN_KERNELS.get(name, 0)
        if count != want:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} train steps, not {want}")
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    losses = [m["loss"] for m in res.metrics]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    # the store holds what the last candidate batch wrote, wherever no
    # later row of that batch hashed to the same slot
    from repro_torch.core.freq_estimator import hash_ids
    last_ids = torch.as_tensor(stream.stream.candidate_batch(TRAIN_BATCH)
                               ["item_id"], device=dev)
    slots = hash_ids(last_ids, cfg.n_items)
    uniq = torch.bincount(slots, minlength=cfg.n_items)[slots] == 1
    st = index.store
    if not torch.equal(st.item_id[slots][uniq], last_ids.int()[uniq]):
        raise AssertionError("the store lost ids the last step wrote")
    cl = st.cluster[slots]
    if not bool(((cl >= 0) & (cl < cfg.n_clusters)).all()):
        raise AssertionError("stored clusters out of range")
    n_stored = int((st.cluster >= 0).sum())
    phase("train_path", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
          ms_per_step_median_after_first=statistics.median(step_ms[1:]),
          first_step_ms=step_ms[0], ms_per_step=[round(t, 3) for t in step_ms],
          host_data_ms=[round(s * 1e3, 3) for s in stream.seconds],
          stream_setup_s=stream_s, losses=losses,
          used_clusters=[m["used_clusters"] for m in res.metrics],
          perplexity=[m["perplexity"] for m in res.metrics],
          slots_filled=n_stored,
          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
          launches=launches)
    profile_train_step(cfg, res.state, stream, dev)
    return launches, params, index


def profile_train_step(cfg, state, stream, dev) -> None:
    """One more full-width step under torch.profiler: device busy share
    and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import _svq_opt, _svq_step_fn
    step_fn = _svq_step_fn(cfg, _svq_opt(), dev)
    batch = {"imp": stream.stream.impression_batch(TRAIN_BATCH),
             "cand": stream.stream.candidate_batch(TRAIN_BATCH)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_breakdown(prof)
    phase("train_profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms, top_kernels_ms=top)


def serve_trained(svc, params, index, cfg) -> None:
    """The trained state into the live service: swap, rebuild, serve."""
    svc.swap_model(params, index)
    t0 = time.perf_counter()
    idx = svc.rebuild_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = svc.serve_batch(request_batch(cfg, np.random.default_rng(SEED + 1),
                                        BATCH))
    valid = out["valid"]
    if out["item_ids"].shape != (BATCH, cfg.candidates_out) or not valid.any():
        raise AssertionError("serving the trained state gave no candidates")
    for k in ("item_ids", "index_ids"):
        ids = out[k][valid]
        if not ((ids >= 0) & (ids < cfg.n_items)).all():
            raise AssertionError(f"trained serve: {k} out of range")
    if not np.isfinite(out["scores"][valid]).all():
        raise AssertionError("trained serve: scores not finite")
    phase("serve_trained", items_indexed=int(idx.counts.sum()),
          rebuild_s=build_s, valid_share=float(valid.mean()))


def small_train_reference(smoke, dev) -> None:
    """3 smoke-size steps on the card and on the CPU from the same init
    and stream.  The losses are close (rtol 1e-3, atol 1e-4) and at least
    99% of the store's clusters equal (near ties of vq_assign flip a few
    items).  Each param leaf is close at the same tolerance in at least
    99.9% of its entries, except the item tower's last bias: the in-batch
    softmax is invariant under one vector added to every item embedding,
    so that bias has a zero gradient in exact arithmetic, and Adam's
    normalised step turns the rounding noise of either device into a step
    of up to lr; it is held within 2 * steps * lr.  Its drift reaches the
    other leaves only through a few flipped assignments."""
    from repro_torch.core import retriever
    from repro_torch.data.streaming import RecsysStream, StreamConfig
    from repro_torch.launch.train import _svq_opt, _svq_step_fn
    from repro_torch.train import LoopConfig, run_loop
    from repro_torch.utils import tree
    cfg = smoke()
    params, index = retriever.init(torch.Generator().manual_seed(SEED), cfg,
                                   device="cpu")
    runs = {}
    for device in ("cpu", dev):
        stream = RecsysStream(StreamConfig(n_items=cfg.n_items,
                                           n_users=cfg.n_users,
                                           hist_len=cfg.user_hist_len,
                                           seed=SEED))
        opt = _svq_opt()
        p = tree.to_device(params, device)
        state = {"params": p, "index": tree.to_device(index, device),
                 "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        res = run_loop(_svq_step_fn(cfg, opt, device), state,
                       lambda s: {"imp": stream.impression_batch(256),
                                  "cand": stream.candidate_batch(256)},
                       LoopConfig(n_steps=TRAIN_STEPS, sync_every=1))
        runs[str(device)] = res
    ref_run, got_run = runs["cpu"], runs[str(dev)]
    lr = [m["loss"] for m in ref_run.metrics]
    lg = [m["loss"] for m in got_run.metrics]
    if not np.allclose(lg, lr, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"small train: losses {lg} vs CPU {lr}")
    shift_free = ("item_tower", "layers", len(params["item_tower"]["layers"])
                  - 1, "b")
    worst = {}
    for (path, a), b in zip(tree.flatten_with_path(got_run.state["params"]),
                            tree.leaves(ref_run.state["params"])):
        a = a.cpu()
        diff = float((a - b).abs().max())
        if path == shift_free:
            if diff > 2 * TRAIN_STEPS * ADAM_LR:
                raise AssertionError(f"small train: {path} moved {diff}")
            continue
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-4)
        share = float(close.float().mean())
        worst["/".join(map(str, path))] = (share, diff)
        if share < 0.999:
            raise AssertionError(f"small train: {path} close to the CPU in "
                                 f"{share} of its entries, max |diff| {diff}")
    same = float((got_run.state["index"].store.cluster.cpu()
                  == ref_run.state["index"].store.cluster).float().mean())
    if same < 0.99:
        raise AssertionError(f"small train: store clusters agree on {same}")
    low = min(worst, key=lambda k: worst[k][0])
    phase("small_train_reference", losses=lg, cpu_losses=lr,
          store_clusters_equal_share=same,
          lowest_close_share=(low, worst[low][0], worst[low][1]),
          shift_free_bias_max_diff=float(
              (got_run.state["params"]["item_tower"]["layers"][-1]["b"].cpu()
               - ref_run.state["params"]["item_tower"]["layers"][-1]["b"])
              .abs().max()))

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs.svq import CONFIG, smoke
    from repro_torch.core import assignment_store as astore
    from repro_torch.core import retriever
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving.service import RetrievalService

    card = gpu_name_and_power_limit()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=repr(card),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build()
    for name in built:
        build.load(name)
    phase("build", seconds=time.perf_counter() - t0,
          libraries=",".join(p.name for p in built.values()))

    cfg = CONFIG
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = [check_cluster_rank(ops, ref, cfg, dev, gen),
               check_merge_serve(ops, ref, cfg, dev, gen, 256),
               check_vq_assign(ops, ref, cfg, dev, gen),
               *check_inbatch_softmax(ops, ref, cfg, dev, gen),
               check_ema_segment_sum(ops, ref, cfg, dev, gen)]
    torch.cuda.empty_cache()

    serve_launches, svc = main_path(retriever, astore, ops, RetrievalService,
                                    cfg, dev)
    train_launches, params, index = train_path(ops, cfg, dev)
    serve_trained(svc, params, index, cfg)
    del svc, params, index
    torch.cuda.empty_cache()
    small_reference(retriever, astore, RetrievalService, smoke, dev)
    small_train_reference(smoke, dev)

    for k in kernels:
        serve = k["name"] in SERVE_KERNELS
        k["launches"] = (serve_launches if serve else
                         train_launches)[k["name"]]
        k["launches_per"] = "serve batch" if serve else "train step"
        k["launches_per_unit"] = k["launches"] / (N_BATCHES if serve else
                                                  TRAIN_STEPS)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per", "launches_per_unit", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
