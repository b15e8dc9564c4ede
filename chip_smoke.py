#!/usr/bin/env python3
"""Drive the PyTorch port's serve path on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel to its plain PyTorch version at the serve shapes of the
full ``SVQConfig()`` (K=16384 clusters, d=64, C=128, L=256, chunk=8,
S=512, batches of 512 users), serves full-width batches through
``RetrievalService`` on the card and checks what comes out.  Prints one
line per phase, then a JSON line of per-kernel numbers, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Exits
nonzero, without that last line, if there is no card or any phase fails.
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
    """Mean time per call over ``iters`` back-to-back calls, between two
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def main_path(retriever, astore, ops, RetrievalService, cfg, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
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
        if count != N_BATCHES:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{N_BATCHES} batches")
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
    return launches


def profile_batch(svc, batch) -> None:
    """One more batch under torch.profiler: device time by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.serve_batch(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(evt, self_only):
        names = (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total", "cuda_time_total"))
        for n in names:
            if hasattr(evt, n):
                return getattr(evt, n)
        return 0.0

    avgs = prof.key_averages()
    # device-side events only (kernels, copies): their self time is the
    # time the card was busy; a host op's self device time would repeat it
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e, True) for e in kernels) / 1e3
    stages = {e.key: round(dev_us(e, False) / 1e3, 4) for e in avgs
              if e.key in ("cluster_rank", "merge_serve")}
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:10]
    phase("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms, stage_device_ms=stages,
          top_kernels_ms=[(e.key[:60], round(dev_us(e, True) / 1e3, 4),
                           e.count) for e in top])


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
               check_merge_serve(ops, ref, cfg, dev, gen, 256)]

    launches = main_path(retriever, astore, ops, RetrievalService, cfg, dev)
    small_reference(retriever, astore, RetrievalService, smoke, dev)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
