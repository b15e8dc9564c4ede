#!/usr/bin/env python3
"""Drive the PyTorch port's serve, train, quality, recsys and LM paths on
one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py cluster_rank inbatch_softmax   # those phases only

Builds the nine hand-written kernel sources from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, all at once) and
holds each kernel to its plain PyTorch version at the shapes of the full
``SVQConfig()`` (K=16384 clusters, d=64; serve: C=128, L=256, chunk=8,
S=512, batches of 512 users over 2,097,152 items; train: batches of
65536; the exact MIPS oracle ``topk_dot``: one query against 1,000,000
candidates and 512 queries against the 2,097,152-slot store) and of the
recsys families (``embedding_bag``: DLRM-RM2's 8,000,000 x 64 multi-hot
tables at B=512 and 262,144, two-tower's 16,777,216 x 256 history table)
and of the LM family (``flash_attention``: the reference's single-head
cases, Qwen3-0.6B's 32,768-token layer in bf16, its tensor-core route,
and in fp32, its SIMT route, SmolLM-360M's B=8 x 4,096 layer).
Then it serves full-width batches through ``RetrievalService`` unfused,
fused (``fused_gather_rank``) and on 4 logical shards (unfused and
fused), each held to the unfused single-device service's outputs; serves
them again with the shadow recall probes on (``enable_probes``: every
batch re-scored by the exact oracle, which launches ``topk_dot``); trains
3 full-width steps with ``train_svq`` through the train kernels, serves a
batch from the trained state and reads its recall (``eval_svq_recall``,
the brute-force ceiling, the store's collision rate); and runs a small
model on the card and on the CPU, for serving (unfused, fused, sharded),
the quality path and 3 train steps, to compare them.  The recsys phases
serve DLRM-RM2 ``CONFIG`` at full width (batches of 512, one of 262,144,
one context against 1,000,000 candidates; 4 ``embedding_bag`` launches a
forward), two-tower at its published widths with its tables cut to
16,777,216 rows (serve, and a top-50 retrieval over 1,000,000
candidates), DIN and BST ``CONFIG`` (serve), and the four smoke configs
on the card and on the CPU (serve, retrieval, loss, 5 train steps).  The
LM phases run Qwen3-0.6B ``CONFIG`` in bf16: ``prefill`` at B=1 x 32,768
and B=8 x 4,096 (one ``flash_attention`` launch a layer),
``greedy_generate`` of 8 tokens from the 32,768-token prompt and the
same decode at B=8 on a copy of its cache; in fp32 at S=4,096 the
forward with the kernel against the same forward with the plain
attention, and decode against forward; and the three dense smoke configs
on the card and on the CPU (forward, tokens, 5 train steps).  The
launch counters, set to 0 before each path and read after it, show that
each path went through its kernels.  Prints one line per phase, then a
JSON line of per-kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits nonzero, without that last
line, if there is no card or any phase fails.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory rate and fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12  # dense bf16 tensor cores
TF32_TC_FLOP_PER_S = 495e12  # dense tf32 tensor cores
# exps a second: 16 MUFU.EX2 results a clock an SM (CUDA C++ programming
# guide, throughput table, compute capability 9.0) x 132 SMs x 1,980 MHz
EXP_PER_S = 16 * 132 * 1.98e9

N_BATCHES = 4
BATCH = 512          # users per serve batch: the serve_p99 shape
SEED = 0
TRAIN_STEPS = 3
TRAIN_BATCH = 65536  # impressions (and candidates) per step: train_batch
SOFTMAX_CHECK_B = (TRAIN_BATCH, 16384, 1000)   # kernel vs plain
N_SHARDS = 4         # logical shards of the sharded serve path
RETRIEVAL_CAND = 1_000_000   # candidates of the retrieval_cand shape
PROBE_K = 20         # the probe oracle's k
SERVE_KERNELS = ("cluster_rank", "merge_serve")
# launches of each train kernel in one train step (n_tasks = 1)
TRAIN_KERNELS = {"vq_assign": 2, "inbatch_softmax": 2,
                 "inbatch_softmax_bwd": 2, "ema_segment_sum": 1}
# record_function ranges of the port, not kernels
ANNOTATIONS = SERVE_KERNELS + ("fused_gather_rank", "stage_merge",
                               "vq_assign", "inbatch_softmax",
                               "ema_segment_sum", "index_sort")
# Adam's learning rate in the SVQ trainer (launch/train.py _svq_opt)
ADAM_LR = 1e-3
SERVE_BULK = 262_144         # requests of the serve_bulk shape
DLRM_VOCAB = 8_000_000       # rows of DLRM-RM2's 4 multi-hot tables
# two-tower's three 33,554,432-row tables, cut to fit one 80 GB card
TWO_TOWER_VOCAB = 16_777_216
SMOKE_STEPS = 5              # train_arch_smoke's default
# param leaves whose every shift a softmax ignores (zero gradient in exact
# arithmetic; ROADMAP C9), by recsys arch
SHIFT_FREE = {"two-tower-retrieval": [("item_tower", "layers", 1, "b")],
              "din": [("attn", "layers", 2, "b")],
              "bst": [("blocks", 0, "wk", "b")]}


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
    from repro_torch.kernels import build
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
    split = kernel_split_ms(lambda: ops.cluster_rank(u, e, n))
    t_bound, by = bound_ms(4 * (b * d + k * d) + 8 * b * n, 2 * b * k * d)
    phase("cluster_rank_time", ms=ms, plain_ms=plain_ms, topk_ms=lib_ms,
          bound_ms=t_bound,
          score_ms=sum(t for name, t in split.items() if "score" in name),
          select_ms=sum(t for name, t in split.items()
                        if "score" not in name),
          device_ms=short_names(split),
          ptxas=ptxas_entries(build.build_log("cluster_rank"),
                              ("score_kernel", "select_kernel")))
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


def check_merge_serve_ds(ops, ref, cfg, dev, gen, items_per_cluster) -> dict:
    """The ds launch vs plain and vs the merge_serve kernel, bitwise, at
    the serve shape and with L < chunk."""
    b, c, l = BATCH, cfg.clusters_per_query, items_per_cluster
    chunk, target = cfg.chunk_size, cfg.candidates_out

    def case(l):
        cs = torch.randn((b, c), generator=gen, device=dev)
        bl = torch.randn((b, c, l), generator=gen, device=dev)
        bl = torch.sort(bl, dim=-1, descending=True).values.contiguous()
        ln = torch.randint(0, l + 1, (b, c), generator=gen, device=dev,
                           dtype=torch.int32)
        return cs, bl, ln

    for width in (l, chunk // 2):
        args = case(width)
        pos, sc = ops.merge_serve_ds(*args, chunk, target)
        for name, (rp, rs) in (
                ("plain", ref.merge_serve_ds_ref(*args, chunk, target)),
                ("merge_serve", ops.merge_serve(*args, chunk, target))):
            torch.cuda.synchronize()
            if not (torch.equal(pos, rp) and
                    torch.equal(sc.view(torch.int32), rs.view(torch.int32))):
                raise AssertionError(f"merge_serve_ds differs from {name} "
                                     f"at L={width}")
    args = case(l)
    pos, sc = ops.merge_serve_ds(*args, chunk, target)
    rp, rs = ref.merge_serve_ds_ref(*args, chunk, target)
    torch.cuda.synchronize()
    max_err = float((sc - rs).abs().max())
    phase("merge_serve_ds", bitwise_plain_and_merge_serve=True,
          checked_l=(l, chunk // 2), max_abs_err=max_err)
    # the two launches of one body on the same inputs, in turns
    ds_ms, ms_ms = [], []
    for timed in (ds_ms, ms_ms, ms_ms, ds_ms):
        fn = ops.merge_serve_ds if timed is ds_ms else ops.merge_serve
        timed.append(time_ms(lambda: fn(*args, chunk, target), iters=50))
    ms = statistics.median(ds_ms)
    plain_ms = time_ms(lambda: ref.merge_serve_ds_ref(*args, chunk, target),
                       iters=5, warmup=1)
    # the same work as merge_serve on the same inputs (its bound)
    valid = pos >= 0
    n_valid = int(valid.sum())
    n_pops = int((valid & ((pos % l) % chunk == 0)).sum())
    t_bound, by = bound_ms(12 * b * c + 4 * n_valid + 8 * b * target,
                           n_pops * c)
    phase("merge_serve_ds_time", ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
          ds_ms_in_turns=ds_ms, merge_serve_ms_in_turns=ms_ms)
    return dict(name="merge_serve_ds", route="cuda",
                source="src/repro_torch/kernels/csrc/merge_serve.cu",
                replaces="src/repro/kernels/merge_serve.py:261",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=None)


def flat_index_case(gen, dev, b, k, c, l, d, n, integer=False):
    """A flat serving index of K clusters over N items, each cluster's
    biases sorted descending, and C clusters drawn for each of B queries
    -> the fused kernel's arguments (u, cs, starts, lengths, limits,
    bias, ids, emb); every lane's limit is N - 1."""
    def draw(*shape):
        if integer:
            return torch.randint(-2, 3, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(shape, generator=gen, device=dev)

    cuts = torch.randint(0, n + 1, (k - 1,), generator=gen, device=dev)
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.sort(cuts).values,
                      torch.full((1,), n, dtype=torch.int64, device=dev)])
    counts = offs[1:] - offs[:-1]
    seg = torch.repeat_interleave(torch.arange(k, device=dev), counts)
    bias = draw(n)
    order = torch.argsort(-bias, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    bias = bias[order].contiguous()
    cl = torch.randint(0, k, (b, c), generator=gen, device=dev)
    cs = torch.sort(draw(b, c), dim=1, descending=True).values.contiguous()
    return [draw(b, d), cs, offs[cl].int(), counts[cl].clamp(max=l).int(),
            torch.full((b, c), n - 1, dtype=torch.int32, device=dev), bias,
            torch.randperm(n, generator=gen, device=dev).int(),
            (draw(n, d) * (1.0 if integer else 0.1)).contiguous()]


def fused_vs_plain(ops, ref, args, chunk, target, l, want_args=None,
                   exact_bitwise=False) -> float:
    """Kernel on ``args`` vs plain on ``want_args`` (default the same):
    pos, merge_scores, cand_ids bitwise, exact_scores within rtol 1e-5 /
    atol 1e-5 (bitwise with ``exact_bitwise``).  -> max |exact err|."""
    got = ops.fused_gather_rank(*args, chunk, target, l)
    want = ref.fused_gather_rank_ref(*(want_args or args), chunk, target, l)
    torch.cuda.synchronize()
    for name, a, w in zip(("pos", "merge_scores", "cand_ids"), got, want):
        if not torch.equal(a.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"fused_gather_rank {name} differs from "
                                 f"the plain version")
    a, w = got[3], want[3]
    if exact_bitwise:
        if not torch.equal(a.view(torch.int32), w.view(torch.int32)):
            raise AssertionError("fused_gather_rank exact_scores not "
                                 "bitwise on integer inputs")
    elif not torch.allclose(a, w, rtol=1e-5, atol=1e-5):
        raise AssertionError("fused_gather_rank exact_scores differ from "
                             "the plain version beyond rtol 1e-5, atol 1e-5")
    return float((a - w).abs().max())


def check_fused_gather_rank(ops, ref, cfg, dev, gen, items_per_cluster
                            ) -> dict:
    """Kernel vs plain at the serve shape over a flat index of
    2,097,152 items; on integer inputs (all four outputs bitwise); with
    per-lane limits at 4 shards' ends and lists that run past them; with
    NaN in every lane past a cluster's length; with N < chunk."""
    b, c, l = BATCH, cfg.clusters_per_query, items_per_cluster
    k, d, n = cfg.n_clusters, cfg.embed_dim, cfg.n_items
    chunk, target = cfg.chunk_size, cfg.candidates_out
    args = flat_index_case(gen, dev, b, k, c, l, d, n)
    max_err = fused_vs_plain(ops, ref, args, chunk, target, l)
    ints = flat_index_case(gen, dev, b, k, c, l, d, n, integer=True)
    fused_vs_plain(ops, ref, ints, chunk, target, l, exact_bitwise=True)
    del ints
    # sharded limits: 4 shards of N/4 slots, starts in each shard's last
    # half, so many lists run past their shard's end
    cap = n // N_SHARDS
    owner = torch.randint(0, N_SHARDS, (b, c), generator=gen, device=dev)
    local = torch.randint(cap - 2 * l, cap + 1, (b, c), generator=gen,
                          device=dev)
    sharded = list(args)
    sharded[2] = (owner * cap + local).int()
    sharded[4] = (owner * cap + cap - 1).int()
    sharded[3] = torch.randint(0, l + 1, (b, c), generator=gen, device=dev,
                               dtype=torch.int32)
    past = int(((sharded[2] + sharded[3]).long() > sharded[4].long() + 1)
               .sum())
    max_err = max(max_err, fused_vs_plain(ops, ref, sharded, chunk, target,
                                          l))
    # NaN dead tail: C slabs of L items, lengths shared by all queries
    slab_n = c * l + 3
    lens = torch.randint(0, l + 1, (c,), generator=gen, device=dev)
    lane = torch.arange(slab_n, device=dev)
    dead = ((lane < c * l)
            & (lane % l >= lens[(lane // l).clamp(max=c - 1)]))
    clean = torch.randn(slab_n, generator=gen, device=dev)
    clean[:c * l] = torch.sort(clean[:c * l].view(c, l), dim=1,
                               descending=True).values.reshape(-1)
    poisoned = torch.where(dead, float("nan"), clean)
    nan_args = [args[0], args[1],
                (torch.arange(c, device=dev, dtype=torch.int32) * l)
                .expand(b, c).contiguous(),
                lens.int().expand(b, c).contiguous(),
                torch.full((b, c), slab_n - 1, dtype=torch.int32,
                           device=dev), poisoned, args[6][:slab_n].contiguous(),
                args[7][:slab_n].contiguous()]
    want = list(nan_args)
    want[5] = clean
    max_err = max(max_err, fused_vs_plain(ops, ref, nan_args, chunk, target,
                                          l, want_args=want))
    # N < chunk
    tiny = [args[0][:3], args[1][:3, :2].contiguous(),
            torch.zeros((3, 2), dtype=torch.int32, device=dev),
            torch.full((3, 2), 3, dtype=torch.int32, device=dev),
            torch.full((3, 2), 2, dtype=torch.int32, device=dev),
            torch.sort(args[5][:3], descending=True).values,
            args[6][:3].contiguous(), args[7][:3].contiguous()]
    fused_vs_plain(ops, ref, tiny, chunk, 10, 5)
    phase("fused_gather_rank", shape=(b, c, l, chunk, target, d, n),
          max_abs_err_exact=max_err, integer_inputs_bitwise=True,
          sharded_lists_past_shard_end=past, nan_lanes=int(dead.sum()),
          n_below_chunk=True)
    ms = time_ms(lambda: ops.fused_gather_rank(*args, chunk, target, l),
                 iters=50)
    plain_ms = time_ms(lambda: ref.fused_gather_rank_ref(*args, chunk,
                                                         target, l),
                       iters=5, warmup=1)
    # what these inputs need: u, the four (B, C) arrays, the bias of every
    # non-empty cluster's first item, and for each distinct emitted
    # address its bias, id and embedding row; the (B, S) outputs.
    # Operations: d FMAs per emitted item, one argmax over C per pop.
    pos = ops.fused_gather_rank(*args, chunk, target, l)[0].long()
    valid = pos >= 0
    pc = pos.clamp(min=0)
    st = torch.gather(args[2].long(), 1, pc // l)
    lim = torch.gather(args[4].long(), 1, pc // l)
    addr = torch.minimum(st + pc % l, lim)[valid]
    heads = torch.minimum(args[2].long(), args[4].long())[args[3] > 0]
    n_rows = int(torch.unique(addr).numel())
    n_bias = int(torch.unique(torch.cat([addr, heads])).numel())
    n_pops = int((valid & ((pos % l) % chunk == 0)).sum())
    n_bytes = (4 * b * d + 16 * b * c + 4 * n_bias + (4 + 4 * d) * n_rows
               + 16 * b * target)
    t_bound, by = bound_ms(n_bytes, 2 * d * int(valid.sum()) + n_pops * c)
    phase("fused_gather_rank_time", ms=ms, plain_ms=plain_ms,
          bound_ms=t_bound, bound_bytes=n_bytes, distinct_rows=n_rows,
          pops=n_pops)
    return dict(name="fused_gather_rank", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_gather_rank.cu",
                replaces="src/repro/kernels/merge_serve.py:351",
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


def serve_batches(svc, batches):
    """Serve ``batches`` after a warm-up call on the first, with the launch
    counts set to 0 just before -> (outputs, host ms per batch, launches,
    warm-up ms)."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    svc.serve_batch(batches[0])
    warmup_ms = (time.perf_counter() - t0) * 1e3
    ops.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(svc.serve_batch(batch))
        times.append((time.perf_counter() - t0) * 1e3)
    return outs, times, dict(ops.LAUNCHES), warmup_ms


def check_launches(launches, want, what) -> None:
    """Every count as ``want`` says (0 where it names none)."""
    for name, count in launches.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{name} launched {count} times in {what}, "
                                 f"not {want.get(name, 0)}")


def same_outputs(want, got, what) -> None:
    """Candidates, validity, merge and ranking scores bitwise; the exact
    Eq. 11 scores within rtol 1e-5 / atol 1e-5 (summation order)."""
    for k in want:
        a, b = want[k], got[k]
        if k == "exact_scores":
            if not np.allclose(a, b, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{what}: exact_scores not close")
        elif not np.array_equal(a.view(np.int32) if a.dtype == np.float32
                                else a,
                                b.view(np.int32) if b.dtype == np.float32
                                else b):
            raise AssertionError(f"{what}: {k} differs from the unfused "
                                 f"single-device service")


def main_path(retriever, astore, RetrievalService, cfg, dev):
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
    outs, times, launches, warmup_ms = serve_batches(svc, batches)
    check_launches(launches, {name: N_BATCHES for name in SERVE_KERNELS},
                   f"{N_BATCHES} serve batches")
    for out in outs:
        check_outputs(out, cfg, BATCH)
    prof = profile_batch(svc, batches[0])
    phase("main_path", batches=N_BATCHES, batch=BATCH,
          ms_per_batch_median=statistics.median(times),
          ms_per_batch=[round(t, 3) for t in times], warmup_ms=warmup_ms,
          init_and_fill_s=init_s, build_index_s=build_s,
          items_indexed=n_indexed,
          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
          launches=launches)
    return dict(launches=launches, svc=svc, params=params, state=state,
                batches=batches, outs=outs, ms_per_batch=times, profile=prof)


def fused_path(RetrievalService, cfg, dev, main) -> dict:
    """RetrievalService(fused=True) on the main path's batches: the
    unfused service's outputs, cluster_rank and fused_gather_rank once a
    batch; stage 2's device time against the unfused service's."""
    svc = RetrievalService(cfg, main["params"], main["state"], fused=True,
                           device=dev)
    outs, times, launches, _ = serve_batches(svc, main["batches"])
    check_launches(launches, {"cluster_rank": N_BATCHES,
                              "fused_gather_rank": N_BATCHES},
                   f"{N_BATCHES} fused serve batches")
    for want, got in zip(main["outs"], outs):
        same_outputs(want, got, "fused service")
    prof = profile_batch(svc, main["batches"][0], "fused_profile")
    phase("fused_path", batches=N_BATCHES, batch=BATCH,
          ms_per_batch_median=statistics.median(times),
          ms_per_batch=[round(t, 3) for t in times],
          unfused_ms_per_batch_median=statistics.median(
              main["ms_per_batch"]),
          stage2_device_ms=prof["stage_merge"],
          unfused_stage2_device_ms=main["profile"]["stage_merge"],
          outputs_equal_unfused=True, launches=launches)
    return launches


def sharded_path(RetrievalService, cfg, dev, main) -> dict:
    """RetrievalService(n_shards=4), unfused and fused, on the main path's
    batches: the single-device unfused outputs bitwise, cluster_rank once
    a shard and the merge kernel once a batch."""
    from repro_torch.serving.sharding import shard_serving_index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard_serving_index(main["svc"].index, cfg.n_clusters, N_SHARDS)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    all_launches = {}
    for fused in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc = RetrievalService(cfg, main["params"], main["state"],
                               fused=fused, n_shards=N_SHARDS, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        outs, times, launches, _ = serve_batches(svc, main["batches"])
        merge = "fused_gather_rank" if fused else "merge_serve"
        check_launches(launches, {"cluster_rank": N_SHARDS * N_BATCHES,
                                  merge: N_BATCHES},
                       f"{N_BATCHES} sharded serve batches (fused={fused})")
        for want, got in zip(main["outs"], outs):
            same_outputs(want, got, f"sharded service (fused={fused})")
        phase("sharded_path", fused=fused, shards=N_SHARDS,
              capacity=svc.index.capacity, batches=N_BATCHES, batch=BATCH,
              ms_per_batch_median=statistics.median(times),
              ms_per_batch=[round(t, 3) for t in times],
              build_index_and_shard_s=build_s, shard_only_s=shard_s,
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
              outputs_equal_single_device=True, launches=launches)
        all_launches[fused] = launches
        del svc
    return all_launches


def probe_path(RetrievalService, cfg, dev, main) -> dict:
    """Shadow probes on the live full-width service, unfused and fused:
    every batch of the main path probed (k=20) against the exact oracle
    over the 2,097,152-slot store, one topk_dot launch a probed batch, no
    probe dropped or failed; one probe's oracle held to the plain version
    on the card."""
    from repro_torch.baselines import brute_force
    from repro_torch.core.merge_sort import NEG
    from repro_torch.kernels import ops, ref
    launches = {}
    for fused in (False, True):
        svc = RetrievalService(cfg, main["params"], main["state"],
                               fused=fused, device=dev)
        svc.serve_batch(main["batches"][0])          # warm-up, unprobed
        prober = svc.enable_probes(k=PROBE_K, sample_every=1,
                                   max_queue=N_BATCHES)
        ops.reset_launches()
        t0 = time.perf_counter()
        for batch in main["batches"]:
            svc.serve_batch(batch)
        serve_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
        if not prober.drain(timeout=300):
            raise AssertionError("probes did not drain in 300 s")
        drained_ms = (time.perf_counter() - t0) * 1e3
        runs = dict(ops.LAUNCHES)
        snap = prober.snapshot()
        if snap["n_errors"] or snap["n_dropped"]:
            raise AssertionError(f"probes failed: {snap['n_errors']} errors, "
                                 f"{snap['n_dropped']} dropped")
        if snap["n_scored"] != N_BATCHES:
            raise AssertionError(f"{snap['n_scored']} probes scored for "
                                 f"{N_BATCHES} probed batches")
        merge = "fused_gather_rank" if fused else "merge_serve"
        check_launches(runs, {"cluster_rank": N_BATCHES, merge: N_BATCHES,
                              "topk_dot": N_BATCHES},
                       f"{N_BATCHES} probed serve batches (fused={fused})")
        phase("probe_path", fused=fused, batches=N_BATCHES, batch=BATCH,
              k=PROBE_K, recall=snap["recall"], score_gap=snap["score_gap"],
              n_scored=snap["n_scored"], rows_scored=snap["n_rows_scored"],
              probe_lag=snap["probe_lag"],
              cluster_contribution=snap["cluster_contribution"],
              serve_ms_per_batch_with_probes=serve_ms,
              serve_and_drain_ms=drained_ms, launches=runs)
        launches[fused] = runs
        if not fused:
            # one probe's oracle against the plain version on the card
            batch = main["batches"][0]
            store = main["state"].store
            u = torch.as_tensor(svc.user_embedding(batch), device=dev)
            bias = torch.where(store.cluster >= 0, store.item_bias, NEG)
            kv, ks = brute_force.mips_topk(u, store.item_emb, bias, PROBE_K)
            ans = svc._probe_oracle(prober_job(batch, main["outs"][0]))
            if not np.array_equal(ans.exact_ids,
                                  store.item_id[ks.long()].cpu().numpy()):
                raise AssertionError("the probe oracle's ids are not its "
                                     "mips_topk's")
            err, n_diff = topk_vs_plain(ops, ref, u, store.item_emb, bias,
                                        PROBE_K, False)
            phase("probe_oracle_vs_plain", max_abs_err=err,
                  ids_in_near_ties=n_diff)
        svc.disable_probes()
        del svc
    return launches


def prober_job(batch, out):
    """The ProbeJob ``serve_batch`` submits for ``out``."""
    from repro_torch.core.merge_sort import NEG
    from repro_torch.obs.quality import ProbeJob
    exact = out["exact_scores"]
    return ProbeJob(batch=batch, served_ids=out["index_ids"],
                    served_valid=exact > NEG / 2, served_exact=exact,
                    task=0, generation=0, t_serve=time.monotonic())


def quality_path(cfg, dev, params, index, stream) -> None:
    """Recall of the full-width trained state: eval_svq_recall (64 users,
    k=50), the brute-force ceiling (mips_topk over the item tower's output
    for all items, against the same users' true top-50), the store's
    collision rate over all item ids, and read_cluster of served ids."""
    from repro_torch.baselines import brute_force
    from repro_torch.core import assignment_store as astore
    from repro_torch.core import retriever
    from repro_torch.launch.train import eval_svq_recall
    from repro_torch.models.dense import mlp
    from repro_torch.kernels import ops
    n_users, k = 64, 50
    t0 = time.perf_counter()
    rep = eval_svq_recall(cfg, params, index, stream, n_users=n_users, k=k,
                          device=dev)
    eval_s = time.perf_counter() - t0
    users = np.arange(n_users) % stream.cfg.n_users
    truth = stream.true_topk(users, k)
    with torch.no_grad():
        v_all = []
        for lo in range(0, cfg.n_items, 1 << 18):
            ids = torch.arange(lo, min(cfg.n_items, lo + (1 << 18)),
                               device=dev, dtype=torch.int32)
            cate = torch.as_tensor(stream.item_cate[lo:lo + (1 << 18)],
                                   device=dev)
            v_all.append(mlp(params["item_tower"],
                             retriever.item_features(params, ids, cate)))
        v_all = torch.cat(v_all)
        batch = {"user_id": torch.as_tensor(users, device=dev,
                                            dtype=torch.int32),
                 "hist": torch.as_tensor(stream.user_hist[users], device=dev,
                                         dtype=torch.int32)}
        feat, _ = retriever.user_features(params, batch["user_id"],
                                          batch["hist"])
        u = retriever.user_tower(params, feat, 0)
        ops.reset_launches()
        _, bf_ids = brute_force.mips_topk(u, v_all[:, :-1].contiguous(),
                                          v_all[:, -1].contiguous(), k)
        if ops.LAUNCHES["topk_dot"] != 1:
            raise AssertionError("the brute-force ceiling did not launch "
                                 "topk_dot once")
        ceiling = brute_force.recall_at_k(bf_ids.cpu().numpy(), truth)
        collide = float(astore.collision_rate(
            index.store, torch.arange(cfg.n_items, device=dev)))
        # read_cluster of what the trained state serves to serve_trained's
        # batch of 512 (the 3-step state serves few valid candidates)
        idx = astore.build_serving_index(index.store, cfg.n_clusters)
        out = retriever.serve(
            params, index, cfg, idx,
            request_batch(cfg, np.random.default_rng(SEED + 1), BATCH),
            device=dev)
        served = out["item_ids"][out["valid"]]
        clusters = astore.read_cluster(index.store, served)
    if not (np.isfinite(rep["recall"]) and 0.0 <= rep["recall"] <= 1.0
            and 0.0 <= ceiling <= 1.0):
        raise AssertionError(f"recall out of range: {rep}, {ceiling}")
    if served.numel() == 0 or not bool((clusters >= 0).all()):
        raise AssertionError("read_cluster found a served id outside the "
                             "store")
    phase("quality_path", users=n_users, k=k, recall=rep["recall"],
          served_valid=rep["served_valid"], bruteforce_ceiling=ceiling,
          random_recall=k / cfg.n_items, collision_rate=collide,
          served_ids_read=int(served.numel()),
          read_cluster_min=int(clusters.min()), eval_s=eval_s)


def range_device_ms(prof, name) -> float:
    """Busy device time of the ``record_function`` range ``name``: the
    kernels and copies that run inside the range's span on the device
    (its device-side annotation event).  The span itself would also count
    the gaps between them, which on this host-bound path are most of it;
    the kernels the port launches through ctypes are not attributed to a
    host-side range, so the device timeline is read instead."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e.time_range for e in dev if e.name == name]
    return sum(e.time_range.elapsed_us() for e in dev
               if e.name not in ANNOTATIONS and any(
                   s.start <= e.time_range.start and e.time_range.end <= s.end
                   for s in spans)) / 1e3


def profile_batch(svc, batch, label="profile") -> dict:
    """One more batch under torch.profiler: device time by name and by
    serve stage."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.serve_batch(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3

    busy_ms, top = device_breakdown(prof)
    stages = {name: round(range_device_ms(prof, name), 4)
              for name in ("cluster_rank", "stage_merge", "merge_serve",
                           "fused_gather_rank")}
    phase(label, wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms, stage_device_ms=stages,
          top_kernels_ms=top)
    return stages


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
    on the CPU, unfused, fused and on 4 logical shards (unfused and
    fused): equal ids, close scores."""
    cfg = smoke()
    gen = torch.Generator().manual_seed(SEED)
    params, state = retriever.init(gen, cfg, device="cpu")
    state = fill_store(retriever, astore, params, state, cfg, "cpu", gen)
    batch = request_batch(cfg, np.random.default_rng(SEED), 32)
    ref = RetrievalService(cfg, params, state, device="cpu").serve_batch(batch)
    variants = {"unfused": {}, "fused": dict(fused=True),
                "sharded": dict(n_shards=N_SHARDS),
                "sharded_fused": dict(n_shards=N_SHARDS, fused=True)}
    for name, kw in variants.items():
        got = RetrievalService(cfg, params, state, device=dev,
                               **kw).serve_batch(batch)
        for k in ("index_ids", "item_ids", "valid"):
            if not np.array_equal(ref[k], got[k]):
                raise AssertionError(f"small model, {name}: {k} differ from "
                                     f"the CPU run")
        for k in ("scores", "merge_scores", "exact_scores"):
            if not np.allclose(ref[k], got[k], rtol=1e-5, atol=1e-5):
                raise AssertionError(f"small model, {name}: {k} not close to "
                                     f"the CPU run")
    # the quality path: eval_svq_recall and one probe's oracle answer
    from repro_torch.data.streaming import RecsysStream, StreamConfig
    from repro_torch.launch.train import eval_svq_recall
    from repro_torch.utils.tree import to_device
    recalls, answers = {}, {}
    job = prober_job(batch, ref)
    for device in ("cpu", dev):
        stream = RecsysStream(StreamConfig(n_items=cfg.n_items,
                                           n_users=cfg.n_users,
                                           hist_len=cfg.user_hist_len,
                                           seed=SEED))
        recalls[str(device)] = eval_svq_recall(
            cfg, to_device(params, device), to_device(state, device), stream,
            n_users=32, k=20, device=device)
        svc = RetrievalService(cfg, params, state, device=device)
        svc.enable_probes(k=PROBE_K, sample_every=1000)
        answers[str(device)] = svc._probe_oracle(job)
        svc.disable_probes()
    if recalls["cpu"] != recalls[str(dev)]:
        raise AssertionError(f"small model: eval_svq_recall {recalls}")
    a, b = answers["cpu"], answers[str(dev)]
    if not (np.array_equal(a.exact_ids, b.exact_ids)
            and np.array_equal(a.cluster_of, b.cluster_of)
            and np.allclose(a.exact_scores, b.exact_scores, rtol=1e-5,
                            atol=1e-5)):
        raise AssertionError("small model: the probe oracle's answer on the "
                             "card differs from the CPU's")
    phase("small_reference", variants=",".join(variants), ids_equal=True,
          scores_close="rtol=atol=1e-5", eval_svq_recall=recalls["cpu"],
          probe_oracle_ids_equal=True)


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
    from repro_torch.kernels import build
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
    # the forward's logits z (2*B*B*d) in the fp32 pipes.  The backward's z
    # once and its two contractions p.v and (g.p)^T.u, 6*B*B*d, run as
    # three tf32 passes on the tensor cores (the kernels compute z twice,
    # which the bound does not count), beside B*B exps on MUFU; the bound
    # is the slowest of the parts
    bf, byf = bound_ms(4 * (2 * b * d + 5 * b), 2 * b * b * d)
    parts = {"bytes": 4 * (4 * b * d + 6 * b) / HBM_BYTES_PER_S * 1e3,
             "tensor_3xtf32": 3 * 6 * b * b * d / TF32_TC_FLOP_PER_S * 1e3,
             "exp_mufu": b * b / EXP_PER_S * 1e3}
    part = max(parts, key=parts.get)
    bb, byb = parts[part], "bytes" if part == "bytes" else "operations"
    split_b = kernel_split_ms(
        lambda: ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g), calls=2)
    phase("inbatch_softmax_time", b=b, fwd_ms=ms_f, bwd_ms=ms_b,
          plain_fwd_ms=plain_f, plain_bwd_ms=plain_b,
          bound_fwd_ms=bf, bound_bwd_ms=bb, bound_bwd_set_by=part,
          bound_bwd_peak="495 TFLOP/s tf32 tensor x 3 passes",
          bound_bwd_parts_ms=parts, share_of_bwd_bound=bb / ms_b,
          bwd_fp32_pipes_ms=6 * b * b * d / FP32_FLOP_PER_S * 1e3,
          bwd_device_ms=short_names(split_b),
          ptxas=ptxas_entries(build.build_log("inbatch_softmax"),
                              ("fwd_kernel", "prep_kernel", "bwd_kernel")))
    del u, v, bias, lq, lse, g, timed
    torch.cuda.empty_cache()
    wide_logits(ops, ref, dev, gen)
    src = "src/repro_torch/kernels/csrc/inbatch_softmax.cu"
    return [dict(name="inbatch_softmax", route="cuda", source=src,
                 replaces="src/repro/kernels/inbatch_softmax.py:37",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f,
                 bound_ms=bf, bound_by=byf, library_ms=None),
            dict(name="inbatch_softmax_bwd", route="cuda", source=src,
                 replaces="src/repro/kernels/inbatch_softmax.py:133",
                 max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=byb, library_ms=None)]


def wide_logits(ops, ref, dev, gen, b=16384) -> None:
    """u, v of scale 2 (logits of sd 16) at d=64: the backward kernel and
    plain each against an fp64 backward; fails where the kernel errs by
    more than plain's own largest error plus rtol 1e-4 / atol 1e-5."""
    u, v, bias, lq, g = softmax_inputs(b, 64, dev, gen)
    u, v = u * 4.0, v * 4.0   # softmax_inputs draws them at scale 0.5
    _, m, l = ref.inbatch_softmax_ref(u, v, bias, lq)
    lse = m + torch.log(l)
    got = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    plain = ref.inbatch_softmax_bwd_ref(u, v, bias, lq, lse, g)
    exact = ref.inbatch_softmax_bwd_ref(
        *(x.double() for x in (u, v, bias, lq, lse, g)))
    worst_k, worst_p, outside = 0.0, 0.0, 0
    for k, p, x in zip(got, plain, exact):
        err_k = (k.double() - x).abs()
        err_p = float((p.double() - x).abs().max())
        tol = 1e-5 + 1e-4 * x.abs()
        if not bool((err_k <= err_p + tol).all()):
            raise AssertionError("inbatch_softmax_bwd errs beyond plain's "
                                 "error plus the tolerance on wide logits")
        worst_k = max(worst_k, float(err_k.max()))
        worst_p = max(worst_p, err_p)
        outside += int((err_k > tol).sum())
    del exact
    torch.cuda.empty_cache()
    phase("inbatch_softmax_wide", b=b, d=64, scale=2.0,
          max_abs_err_to_fp64=worst_k, plain_max_abs_err_to_fp64=worst_p,
          kernel_outside_bare_tolerance=outside)


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
    # index_add_ of a precomputed wt.v for w_add, with the rows outside
    # [0, K) sent to cluster 0 at weight 0: a reading of part of the
    # function (no product wt.v, no c_add, no masking), so no single
    # PyTorch call stands as its library time
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
                bound_ms=t_bound, bound_by=by, library_ms=None)


def topk_case(gen, dev, b, n, d, integer=False, dup=0, live=None,
              dtype=torch.float32):
    """u (B, d), items (N, d), bias (N,): normal, or integer-valued with
    ``dup`` copies of item 0 at random slots (ties across blocks); with
    ``live`` only that many slots live, the rest zero rows at bias NEG
    (the oracle's empty slots)."""
    if integer:
        u = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
        items = torch.randint(-1, 2, (n, d), generator=gen,
                              device=dev).float()
        bias = torch.randint(-2, 3, (n,), generator=gen, device=dev).float()
    else:
        u = torch.randn((b, d), generator=gen, device=dev)
        items = torch.randn((n, d), generator=gen, device=dev) * 0.1
        bias = torch.randn((n,), generator=gen, device=dev)
    if dup:
        at = torch.randperm(n, generator=gen, device=dev)[:dup]
        items[at], bias[at] = items[0].clone(), bias[0].clone()
    if live is not None:
        dead = torch.randperm(n, generator=gen, device=dev)[live:]
        items[dead], bias[dead] = 0.0, -1e30
    return u.to(dtype), items.to(dtype), bias.to(dtype)


def topk_vs_plain(ops, ref, u, items, bias, k, bitwise, block_n=None):
    """The kernel against its plain version on the same inputs: bitwise,
    or values within rtol 1e-5 / atol 1e-5 and ids differing only in
    near-ties of the plain scores.  -> (max |value err|, rows whose ids
    differ)."""
    vals, idx = ops.topk_dot(u, items, bias, k, block_n=block_n)
    rv, ri = ref.topk_dot_ref(u, items, bias, k)
    torch.cuda.synchronize()
    if bitwise:
        if not (torch.equal(idx, ri) and
                torch.equal(vals.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"topk_dot not bitwise its plain version "
                                 f"(B={u.shape[0]}, N={items.shape[0]}, "
                                 f"k={k})")
        return 0.0, 0
    if not torch.allclose(vals, rv, rtol=1e-5, atol=1e-5):
        raise AssertionError("topk_dot values differ from the plain version "
                             "beyond rtol 1e-5, atol 1e-5")
    u32, it32, b32 = u.float(), items.float(), bias.float()

    def scores_of(rows, ids):
        ids = ids.long()
        return (it32[ids] * u32[rows][:, None, :]).sum(-1) + b32[ids]

    ok, n_diff, _ = near_tie_ok(scores_of, idx, ri)
    if not ok:
        raise AssertionError("topk_dot ids differ from the plain version "
                             "outside near-ties")
    return float((vals - rv).abs().max()), n_diff


def kernel_split_ms(fn, calls: int = 5) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by kernel
    name, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: dev_us(e, True) / 1e3 / calls
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e, True) > 0}


def kernel_device_ms(fn, kernel: str, calls: int = 3) -> tuple:
    """Device time per call of ``fn`` under torch.profiler: that of the
    kernels whose name holds ``kernel``, and that of every kernel the call
    launches (topk_dot's stage 2 sort and gathers too).  A call's
    event-timed ms also holds its host time where the host is the slower
    side."""
    split = kernel_split_ms(fn, calls)
    return (sum(ms for name, ms in split.items() if kernel in name),
            sum(split.values()))


def short_names(split: dict) -> dict:
    """A kernel_split_ms reading for a phase line: names cut to 60
    characters, ms to 5 decimals."""
    return {name[:60]: round(ms, 5) for name, ms in split.items()}


def check_topk_dot(ops, ref, cfg, dev, gen) -> dict:
    """Kernel vs plain at retrieval_cand (B=1, N=1,000,000, k=512 and 50)
    and at the probe oracle's shape (B=512, N=2,097,152, k=20); bitwise on
    integer inputs with planted ties, with N odd, with more than N - k
    slots masked to NEG, across block sizes; bf16 inputs.  Times at both
    shapes; the JSON row carries the probe shape, which the probe path
    runs."""
    d = cfg.embed_dim
    shapes = {"retrieval_cand": (1, RETRIEVAL_CAND, 512),
              "retrieval_cand_k50": (1, RETRIEVAL_CAND, 50),
              "probe": (BATCH, cfg.n_items, PROBE_K)}
    errs, diffs, inputs = {}, {}, {}
    for name, (b, n, k) in shapes.items():
        args = topk_case(gen, dev, b, n, d)
        errs[name], diffs[name] = topk_vs_plain(ops, ref, *args, k, False)
        inputs[name] = args
    topk_vs_plain(ops, ref, *topk_case(gen, dev, 1, RETRIEVAL_CAND - 1, d,
                                       integer=True, dup=4000), 512, True)
    topk_vs_plain(ops, ref, *topk_case(gen, dev, BATCH, cfg.n_items, d,
                                       integer=True, dup=4000), PROBE_K,
                  True)
    masked = topk_case(gen, dev, 64, 100_003, d, integer=True, live=300)
    for block_n in (128, 4096, None):
        topk_vs_plain(ops, ref, *masked, 512, True, block_n=block_n)
    bf16 = topk_case(gen, dev, 1, RETRIEVAL_CAND, d, dtype=torch.bfloat16)
    errs["bf16"], diffs["bf16"] = topk_vs_plain(ops, ref, *bf16, 512, False)
    del masked, bf16
    phase("topk_dot", max_abs_err=errs, ids_in_near_ties=diffs,
          tied_bitwise_at=("retrieval_cand N-1", "probe"),
          masked_bitwise_block_n=(128, 4096, "auto"), bf16_checked=True)
    times = {}
    for name, (b, n, k) in shapes.items():
        u, items, bias = inputs[name]
        one = u.shape[0] == 1
        ms = time_ms(lambda: ops.topk_dot(u, items, bias, k, block_n=None),
                     iters=20)
        plain_ms = time_ms(lambda: ref.topk_dot_ref(u, items, bias, k),
                           iters=3, warmup=1)
        if one:
            lib_ms = time_ms(lambda: torch.topk(items @ u[0] + bias, k),
                             iters=20)
        else:
            lib_ms = time_ms(lambda: torch.topk(u @ items.T + bias, k),
                             iters=5, warmup=1)
        t_bound, by = bound_ms(4 * (b * d + n * d + n) + 8 * b * k,
                               2 * b * n * d)
        kernel_dev, call_dev = kernel_device_ms(
            lambda: ops.topk_dot(u, items, bias, k, block_n=None),
            "topk_dot_kernel")
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=t_bound, bound_by=by,
                           kernel_device_ms=kernel_dev,
                           call_device_ms=call_dev)
        torch.cuda.empty_cache()
    phase("topk_dot_time", **{f"{name}": {key: (round(v, 5)
                                                if isinstance(v, float)
                                                else v)
                                          for key, v in t.items()}
                              for name, t in times.items()})
    del inputs
    torch.cuda.empty_cache()
    t = times["probe"]
    return dict(name="topk_dot", route="cuda",
                source="src/repro_torch/kernels/csrc/topk_dot.cu",
                replaces="src/repro/kernels/topk_dot.py:21",
                max_abs_err=errs["probe"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                retrieval_cand=times["retrieval_cand"])


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
    return launches, params, index, stream.stream


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
    # the in-batch softmax backward's two kernels (2 launches each a step)
    bwd_ms = {side: sum(dev_us(e, True) for e in prof.key_averages()
                        if "bwd_kernel<" in e.key and flag in e.key) / 1e3
              for side, flag in (("du", "false>"), ("dv", "true>"))}
    phase("train_profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms, bwd_kernel_device_ms=bwd_ms,
          top_kernels_ms=top)


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

# ---------------------------------------------------------------------------
# The recsys families (DLRM-RM2, two-tower, DIN, BST) and embedding_bag
# ---------------------------------------------------------------------------

def embag_ids(gen, dev, v, b, bag):
    """(b, bag) int64 ids in [0, V): row 0 starts with 0, row 1 holds the
    table's top rows (V-1 down), row 2 repeats an id inside its bag, the
    last row ends with V-1."""
    ids = torch.randint(0, v, (b, bag), generator=gen, device=dev)
    ids[0, 0] = 0
    ids[1] = v - 1 - torch.arange(bag, device=dev)
    if bag > 1:
        ids[2, 1] = ids[2, 0]
    ids[-1, -1] = v - 1
    return ids


def embag_order_bound(ref, table, ids, combiner):
    """Per element, what two fp32 sums of the same bag in different orders
    may differ by: bag * eps * sum|x| (each order is within
    (bag-1) * eps/2 * sum|x| of the exact sum); for the mean, that over
    bag plus the quotient's own rounding."""
    bag = ids.shape[-1]
    eps = torch.finfo(torch.float32).eps
    mag = table[ids.long()].float().abs().sum(-2)     # gathered, not V x d
    if combiner == "mean":
        return eps * mag + eps * ref.embedding_bag_ref(table, ids,
                                                       "mean").abs()
    return bag * eps * mag


def embag_vs_plain(ops, ref, table, ids, combiner, tol) -> float:
    """Kernel vs plain, two launches bitwise equal.  ``tol`` "bitwise"
    (integer-valued tables), "close" (the models' N(0, 1/d) tables:
    within rtol 1e-6 / atol 1e-6 and the summation-order bound) or
    "order" (any scale: within the summation-order bound)."""
    got = ops.embedding_bag(table, ids, combiner)
    again = ops.embedding_bag(table, ids, combiner)
    want = ref.embedding_bag_ref(table, ids, combiner)
    torch.cuda.synchronize()
    what = f"embedding_bag {tuple(table.shape)} {table.dtype} B={ids.shape}"
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{what}: two launches differ")
    if tol == "bitwise":
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what}: not bitwise the plain version on "
                                 f"an integer-valued table")
        return 0.0
    err = (got - want).abs()
    if not bool((err <= embag_order_bound(ref, table, ids,
                                          combiner)).all()):
        raise AssertionError(f"{what}: beyond bag * eps * sum|x| of the "
                             f"plain version")
    if tol == "close" and not torch.allclose(got, want, rtol=1e-6,
                                             atol=1e-6):
        raise AssertionError(f"{what}: beyond rtol 1e-6 / atol 1e-6 of the "
                             f"plain version")
    return float(err.max())


def embag_times(ops, ref, table, ids, combiner) -> dict:
    """Kernel, plain and library ms at one shape, the kernel's device ms,
    and the byte bound (gathered rows, ids, out).  The library call
    (``F.embedding_bag``) is timed on fp32 tables only."""
    b, bag = ids.shape
    d = table.shape[1]
    iters = 20 if b <= BATCH else 10
    ms = time_ms(lambda: ops.embedding_bag(table, ids, combiner), iters)
    plain_ms = time_ms(lambda: ref.embedding_bag_ref(table, ids, combiner),
                       iters)
    lib_ms = (time_ms(lambda: torch.nn.functional.embedding_bag(
        ids, table, mode=combiner), iters)
        if table.dtype == torch.float32 else None)
    kernel_dev, _ = kernel_device_ms(
        lambda: ops.embedding_bag(table, ids, combiner), "embag_kernel")
    n_bytes = b * bag * d * table.element_size() + b * d * 4 + b * bag * 8
    t_bound, by = bound_ms(n_bytes, b * bag * d)
    return dict(ms=ms, kernel_device_ms=kernel_dev, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=t_bound, bound_by=by,
                bound_bytes=n_bytes)


def check_embedding_bag(ops, ref, dev, gen) -> dict:
    """Kernel vs plain at DLRM-RM2's multi-hot tables (V=8,000,000, d=64,
    bag 20, sum; B=512 and 262,144), two-tower's history (V=16,777,216,
    d=256, bag 50, mean; B=512: row offsets past 2^32 elements), a bf16
    table read in place, and d=12 with an odd B.  Bitwise on
    integer-valued tables, within rtol 1e-6 / atol 1e-6 on random fp32
    ones at the models' N(0, 1/d) scale.  Times at each shape; the JSON
    row carries serve_bulk's."""
    errs, times = {}, {}
    table = torch.empty((DLRM_VOCAB, 64), device=dev)
    ids = {name: embag_ids(gen, dev, DLRM_VOCAB, b, 20)
           for name, b in (("dlrm_serve_p99", BATCH),
                           ("dlrm_serve_bulk", SERVE_BULK))}
    table.random_(-8, 9, generator=gen)
    for name, i in ids.items():
        embag_vs_plain(ops, ref, table, i, "sum", "bitwise")
    t16 = table.to(torch.bfloat16)
    embag_vs_plain(ops, ref, t16, ids["dlrm_serve_bulk"], "sum",
                   "bitwise")
    table.normal_(generator=gen).mul_(64 ** -0.5)
    for name, i in ids.items():
        errs[name] = embag_vs_plain(ops, ref, table, i, "sum", "close")
        times[name] = embag_times(ops, ref, table, i, "sum")
    t16.copy_(table)
    errs["dlrm_bf16"] = embag_vs_plain(ops, ref, t16, ids["dlrm_serve_bulk"],
                                       "sum", "close")
    times["dlrm_bf16_serve_bulk"] = embag_times(
        ops, ref, t16, ids["dlrm_serve_bulk"], "sum")
    del table, t16, ids
    torch.cuda.empty_cache()

    table = torch.empty((TWO_TOWER_VOCAB, 256), device=dev)
    i = embag_ids(gen, dev, TWO_TOWER_VOCAB, BATCH, 50)
    table.random_(-8, 9, generator=gen)
    embag_vs_plain(ops, ref, table, i, "mean", "bitwise")
    table.normal_(generator=gen).mul_(256 ** -0.5)
    errs["two_tower_serve_p99"] = embag_vs_plain(ops, ref, table, i, "mean",
                                                 "close")
    times["two_tower_serve_p99"] = embag_times(ops, ref, table, i, "mean")
    del table
    torch.cuda.empty_cache()

    small = torch.empty((100_003, 12), device=dev).random_(-8, 9,
                                                           generator=gen)
    i = embag_ids(gen, dev, 100_003, 1_001, 7)
    embag_vs_plain(ops, ref, small, i, "mean", "bitwise")
    embag_vs_plain(ops, ref, small, i.to(torch.int32), "sum", "bitwise")
    small.normal_(generator=gen).mul_(12 ** -0.5)
    errs["d12_odd_b"] = embag_vs_plain(ops, ref, small, i, "mean", "close")
    small.normal_(generator=gen)
    order_err = {"d12_odd_b_unit": embag_vs_plain(ops, ref, small, i, "mean",
                                                  "order"),
                 "d12_odd_b_unit_sum": embag_vs_plain(ops, ref, small, i,
                                                      "sum", "order")}
    phase("embedding_bag", max_abs_err=errs,
          integer_tables_bitwise=("dlrm B=512", "dlrm B=262144", "dlrm bf16",
                                  "two_tower B=512", "d=12 B=1001 int32 "
                                  "and int64 ids"),
          random_tol="rtol=1e-6 atol=1e-6 and bag*eps*sum|x|",
          unit_scale_max_abs_err=order_err,
          unit_scale_tol="bag*eps*sum|x| per element")
    phase("embedding_bag_time", **{name: {k: (round(v, 5)
                                              if isinstance(v, float) else v)
                                          for k, v in t.items()}
                                   for name, t in times.items()})
    t = times["dlrm_serve_bulk"]
    return dict(name="embedding_bag", route="cuda",
                source="src/repro_torch/kernels/csrc/embedding_bag.cu",
                replaces="src/repro/kernels/embedding_bag.py:27",
                max_abs_err=max(errs.values()), ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"])


def full_batch(cfg, gen, dev, b) -> dict:
    """A request batch of ``cfg``'s family on the card, each field's raw
    ids drawn uniformly over its table's rows (the model hashes them)."""
    vocab = {t.name: t.vocab for t in cfg.tables}

    def ids(name, shape):
        return torch.randint(0, vocab[name], shape, generator=gen,
                             device=dev, dtype=torch.int32)

    if cfg.kind == "dlrm":
        out = dict(dense=torch.randn((b, cfg.n_dense), generator=gen,
                                     device=dev))
        for t in cfg.tables:
            out[t.name] = ids(t.name, (b, t.bag_size) if t.bag_size > 1
                              else (b,))
        return out
    if cfg.kind == "two_tower":
        bag = next(t.bag_size for t in cfg.tables if t.name == "user_hist")
        return dict(user_id=ids("user_id", (b,)),
                    user_hist=ids("user_hist", (b, bag)),
                    item_id=ids("item_id", (b,)),
                    item_cate=ids("item_cate", (b,)))
    s = cfg.seq_len
    return dict(user_id=ids("user_id", (b,)), context=ids("context", (b,)),
                hist_items=ids("item_id", (b, s)),
                hist_cates=ids("cate_id", (b, s)),
                target_item=ids("item_id", (b,)),
                target_cate=ids("cate_id", (b,)))


def timed_ms(fn):
    """-> (fn(), host ms around it, ending in a device sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_probabilities(out, n, what) -> None:
    if out.shape != (n,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: output {tuple(out.shape)} not {n} "
                             f"finite values")
    if not bool(((out >= 0) & (out <= 1)).all()):
        raise AssertionError(f"{what}: scores outside [0, 1]")


def serve_recsys(ops, mod, cfg, params, batches, per_call, what):
    """A warm-up call, then ``batches`` served with the launch counts set
    to 0 just before; ``per_call`` embedding_bag launches each, checked
    call by call -> (outputs, host ms per batch, launches)."""
    mod.serve(params, cfg, batches[0])
    ops.reset_launches()
    outs, times = [], []
    for batch in batches:
        before = ops.LAUNCHES["embedding_bag"]
        out, ms = timed_ms(lambda: mod.serve(params, cfg, batch))
        if ops.LAUNCHES["embedding_bag"] - before != per_call:
            raise AssertionError(
                f"{what}: {ops.LAUNCHES['embedding_bag'] - before} "
                f"embedding_bag launches in a forward, not {per_call}")
        outs.append(out)
        times.append(ms)
    launches = dict(ops.LAUNCHES)
    check_launches(launches, {"embedding_bag": per_call * len(batches)}, what)
    return outs, times, launches


def recsys_path(ops, ref, dev) -> dict:
    """DLRM-RM2 ``CONFIG`` at full width (26 tables, 10.6 GB in fp32):
    4 batches of 512 (serve_p99), one of 262,144 in a single call
    (serve_bulk) and one dense context against 1,000,000 candidate rows
    (retrieval_cand).  Holds: 4 embedding_bag launches a forward (one a
    multi-hot table), scores finite in [0, 1], and a forward at B=512
    within rtol 1e-5 / atol 1e-5 of the same forward with the plain
    embedding_bag (bag sums in another order)."""
    from repro_torch.configs.dlrm_rm2 import CONFIG as cfg
    from repro_torch.core.freq_estimator import hash_ids
    from repro_torch.models.recsys import dlrm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    (params, init_ms) = timed_ms(lambda: dlrm.init(gen, cfg, dev))
    table_gb = sum(t.numel() * t.element_size()
                   for t in params["tables"].values()) / 1e9
    batches = [full_batch(cfg, gen, dev, BATCH) for _ in range(N_BATCHES)]
    n_multi = sum(t.bag_size > 1 for t in cfg.tables)
    with torch.no_grad():
        outs, times, launches = serve_recsys(ops, dlrm, cfg, params, batches,
                                             n_multi, "DLRM-RM2 serve_p99")
        for out in outs:
            check_probabilities(out, BATCH, "DLRM-RM2 serve_p99")
        logits = dlrm.forward(params, cfg, batches[0])
        with mock.patch.object(ops, "embedding_bag",
                               ref.embedding_bag_ref):
            plain = dlrm.forward(params, cfg, batches[0])
        swap_err = float((logits - plain).abs().max())
        if not torch.allclose(logits, plain, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"DLRM-RM2: forward with the kernel differs "
                                 f"from the plain embedding_bag's by "
                                 f"{swap_err}")
        p99_peak = torch.cuda.max_memory_allocated() / 1e9
        del batches

        bulk = full_batch(cfg, gen, dev, SERVE_BULK)
        outs, bulk_times, _ = serve_recsys(ops, dlrm, cfg, params,
                                           [bulk] * 3, n_multi,
                                           "DLRM-RM2 serve_bulk")
        check_probabilities(outs[0], SERVE_BULK, "DLRM-RM2 serve_bulk")
        hash_ms = time_ms(lambda: [hash_ids(bulk[t.name], t.vocab)
                                   for t in cfg.tables], 10)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall = timed_ms(lambda: dlrm.serve(params, cfg, bulk))
        busy_ms, top = device_breakdown(prof, n_top=8)
        del outs, bulk
        bulk_peak = torch.cuda.max_memory_allocated() / 1e9

        cand = full_batch(cfg, gen, dev, RETRIEVAL_CAND)
        cand["dense"] = cand["dense"][:1]
        dlrm.retrieval(params, cfg, cand)
        ret_times = []
        for _ in range(3):
            before = ops.LAUNCHES["embedding_bag"]
            scores, ms = timed_ms(lambda: dlrm.retrieval(params, cfg, cand))
            if ops.LAUNCHES["embedding_bag"] - before != n_multi:
                raise AssertionError("DLRM-RM2 retrieval_cand: embedding_bag "
                                     "launches")
            ret_times.append(ms)
        if scores.shape != (RETRIEVAL_CAND,) or not bool(
                torch.isfinite(scores).all()):
            raise AssertionError("DLRM-RM2 retrieval_cand: scores not "
                                 "finite of shape (C,)")
        del cand, scores
    phase("recsys_path", model="dlrm-rm2 CONFIG", tables_gb=table_gb,
          init_ms=init_ms, serve_p99_ms=times,
          serve_p99_ms_median=statistics.median(times),
          serve_bulk_ms=bulk_times,
          serve_bulk_ms_median=statistics.median(bulk_times),
          retrieval_cand_ms=ret_times,
          retrieval_cand_ms_median=statistics.median(ret_times),
          embedding_bag_launches_per_forward=n_multi,
          kernel_vs_plain_forward_max_abs_err=swap_err,
          hash_ms_bulk=hash_ms, peak_gb_serve_p99=p99_peak,
          peak_gb_bulk=bulk_peak,
          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    phase("recsys_bulk_profile", wall_ms=prof_wall, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / prof_wall, top_kernels_ms=top)
    del params
    torch.cuda.empty_cache()
    return launches


def check_top_k_ties(scores, top_s, top_i, k, what) -> int:
    """top-k of ``scores`` by descending score, ties to the lower index
    (as lax.top_k) -> the number of ties inside the top-k."""
    top_i = top_i.long()
    if top_i.numel() != k or not torch.equal(scores[top_i], top_s):
        raise AssertionError(f"{what}: top scores are not the scores of the "
                             f"top ids")
    if not torch.equal(top_s, torch.topk(scores, k).values):
        raise AssertionError(f"{what}: not the k best scores")
    same = top_s[1:] == top_s[:-1]
    if bool((top_s[1:] > top_s[:-1]).any()) or bool(
            (top_i[1:][same] <= top_i[:-1][same]).any()):
        raise AssertionError(f"{what}: not descending, ties to the lower "
                             f"index")
    kth = top_s[-1]
    tied = torch.nonzero(scores == kth)[:, 0]
    taken = top_i[top_s == kth]
    if not torch.equal(torch.sort(taken).values, tied[:taken.numel()]):
        raise AssertionError(f"{what}: ties at the k-th score not taken "
                             f"from the lowest index")
    return int(same.sum())


def two_tower_path(ops, dev) -> dict:
    """Two-tower at its published widths (d=256, towers 1024-512-256, bag
    50, item_cate 65,536 rows) with the three 33,554,432-row tables cut to
    16,777,216 rows (51.5 GB in fp32; the published 103 GB does not fit
    in 80 GB): 4 batches of 512 and one user against 1,000,000 candidates
    (top-50).  Holds 1 embedding_bag launch per encode_user and the
    top-k's ties to the lower index, with the best candidate planted at
    8 more positions (exact ties where the item tower gives equal rows
    equal outputs)."""
    import dataclasses
    from repro_torch.configs.two_tower_retrieval import CONFIG
    from repro_torch.models.recsys import two_tower
    cfg = dataclasses.replace(CONFIG, tables=tuple(
        dataclasses.replace(t, vocab=min(t.vocab, TWO_TOWER_VOCAB))
        for t in CONFIG.tables))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = timed_ms(lambda: two_tower.init(gen, cfg, dev))
    table_gb = sum(t.numel() * t.element_size()
                   for t in params["tables"].values()) / 1e9
    batches = [full_batch(cfg, gen, dev, BATCH) for _ in range(N_BATCHES)]
    with torch.no_grad():
        outs, times, launches = serve_recsys(ops, two_tower, cfg, params,
                                             batches, 1, "two-tower serve")
        for out in outs:
            if out.shape != (BATCH,) or not bool(torch.isfinite(out).all()):
                raise AssertionError("two-tower serve: scores not finite")
        user = full_batch(cfg, gen, dev, 1)
        cand = dict(user_id=user["user_id"], user_hist=user["user_hist"],
                    cand_items=torch.randint(0, TWO_TOWER_VOCAB,
                                             (RETRIEVAL_CAND,), generator=gen,
                                             device=dev, dtype=torch.int32),
                    cand_cates=torch.randint(0, 65_536, (RETRIEVAL_CAND,),
                                             generator=gen, device=dev,
                                             dtype=torch.int32))
        best = int(two_tower.retrieval(params, cfg, cand)["scores"].argmax())
        at = torch.randint(0, RETRIEVAL_CAND, (8,), generator=gen,
                           device=dev)
        cand["cand_items"][at] = int(cand["cand_items"][best])
        cand["cand_cates"][at] = int(cand["cand_cates"][best])
        ret_times = []
        for _ in range(3):
            before = ops.LAUNCHES["embedding_bag"]
            out, ms = timed_ms(lambda: two_tower.retrieval(params, cfg, cand,
                                                           top_k=50))
            if ops.LAUNCHES["embedding_bag"] - before != 1:
                raise AssertionError("two-tower retrieval: embedding_bag "
                                     "launches")
            ret_times.append(ms)
        if not bool(torch.isfinite(out["scores"]).all()):
            raise AssertionError("two-tower retrieval: scores not finite")
        ties = check_top_k_ties(out["scores"], out["top_scores"],
                                out["top_idx"], 50, "two-tower retrieval")
        del cand, out
    phase("two_tower_path", model="two-tower-retrieval CONFIG, tables cut "
          f"to {TWO_TOWER_VOCAB} rows", tables_gb=table_gb, init_ms=init_ms,
          serve_p99_ms=times, serve_p99_ms_median=statistics.median(times),
          retrieval_cand_top50_ms=ret_times,
          retrieval_cand_ms_median=statistics.median(ret_times),
          embedding_bag_launches_per_encode_user=1,
          ties_in_top50=ties, top_k_ties_to_lower_index=True,
          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params
    torch.cuda.empty_cache()
    return launches


def din_bst_path(ops, dev) -> None:
    """DIN and BST ``CONFIG`` at full width (1.8 and 3.2 GB of tables):
    4 batches of 512 each, scores finite in [0, 1], no embedding_bag on
    their path.  DIN's retrieval_cand is left out: its (1, C, S, 8d)
    interaction at C=1,000,000, S=100, d=18 is 57.6 GB."""
    from repro_torch.configs import bst as bst_cfg
    from repro_torch.configs import din as din_cfg
    from repro_torch.models.recsys import bst, din
    readings = {}
    for name, mod, cfg in (("din", din, din_cfg.CONFIG),
                           ("bst", bst, bst_cfg.CONFIG)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        params = mod.init(gen, cfg, dev)
        batches = [full_batch(cfg, gen, dev, BATCH) for _ in range(N_BATCHES)]
        with torch.no_grad():
            outs, times, _ = serve_recsys(ops, mod, cfg, params, batches, 0,
                                          f"{name} serve")
        for out in outs:
            check_probabilities(out, BATCH, f"{name} serve")
        readings[name] = dict(
            tables_gb=sum(t.numel() * 4 for t in params["tables"].values())
            / 1e9, serve_p99_ms=times,
            serve_p99_ms_median=statistics.median(times),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params, batches, outs
        torch.cuda.empty_cache()
    phase("din_bst_path", **readings)


def small_recsys_retrieval_batch(cfg, rng) -> dict:
    c = 24
    if cfg.kind == "dlrm":
        rb = {t.name: rng.integers(0, t.vocab, (c, t.bag_size)
                                   if t.bag_size > 1 else (c,))
              .astype(np.int32) for t in cfg.tables}
        rb["dense"] = rng.normal(size=(1, cfg.n_dense)).astype(np.float32)
        return rb
    if cfg.kind == "two_tower":
        return dict(user_id=np.asarray([3], np.int32),
                    user_hist=rng.integers(0, 1000, (1, cfg.tables[1]
                                                     .bag_size))
                    .astype(np.int32),
                    cand_items=rng.integers(0, 1000, c).astype(np.int32),
                    cand_cates=rng.integers(0, 50, c).astype(np.int32))
    s = cfg.seq_len
    return dict(user_id=np.asarray([3], np.int32),
                context=np.asarray([1], np.int32),
                hist_items=rng.integers(0, 1000, (1, s)).astype(np.int32),
                hist_cates=rng.integers(0, 50, (1, s)).astype(np.int32),
                cand_items=rng.integers(0, 1000, c).astype(np.int32),
                cand_cates=rng.integers(0, 50, c).astype(np.int32))


def recsys_small_reference(dev) -> None:
    """Each recsys smoke config on the card and on the CPU from the same
    seeded params and numpy batches: serve, retrieval and loss within rtol
    1e-4 / atol 1e-5, and 5 steps of the smoke trainer: losses within
    rtol 1e-4 / atol 1e-5, every param leaf within rtol 1e-3 / atol 1e-4
    but the shift-free ones (ROADMAP C9), held within 2 * steps * lr."""
    from repro_torch.configs import RECSYS_ARCHS, get_smoke
    from repro_torch.launch.train import _smoke_recsys_batch, _train_recsys
    from repro_torch.models.recsys import _RECSYS_MODS
    from repro_torch.utils import tree
    worst = {}
    for arch in RECSYS_ARCHS:
        cfg = get_smoke(arch)
        mod = _RECSYS_MODS[cfg.kind]
        params = mod.init(torch.Generator().manual_seed(SEED), cfg,
                          "cpu")
        rb = small_recsys_retrieval_batch(cfg, np.random.default_rng(SEED))
        runs = {}
        for device in ("cpu", dev):
            p = tree.to_device(params, device)
            b = _smoke_recsys_batch(cfg, np.random.default_rng(SEED), 16,
                                    device)
            r = {k: torch.from_numpy(v).to(device) for k, v in rb.items()}
            with torch.no_grad():
                serve = mod.serve(p, cfg, b)
                retr = (mod.retrieval(p, cfg, r, top_k=8)
                        if cfg.kind == "two_tower"
                        else dict(scores=mod.retrieval(p, cfg, r)))
            loss = mod.loss(p, cfg, b)[0]
            p5, losses = _train_recsys(cfg, p, np.random.default_rng(SEED),
                                       SMOKE_STEPS, 8, device)
            runs[str(device)] = dict(
                serve=serve.cpu(), loss=float(loss),
                retr={k: v.cpu() for k, v in retr.items()},
                params=tree.to_device(p5, "cpu"), losses=losses)
        a, b = runs["cpu"], runs[str(dev)]
        for name, x, y in (("serve", a["serve"], b["serve"]),
                           ("retrieval", a["retr"]["scores"],
                            b["retr"]["scores"]),
                           ("loss", torch.tensor(a["loss"]),
                            torch.tensor(b["loss"])),
                           ("5-step losses", torch.tensor(a["losses"]),
                            torch.tensor(b["losses"]))):
            if not torch.allclose(y, x, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"small {arch}: {name} on the card "
                                     f"differs from the CPU's")
        if "top_idx" in a["retr"]:
            s = a["retr"]["scores"]
            ok, _, _ = near_tie_ok(lambda rows, ids: s[ids.long()],
                                   b["retr"]["top_idx"][None],
                                   a["retr"]["top_idx"][None])
            if not ok:
                raise AssertionError(f"small {arch}: top-k ids differ "
                                     f"outside near-ties")
        for (path, x), y in zip(tree.flatten_with_path(b["params"]),
                                tree.leaves(a["params"])):
            diff = float((x - y).abs().max())
            worst[f"{arch}:{'/'.join(map(str, path))}"] = diff
            if path in SHIFT_FREE.get(arch, ()):
                if diff > 2 * SMOKE_STEPS * ADAM_LR:
                    raise AssertionError(f"small {arch}: {path} moved {diff}")
            elif not torch.allclose(x, y, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"small {arch}: {path} after "
                                     f"{SMOKE_STEPS} steps differs from the "
                                     f"CPU's by {diff}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    phase("recsys_small_reference", archs=",".join(RECSYS_ARCHS),
          close="serve/retrieval/loss rtol=1e-4 atol=1e-5",
          train_steps=SMOKE_STEPS, largest_leaf_diffs=top)


# ---------------------------------------------------------------------------
# the dense LM family: flash_attention, Qwen3-0.6B prefill and decode
# ---------------------------------------------------------------------------

QWEN_S = 32_768              # prefill_32k's sequence (batch cut 32 -> 1)
TRAIN_4K = (8, 4_096)        # a train_4k sequence run forward (batch 256 -> 8)
GEN_STEPS = 8                # greedy tokens from the 32,768-token prompt
DECODE_B = 8                 # decode_32k's batch, cut from 128
VS_PLAIN_S = 4_096           # the fp32 full-width forward, kernel vs plain
# (S, hd, causal) of the reference's single-head kernel tests
FLASH_SINGLE = ((128, 64, True), (256, 32, False), (128, 128, True),
                (64, 16, True), (48, 20, True))


def attn_inputs(gen, dev, b, s, h, hk, hd, dtype):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd))]


# kernel vs plain: fp32 the reference's sweep test; bf16: both compute in
# fp32 from the same inputs and round once, so they differ by at most one
# bf16 ulp (at most 2^-7 of the value) where the fp32 sums round apart
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=8e-3, atol=1e-5)}


def flash_vs_plain(ops, ref, q, k, v, causal, what) -> float:
    """Kernel vs plain within ``FLASH_TOL`` -> max |error|."""
    got = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    if got.dtype != q.dtype or not torch.allclose(got.float(), want.float(),
                                                  **tol):
        raise AssertionError(f"flash_attention {what}: differs from the "
                             f"plain version beyond {tol}")
    return float((got.float() - want.float()).abs().max())


def causal_pairs(s: int, t: int) -> int:
    """(query, key) pairs a causal attention keeps: query i sees
    min(t, i + t - s + 1) keys."""
    return sum(min(t, i + t - s + 1) for i in range(s))


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by a short name: ``tc_hdp<N>`` (the bf16 route at padded head
    dim N) or ``simt_nc<N>`` (the fp32 route)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?(flash_tc_kernel|"
                          r"flash_kernel)I(?:f)?Li(\d+)E", line)
        if entry:
            kind = "tc_hdp" if entry.group(1) == "flash_tc_kernel" else \
                "simt_nc"
            name = kind + entry.group(2)
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
    return out


def ptxas_entries(log: str, kernels: tuple) -> dict:
    """Registers and spill bytes of each entry function of an ``nvcc
    -Xptxas -v`` log whose mangled name holds one of ``kernels``, named
    after it with its template integers (``bwd_kernel<64,1>``)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            hit = next((k for k in kernels if k in entry.group(1)), None)
            name = None
            if hit:
                args = re.match(r"I((?:L[a-z]\d+E)+)E",
                                entry.group(1).split(hit, 1)[1])
                ints = re.findall(r"L[a-z](\d+)E", args.group(1)) \
                    if args else []
                name = hit + (f"<{','.join(ints)}>" if ints else "")
                out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
    return out


def attn_fp64(q, k, v) -> torch.Tensor:
    """Causal attention in fp64 (GQA repeated): the exact yardstick."""
    s, t, rep = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    q, k, v = (x.double() for x in (q, k, v))
    k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    pos = torch.arange(t, device=q.device)
    logits = logits.masked_fill(pos[None, :] > pos[:s, None] + (t - s),
                                -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v)


def flash_wide_logits(ops, ref, dev) -> None:
    """Logits x 30 (std about 25, so P spans many binades and its second
    and third bf16 parts carry weight), B=2, S=T=300, H=4, Hk=2, hd=128,
    bf16.  (a) q of +-30 or 0 and k on a 2^-6 grid: every q . k is exact
    in fp32 in any order, so kernel and plain share their logits; counts
    of outputs outside the bf16 tolerance of plain, for the kernel and
    the library (a bf16 P).  (b) normal q x 30: errors against an fp64
    attention of the kernel, the plain fp32 version and the library."""
    g = np.random.default_rng(SEED)
    shapes = ((2, 300, 4, 128), (2, 300, 2, 128), (2, 300, 2, 128))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, k, v):
        return sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2)

    def outside(got, want, extra=0.0) -> int:
        tol = FLASH_TOL[torch.bfloat16]
        return int(((got.double() - want.double()).abs() > tol["atol"]
                    + extra + tol["rtol"] * want.double().abs()).sum())

    exact = (30 * g.integers(-1, 2, size=shapes[0]),
             np.clip(np.round(g.normal(size=shapes[1]) * 64), -255,
                     255) / 64, g.normal(size=shapes[2]))
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(dev)
               .to(torch.bfloat16) for x in exact)
    want = ref.flash_attention_ref(q, k, v)
    exact_dots = dict(kernel_outside=outside(ops.flash_attention(q, k, v),
                                             want),
                      library_outside=outside(library(q, k, v), want),
                      n=want.numel())
    q, k, v = (torch.from_numpy(g.normal(size=sh).astype(np.float32))
               .to(dev) for sh in shapes)
    q, k, v = (q * 30).to(torch.bfloat16), k.to(torch.bfloat16), \
        v.to(torch.bfloat16)
    truth = attn_fp64(q, k, v)
    plain_err = float((ref.flash_attention_ref(q.float(), k.float(),
                                               v.float()).double()
                       - truth).abs().max())
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    normal = dict(plain_fp32_max_abs_err=plain_err,
                  kernel_max_abs_err=float((got.double() - truth).abs()
                                           .max()),
                  kernel_outside=outside(got, truth),
                  kernel_outside_plus_plain_err=outside(got, truth,
                                                        plain_err),
                  library_outside=outside(library(q, k, v), truth),
                  n=truth.numel())
    if exact_dots["kernel_outside"] or normal["kernel_outside_plus_plain_err"]:
        raise AssertionError(f"flash_attention at logits x 30: exact dots "
                             f"{exact_dots}, against fp64 {normal}")
    phase("flash_attention_wide", shape=(2, 300, 4, 2, 128), dtype="bf16",
          exact_dots_vs_plain=exact_dots, normal_vs_fp64=normal,
          tol="bf16 rtol=8e-3 atol=1e-5 (+ plain's own fp64 error)")


def check_flash_attention(ops, ref, build, dev, gen) -> dict:
    """Kernel vs plain at the reference's single-head cases, a ragged
    S=4,100, Qwen3-0.6B's layer (B=1, S=32,768, H=16, Hk=8, hd=128) in
    bf16 and fp32 and SmolLM-360M's (B=8, S=4,096, H=15, Hk=5, hd=64) in
    bf16; times at Qwen3's layer: the bf16 route (tensor cores), the fp32
    route (SIMT), the plain version and the library's bf16 attention, and
    the library's error against the same plain version."""
    errs = {}
    for s, hd, causal in FLASH_SINGLE:
        for dtype in ((torch.float32, torch.bfloat16) if hd == 20
                      else (torch.float32,)):
            q, k, v = (x[0, :, 0] for x in attn_inputs(gen, dev, 1, s, 1, 1,
                                                       hd, dtype))
            name = f"S={s} hd={hd} causal={causal} {str(dtype)[6:]}"
            errs[name] = flash_vs_plain(ops, ref, q, k, v, causal, name)
    shapes = {"ragged S=4100 fp32": (1, 4_100, 16, 8, 128, torch.float32),
              "qwen3 bf16": (1, QWEN_S, 16, 8, 128, torch.bfloat16),
              "qwen3 fp32": (1, QWEN_S, 16, 8, 128, torch.float32),
              "smollm B=8 bf16": (8, 4_096, 15, 5, 64, torch.bfloat16)}
    for name, (b, s, h, hk, hd, dtype) in shapes.items():
        q, k, v = attn_inputs(gen, dev, b, s, h, hk, hd, dtype)
        errs[name] = flash_vs_plain(ops, ref, q, k, v, True, name)
        del q, k, v
        torch.cuda.empty_cache()
    phase("flash_attention_check", max_abs_err=errs,
          tol="fp32 rtol=1e-4 atol=1e-5, bf16 rtol=8e-3 atol=1e-5")
    flash_wide_logits(ops, ref, dev)

    b, s, h, hk, hd = 1, QWEN_S, 16, 8, 128
    q, k, v = attn_inputs(gen, dev, b, s, h, hk, hd, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # both against the same plain version: the kernel keeps P in fp32, the
    # library rounds P to bf16
    want = ref.flash_attention_ref(q, k, v).float()
    kernel_err = float((ops.flash_attention(q, k, v).float() - want)
                       .abs().max())
    library_err = float((sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
                         .transpose(1, 2).float() - want).abs().max())
    del want
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 5, warmup=1)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), 2,
                       warmup=1)
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                  enable_gqa=True), 5)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fp32_ms = time_ms(lambda: ops.flash_attention(q32, k32, v32), 2,
                      warmup=1)
    del q32, k32, v32
    # each kept (query, key) pair: 2 hd flop of q.k^T on the bf16 tensor
    # cores (an fp32 accumulate of bf16 products is exact), one exp, and
    # 3 x 2 hd flop of P.V (P split into three exact bf16 parts, three
    # passes on the tensor cores, which q.k^T shares); the bound is the
    # slowest of the pipes
    pairs = h * b * causal_pairs(s, s)
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    parts = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "tensor_qk_3pv": 8 * hd * pairs / BF16_TC_FLOP_PER_S * 1e3,
             "exp_mufu": pairs / EXP_PER_S * 1e3}
    part = max(parts, key=parts.get)
    t_bound, by = parts[part], "bytes" if part == "bytes" else "operations"
    # the fp32 route: both products in the fp32 pipes
    fp32_bound = 4 * hd * pairs / FP32_FLOP_PER_S * 1e3
    phase("flash_attention_time", shape=(b, s, h, hk, hd), dtype="bf16",
          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          library="F.scaled_dot_product_attention(is_causal, enable_gqa)",
          max_abs_err_vs_plain=kernel_err,
          library_max_abs_err_vs_plain=library_err,
          bound_ms=t_bound, bound_by=by, bound_set_by=part,
          bound_parts_ms=parts, n_exp=pairs,
          share_of_bound=t_bound / ms,
          tflop_per_s_qk_3pv=8 * hd * pairs / ms / 1e9,
          qk_bf16_tensor_ms=2 * hd * pairs / BF16_TC_FLOP_PER_S * 1e3,
          pv_3x_bf16_tensor_ms=6 * hd * pairs / BF16_TC_FLOP_PER_S * 1e3,
          pv_fp32_ms=2 * hd * pairs / FP32_FLOP_PER_S * 1e3,
          both_products_fp32_ms=fp32_bound,
          fp32_route_ms=fp32_ms, fp32_route_bound_ms=fp32_bound,
          ptxas=ptxas_usage(build.build_log("flash_attention")))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:63",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms)


def lm_tokens(rng, vocab, b, s) -> torch.Tensor:
    from repro_torch.data.streaming import lm_batch
    return torch.from_numpy(lm_batch(rng, b, s, vocab)["tokens"])


def check_logits(logits, cfg, what) -> None:
    """Finite, the vocab padding masked to -1e30."""
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: logits not finite")
    if cfg.padded_vocab > cfg.vocab and not bool(
            (logits[..., cfg.vocab:] <= -1e29).all()):
        raise AssertionError(f"{what}: vocab padding not masked")


def lm_prefill_path(ops, dev) -> dict:
    """Qwen3-0.6B ``CONFIG`` (bf16, random weights from a seed): prefill
    at B=1 x 32,768 (prefill_32k, batch cut from 32) and B=8 x 4,096 (a
    train_4k sequence, forward only), a warm-up call and a timed one each.
    Holds: 28 flash_attention launches a prefill, finite logits, the
    padding masked.  -> the launch counts of the timed 32,768 prefill."""
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.models.lm import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, init_ms = timed_ms(lambda: tfm.init_lm(gen, cfg, dev))
    rng = np.random.default_rng(SEED)
    readings, launches = {}, None
    with torch.no_grad():
        for name, (b, s) in (("prefill_32k_b1", (1, QWEN_S)),
                             ("train_4k_b8", TRAIN_4K)):
            toks = lm_tokens(rng, cfg.vocab, b, s).to(dev)
            tfm.prefill(params, cfg, toks)            # warm-up
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            (logits, cache), ms = timed_ms(lambda: tfm.prefill(params, cfg,
                                                               toks))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            counts = dict(ops.LAUNCHES)
            check_launches(counts, {"flash_attention": cfg.n_layers},
                           f"a {name} prefill")
            check_logits(logits, cfg, name)
            if cache.k.shape != (cfg.n_layers, b, s, cfg.n_kv_heads,
                                 cfg.resolved_head_dim) or cache.pos != s:
                raise AssertionError(f"{name}: cache {tuple(cache.k.shape)}")
            readings[name] = dict(ms=ms, tokens_per_s=b * s / ms * 1e3,
                                  peak_gb=peak_gb)
            launches = launches or counts
            del logits, cache, toks
            torch.cuda.empty_cache()
    phase("lm_prefill", model="qwen3-0.6b CONFIG bf16",
          params_b=cfg.n_params() / 1e9, init_ms=init_ms,
          flash_attention_launches_per_prefill=cfg.n_layers, **readings)
    del params
    torch.cuda.empty_cache()
    return launches


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at |x| > 0."""
    return 2.0 ** (math.frexp(x)[1] - 8)


def profile_decode(tfm, params, cfg, tok, cache) -> dict:
    """One profiled ``decode_step``: wall ms, busy device ms, top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed_ms(lambda: tfm.decode_step(params, cfg, tok, cache))
    busy, top = device_breakdown(prof, n_top=5)
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                top_kernels_ms=top)


def lm_generate_path(dev) -> None:
    """``greedy_generate`` for 8 tokens from a 32,768-token prompt at B=1,
    prefill and each decode step timed apart; then the prefill's cache
    copied to B=8 (decode_32k's batch, cut from 128) and the same 7
    decode steps run at B=8 on the batch-1 tokens.  Holds: the 8 rows
    bitwise equal; each row's logits within 2e-2 of the largest |logit|
    (the bf16 bound) of the batch-1 step's; each row's greedy token the
    batch-1 token, or a flip between two tokens whose batch-1 logits are
    equal or adjacent bf16 values (one ulp apart: the B=8 GEMMs sum in
    another order than the B=1 ones, and one rounding decides such a
    tie).  The exact token check at B=8 is made in fp32
    (``lm_vs_plain_path``)."""
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.models.lm import KVCache
    from repro_torch.models.lm import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tfm.init_lm(gen, cfg, dev)
    prompt = lm_tokens(np.random.default_rng(SEED + 1), cfg.vocab, 1,
                       QWEN_S).to(dev)
    times = {"prefill": [], "decode_step": []}
    kept = {"logits": []}
    v = cfg.vocab

    def timed(name, fn):
        def run(*args, **kw):
            out, ms = timed_ms(lambda: fn(*args, **kw))
            times[name].append(ms)
            if name == "prefill":
                kept["cache"] = out[1]
            else:
                kept["logits"].append(out[0][0, -1, :v].float())
            return out
        return run

    with torch.no_grad():
        with mock.patch.object(tfm, "prefill",
                               timed("prefill", tfm.prefill)), \
                mock.patch.object(tfm, "decode_step",
                                  timed("decode_step", tfm.decode_step)):
            toks = tfm.greedy_generate(params, cfg, prompt, GEN_STEPS)
        if toks.shape != (1, GEN_STEPS) or not bool(
                ((toks >= 0) & (toks < v)).all()):
            raise AssertionError(f"greedy_generate gave {toks.tolist()}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c1 = kept.pop("cache")
        prof_b1 = profile_decode(tfm, params, cfg, toks[:, :1],
                                 tfm.grow_cache(c1, 1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shape = list(c1.k.shape)
        shape[1], shape[2] = DECODE_B, QWEN_S + GEN_STEPS
        cache = KVCache(k=c1.k.new_zeros(shape), v=c1.v.new_zeros(shape),
                        pos=c1.pos)
        cache.k[:, :, :QWEN_S] = c1.k
        cache.v[:, :, :QWEN_S] = c1.v
        del c1
        cache_gb = 2 * cache.k.numel() * cache.k.element_size() / 1e9
        b8_ms, errs, flips = [], [], []
        for i in range(GEN_STEPS - 1):
            tok = toks[:, i:i + 1].expand(DECODE_B, 1).contiguous()
            (logits, cache), ms = timed_ms(
                lambda: tfm.decode_step(params, cfg, tok, cache))
            b8_ms.append(ms)
            check_logits(logits, cfg, "decode B=8")
            rows = logits[:, -1, :v].float()
            if not torch.equal(rows, rows[:1].expand_as(rows)):
                raise AssertionError(f"decode B={DECODE_B}: rows differ")
            one = kept["logits"][i]
            err = float((rows[0] - one).abs().max())
            errs.append(err)
            if err > 2e-2 * float(one.abs().max()):
                raise AssertionError(f"decode B={DECODE_B} step {i}: logits "
                                     f"differ from batch 1's by {err}")
            got, want = int(rows[0].argmax()), int(toks[0, i + 1])
            if got != want:
                gap = float(one[want] - one[got])
                ulp = bf16_ulp(max(abs(float(one[want])),
                                   abs(float(one[got]))))
                if gap > ulp:
                    raise AssertionError(
                        f"decode B={DECODE_B} step {i}: token {got}, batch 1 "
                        f"{want}, batch-1 logit gap {gap} > one bf16 ulp "
                        f"{ulp}")
                flips.append(dict(step=i, b8=got, b1=want, b1_gap=gap,
                                  ulp=ulp))
        # the cache's last free slot
        prof_b8 = profile_decode(tfm, params, cfg, toks[:, -1:].expand(
            DECODE_B, 1).contiguous(), cache)
    phase("lm_generate", model="qwen3-0.6b CONFIG bf16", prompt=QWEN_S,
          tokens=toks[0].tolist(), prefill_ms=times["prefill"],
          decode_step_ms_b1=times["decode_step"],
          decode_b8_cache_gb=cache_gb, decode_step_ms_b8=b8_ms,
          decode_step_ms_b8_median=statistics.median(b8_ms),
          b8_rows_equal=True, b8_vs_b1_logits_max_abs_err=errs,
          b8_tokens_equal_b1=f"{GEN_STEPS - 1 - len(flips)} of "
                             f"{GEN_STEPS - 1} steps",
          b8_near_tie_flips=flips or "none",
          peak_gb_b8=torch.cuda.max_memory_allocated() / 1e9)
    phase("lm_decode_profile", b1=prof_b1, b8=prof_b8)
    del params, cache, logits
    torch.cuda.empty_cache()


def lm_vs_plain_path(ops, ref, dev) -> None:
    """Qwen3-0.6B ``CONFIG`` in fp32 at B=1, S=4,096: the logits with the
    kernel against the same forward with the plain flash_attention; then
    prefill(S-4) and 4 decode steps against the forward's logits (the
    reference's decode contract, tests/test_lm.py), and the same 4 steps
    at B=8 on a copy of the prefill's cache: each row's logits within
    2e-4 of the B=1 step's and its greedy token B=1's."""
    import dataclasses
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.models.lm import KVCache
    from repro_torch.models.lm import transformer as tfm
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         dev)
    toks = lm_tokens(np.random.default_rng(SEED + 2), cfg.vocab, 1,
                     VS_PLAIN_S).to(dev)
    v = cfg.vocab
    with torch.no_grad():
        ops.reset_launches()
        logits, _, _ = tfm.forward(params, cfg, toks)
        if ops.LAUNCHES["flash_attention"] != cfg.n_layers:
            raise AssertionError("fp32 forward: flash_attention launches")
        with mock.patch.object(ops, "flash_attention",
                               ref.flash_attention_ref):
            plain, _, _ = tfm.forward(params, cfg, toks)
        err = float((logits[..., :v] - plain[..., :v]).abs().max())
        agree = float((logits[..., :v].argmax(-1)
                       == plain[..., :v].argmax(-1)).float().mean())
        if not torch.allclose(logits[..., :v], plain[..., :v], rtol=1e-4,
                              atol=1e-4) or agree < 0.999:
            raise AssertionError(f"fp32 forward with the kernel vs plain: "
                                 f"max |diff| {err}, argmax agreement "
                                 f"{agree}")
        del plain
        n = VS_PLAIN_S - 4
        lp, cache = tfm.prefill(params, cfg, toks[:, :n])
        errs = [float((lp[..., :v] - logits[:, :n, :v]).abs().max())]
        del lp
        cache = tfm.grow_cache(cache, 4)
        cache8 = KVCache(k=cache.k.repeat(1, DECODE_B, 1, 1, 1),
                         v=cache.v.repeat(1, DECODE_B, 1, 1, 1),
                         pos=cache.pos)
        b8_errs, b8_tokens = [], 0
        for i in range(n, VS_PLAIN_S):
            tok = toks[:, i:i + 1]
            ld, cache = tfm.decode_step(params, cfg, tok, cache)
            errs.append(float((ld[:, 0, :v] - logits[:, i, :v]).abs()
                              .max()))
            l8, cache8 = tfm.decode_step(
                params, cfg, tok.expand(DECODE_B, 1).contiguous(), cache8)
            b8_errs.append(float((l8[:, 0, :v] - ld[:, 0, :v]).abs().max()))
            if not torch.equal(l8[:, 0, :v].argmax(-1),
                               ld[:, 0, :v].argmax(-1).expand(DECODE_B)):
                raise AssertionError(f"fp32 decode B={DECODE_B} step {i}: "
                                     f"a greedy token differs from B=1's")
            b8_tokens += DECODE_B
        if max(errs) >= 2e-4:
            raise AssertionError(f"decode vs forward at full width: {errs}")
        if max(b8_errs) >= 2e-4:
            raise AssertionError(f"fp32 decode B={DECODE_B} vs B=1: "
                                 f"{b8_errs}")
        del cache8, l8
    phase("lm_full_width_vs_plain", model="qwen3-0.6b CONFIG fp32",
          seq=VS_PLAIN_S, kernel_vs_plain_max_abs_err=err,
          kernel_vs_plain_tol="rtol=1e-4 atol=1e-4", argmax_agreement=agree,
          decode_vs_forward_max_abs_err=errs, decode_tol="< 2e-4",
          decode_b8_vs_b1_max_abs_err=b8_errs,
          decode_b8_tokens_equal_b1=f"{b8_tokens} of {b8_tokens}")
    del params, logits, cache
    torch.cuda.empty_cache()


# Adam's eps: where an element's root-mean-square gradient is below 100
# eps, its step g / (sqrt(v) + eps) follows the gradient's rounding noise
# (ROADMAP.md C10)
EPS_CONDITIONED = 100 * 1e-8


def eps_conditioned_adamw(make, masks: dict):
    """``make`` (the smoke trainer's ``adamw``) wrapped so that ``masks``
    gathers, per leaf index, the elements whose bias-corrected second
    moment was nonzero and below EPS_CONDITIONED**2 after some step."""
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.utils import tree

    def recording(lr):
        opt = make(lr)

        def update(grads, state, params, step):
            params, state = opt.update(grads, state, params, step)
            bc2 = 1.0 - 0.999 ** (int(step) + 1)
            for i, v in enumerate(tree.leaves(state["v"])):
                v_hat = v / bc2
                m = (v_hat > 0) & (v_hat < EPS_CONDITIONED ** 2)
                masks[i] = masks[i] | m if i in masks else m
            return params, state
        return Optimizer(opt.init, update)
    return recording


def lm_small_reference(ops, dev) -> None:
    """The dense LM smoke configs on the card against the CPU from the
    same seeded params: forward with block_kv=8 (2 flash_attention
    launches on the card) within rtol 1e-4 / atol 1e-5, greedy tokens
    equal, and 5 smoke-trainer steps: losses within rtol 1e-4 / atol
    1e-5, and every param element too but those whose Adam steps the
    CPU run found conditioned by eps (ROADMAP C10; at most 1% of the
    elements), which are held within 2 * steps * lr, as
    tests/test_torch_lm.py holds the CPU run to the reference's."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_mod
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.utils import tree
    off, worst, n_noisy, n_all = {}, {}, 0, 0
    for arch in ("smollm-360m", "yi-9b", "qwen3-0.6b"):
        cfg = get_smoke(arch)
        params = tfm.init_lm(torch.Generator().manual_seed(SEED), cfg, "cpu")
        toks = lm_tokens(np.random.default_rng(SEED), cfg.vocab, 2, 24)
        runs = {}
        for device in ("cpu", dev):
            p = tree.to_device(params, device)
            t = toks.to(device)
            ops.reset_launches()
            with torch.no_grad():
                logits, _, _ = tfm.forward(p, cfg, t, block_kv=8)
                gen = tfm.greedy_generate(p, cfg, t, 5)
            launches = ops.LAUNCHES["flash_attention"]
            masks = {}
            recording = eps_conditioned_adamw(train_mod.adamw, masks)
            with mock.patch.object(train_mod, "adamw", recording):
                p5, losses = train_mod._train_lm(
                    cfg, p, np.random.default_rng(SEED), SMOKE_STEPS, 8,
                    device)
            runs[str(device)] = dict(logits=logits.cpu(), gen=gen.cpu(),
                                     launches=launches, losses=losses,
                                     params=tree.to_device(p5, "cpu"),
                                     noisy=[masks[i].cpu()
                                            for i in sorted(masks)])
        a, b = runs["cpu"], runs[str(dev)]
        if b["launches"] != cfg.n_layers or a["launches"] != 0:
            raise AssertionError(f"small {arch}: flash_attention launched "
                                 f"{b['launches']} times on the card")
        if not torch.allclose(b["logits"], a["logits"], rtol=1e-4,
                              atol=1e-5):
            raise AssertionError(f"small {arch}: forward on the card differs")
        if not torch.equal(b["gen"], a["gen"]):
            raise AssertionError(f"small {arch}: greedy tokens differ")
        if not np.allclose(b["losses"], a["losses"], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"small {arch}: 5-step losses differ")
        for (path, x), y, noisy in zip(tree.flatten_with_path(b["params"]),
                                       tree.leaves(a["params"]), a["noisy"]):
            diff = float((x - y).abs().max())
            key = f"{arch}:{'/'.join(map(str, path))}"
            worst[key] = diff
            close = torch.isclose(x, y, rtol=1e-4, atol=1e-5)
            if bool((~close & ~noisy).any()):
                raise AssertionError(
                    f"small {arch}: {path} after {SMOKE_STEPS} steps differs "
                    f"from the CPU's by {diff} at elements whose Adam steps "
                    f"eps does not condition")
            if bool(noisy.any()) and float(
                    (x - y)[noisy].abs().max()) > 2 * SMOKE_STEPS * ADAM_LR:
                raise AssertionError(f"small {arch}: {path} moved {diff}")
            if not bool(close.all()):
                off[key] = (diff, int((~close).sum()))
            n_noisy += int(noisy.sum())
            n_all += noisy.numel()
    if n_noisy > 0.01 * n_all:
        raise AssertionError(f"{n_noisy} of {n_all} param elements have Adam "
                             f"steps conditioned by eps")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    phase("lm_small_reference", archs="smollm-360m,yi-9b,qwen3-0.6b",
          close="forward rtol=1e-4 atol=1e-5, tokens equal",
          train_steps=SMOKE_STEPS,
          eps_conditioned_elements=f"{n_noisy} of {n_all}",
          leaves_off_tol=off or "none",
          largest_leaf_diffs=top)


def main(argv=None) -> int:
    """``argv``: names of kernel sources (``build.KERNELS``) whose phases
    alone to run, with no main path and no final line; none runs all."""
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=repr(card),
          torch=torch.__version__, cuda=torch.version.cuda)

    cfg = CONFIG
    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks = {
        "cluster_rank": lambda: [check_cluster_rank(ops, ref, cfg, dev, gen)],
        "merge_serve": lambda: [
            check_merge_serve(ops, ref, cfg, dev, gen, 256),
            check_merge_serve_ds(ops, ref, cfg, dev, gen, 256)],
        "fused_gather_rank": lambda: [
            check_fused_gather_rank(ops, ref, cfg, dev, gen, 256)],
        "vq_assign": lambda: [check_vq_assign(ops, ref, cfg, dev, gen)],
        "inbatch_softmax": lambda: check_inbatch_softmax(ops, ref, cfg, dev,
                                                         gen),
        "ema_segment_sum": lambda: [
            check_ema_segment_sum(ops, ref, cfg, dev, gen)],
        "topk_dot": lambda: [check_topk_dot(ops, ref, cfg, dev, gen)],
        "embedding_bag": lambda: [check_embedding_bag(ops, ref, dev, gen)],
        "flash_attention": lambda: [
            check_flash_attention(ops, ref, build, dev, gen)]}
    only = [name for name in (argv or []) if name]
    unknown = set(only) - set(checks)
    if unknown:
        print(f"chip_smoke: unknown kernel sources {sorted(unknown)}; "
              f"known: {sorted(checks)}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    built = build.build(only or build.KERNELS)
    for name in built:
        build.load(name)
    phase("build", seconds=time.perf_counter() - t0,
          libraries=",".join(p.name for p in built.values()))

    kernels = [k for name in (only or checks) for k in checks[name]()]
    torch.cuda.empty_cache()
    if only:
        # a partial run: the named kernel sources' phases, no main paths
        print(json.dumps({"kernels": kernels}))
        return 0

    main = main_path(retriever, astore, RetrievalService, cfg, dev)
    serve_launches = main["launches"]
    fused_launches = fused_path(RetrievalService, cfg, dev, main)
    sharded_path(RetrievalService, cfg, dev, main)
    probe_launches = probe_path(RetrievalService, cfg, dev, main)[False]
    svc = main["svc"]
    del main
    torch.cuda.empty_cache()
    train_launches, params, index, stream = train_path(ops, cfg, dev)
    serve_trained(svc, params, index, cfg)
    quality_path(cfg, dev, params, index, stream)
    del svc, params, index, stream
    torch.cuda.empty_cache()
    small_reference(retriever, astore, RetrievalService, smoke, dev)
    small_train_reference(smoke, dev)
    recsys_launches = recsys_path(ops, ref, dev)
    two_tower_path(ops, dev)
    din_bst_path(ops, dev)
    recsys_small_reference(dev)
    lm_launches = lm_prefill_path(ops, dev)
    lm_generate_path(dev)
    lm_vs_plain_path(ops, ref, dev)
    lm_small_reference(ops, dev)

    # launches on the path that runs each kernel: the unfused serve path,
    # the fused serve path, the train path; merge_serve_ds has no path
    path_of = {"cluster_rank": ("serve batch", serve_launches, N_BATCHES),
               "merge_serve": ("serve batch", serve_launches, N_BATCHES),
               "fused_gather_rank": ("fused serve batch", fused_launches,
                                     N_BATCHES),
               "merge_serve_ds": ("none: no path of the port or of the "
                                  "reference runs it", None, 1),
               "topk_dot": ("probed serve batch", probe_launches,
                            N_BATCHES),
               "embedding_bag": ("DLRM-RM2 forward", recsys_launches,
                                 N_BATCHES),
               "flash_attention": ("Qwen3-0.6B prefill of 32,768 tokens",
                                   lm_launches, 1)}
    for k in kernels:
        per, launches, units = path_of.get(
            k["name"], ("train step", train_launches, TRAIN_STEPS))
        k["launches"] = launches[k["name"]] if launches else 0
        k["launches_per"] = per
        k["launches_per_unit"] = k["launches"] / units
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
    sys.exit(main(sys.argv[1:]))
