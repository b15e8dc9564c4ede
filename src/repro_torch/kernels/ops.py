"""Wrappers of the hand-written CUDA kernels.

The device decides: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor goes to the kernel's plain version in ``ref.py``.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.merge_sort import n_pops
from repro_torch.kernels import build, ref

LAUNCHES = {"cluster_rank": 0, "merge_serve": 0, "merge_serve_ds": 0,
            "fused_gather_rank": 0, "vq_assign": 0, "inbatch_softmax": 0,
            "inbatch_softmax_bwd": 0, "ema_segment_sum": 0, "topk_dot": 0,
            "embedding_bag": 0, "flash_attention": 0}

# dynamic shared memory a block may take on Hopper (sm_90), less each
# kernel's static shared memory
_MAX_DYN_SMEM = {"cluster_rank": 232_448 - 4_096,
                 "merge_serve": 232_448 - 16_384,
                 "merge_serve_ds": 232_448 - 16_384,
                 "fused_gather_rank": 232_448 - 16_384,
                 "vq_assign": 232_448, "inbatch_softmax": 232_448,
                 "ema_segment_sum": 232_448, "topk_dot": 232_448,
                 "embedding_bag": 232_448, "flash_attention": 232_448}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device, got {[str(t.device) for t in ts]}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{code}")


def _check_smem(name: str, smem: int, what: str) -> None:
    if smem > _MAX_DYN_SMEM[name]:
        raise ValueError(f"{name} needs {smem} bytes of shared memory for "
                         f"{what}; at most {_MAX_DYN_SMEM[name]}")


def _check_rows(name: str, t: torch.Tensor, n: int) -> None:
    if t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def cluster_rank(u: torch.Tensor, e: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, d), e: (K, d) fp32 -> (top-n scores (B, n), ids (B, n) int32),
    by descending score, ties to the lower cluster id."""
    if _on_cpu(u, e):
        return ref.cluster_rank_ref(u, e, n)
    _check(u, "u", torch.float32, 2)
    _check(e, "e", torch.float32, 2)
    b, d = u.shape
    k = e.shape[0]
    if e.shape[1] != d:
        raise ValueError(f"u has width {d}, e has width {e.shape[1]}")
    if not 0 < n <= k:
        raise ValueError(f"top-n {n} must lie in [1, codebook size {k}]")
    vals = torch.empty((b, n), dtype=torch.float32, device=u.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=u.device)
    if b == 0:
        return vals, idx
    lib = build.load("cluster_rank")
    _check_smem("cluster_rank", lib.cluster_rank_smem_bytes(k, n),
                f"K={k}, n={n}")
    # scratch: the (B, K) scores and each query's segment maxima
    scores = torch.empty((b, k), dtype=torch.float32, device=u.device)
    segmax = torch.empty((b, lib.cluster_rank_segments(k)),
                         dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        code = lib.cluster_rank_launch(u.data_ptr(), e.data_ptr(),
                                       scores.data_ptr(), segmax.data_ptr(),
                                       vals.data_ptr(), idx.data_ptr(), b, k,
                                       d, n, _stream(u.device))
    _raise_on_error(code, "cluster_rank")
    LAUNCHES["cluster_rank"] += 1
    return vals, idx


def _merge_serve(name: str, cluster_scores: torch.Tensor,
                 bias_lists: torch.Tensor, lengths: torch.Tensor, chunk: int,
                 target: int, exact: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``name`` (``merge_serve`` or ``merge_serve_ds``: one body,
    two launches) on CUDA tensors."""
    _check(cluster_scores, "cluster_scores", torch.float32, 2)
    _check(bias_lists, "bias_lists", torch.float32, 3)
    _check(lengths, "lengths", torch.int32, 2)
    b, c = cluster_scores.shape
    l = bias_lists.shape[2]
    if bias_lists.shape[:2] != (b, c) or lengths.shape != (b, c):
        raise ValueError(f"shapes disagree: cluster_scores {(b, c)}, "
                         f"bias_lists {tuple(bias_lists.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if not 1 <= c <= 1024 or l < 1 or chunk < 1 or target < 1:
        raise ValueError(f"{name} takes 1 <= C <= 1024, L >= 1, chunk >= 1, "
                         f"target >= 1; got C={c}, L={l}, chunk={chunk}, "
                         f"target={target}")
    dev = cluster_scores.device
    pos = torch.empty((b, target), dtype=torch.int32, device=dev)
    sc = torch.empty((b, target), dtype=torch.float32, device=dev)
    if b == 0:
        return pos, sc
    lib = build.load("merge_serve")
    steps = n_pops(c, chunk, target, exact)
    _check_smem(name, getattr(lib, f"{name}_smem_bytes")(target, steps),
                f"target={target}, {steps} pops")
    with torch.cuda.device(dev):
        code = getattr(lib, f"{name}_launch")(
            cluster_scores.data_ptr(), bias_lists.data_ptr(),
            lengths.data_ptr(), pos.data_ptr(), sc.data_ptr(),
            b, c, l, chunk, target, steps, _stream(dev))
    _raise_on_error(code, name)
    LAUNCHES[name] += 1
    return pos, sc


def merge_serve(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                lengths: torch.Tensor, chunk: int, target: int,
                exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Alg. 1: (B,C) fp32, (B,C,L) fp32, (B,C) int32 ->
    ((B,target) int32 positions c*L+i, (B,target) fp32 scores), padded
    with (-1, NEG); bitwise equal to the plain version."""
    if _on_cpu(cluster_scores, bias_lists, lengths):
        return ref.merge_serve_ref(cluster_scores, bias_lists, lengths,
                                   chunk, target, exact)
    return _merge_serve("merge_serve", cluster_scores, bias_lists, lengths,
                        chunk, target, exact)


def merge_serve_ds(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                   lengths: torch.Tensor, chunk: int, target: int,
                   exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dynamic-slice variant of ``merge_serve``: the same
    arguments (any L >= 1, also L < chunk) and the same bits."""
    if _on_cpu(cluster_scores, bias_lists, lengths):
        return ref.merge_serve_ds_ref(cluster_scores, bias_lists, lengths,
                                      chunk, target, exact)
    return _merge_serve("merge_serve_ds", cluster_scores, bias_lists,
                        lengths, chunk, target, exact)


def fused_gather_rank(u: torch.Tensor, cluster_scores: torch.Tensor,
                      starts: torch.Tensor, lengths: torch.Tensor,
                      limits: torch.Tensor, bias_flat: torch.Tensor,
                      ids_flat: torch.Tensor, emb_flat: torch.Tensor,
                      chunk: int, target: int, l: int, exact: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Fused Alg. 1 merge + candidate gather + Eq. 11 score: u (B,d) fp32;
    cluster_scores (B,C) fp32; starts, lengths, limits (B,C) int32; the
    flat index bias_flat (N,) fp32, ids_flat (N,) int32, emb_flat (N,d)
    fp32 -> (pos (B,target) int32 c*l+i, merge_scores fp32, cand_ids
    int32, exact_scores fp32).  pos, merge_scores and cand_ids are bitwise
    the plain version's; exact_scores is u.emb + bias summed in another
    order.  Addresses min(start + i, limit) must lie in [0, N)."""
    ts = (u, cluster_scores, starts, lengths, limits, bias_flat, ids_flat,
          emb_flat)
    if _on_cpu(*ts):
        return ref.fused_gather_rank_ref(*ts, chunk, target, l, exact)
    _check(u, "u", torch.float32, 2)
    _check(cluster_scores, "cluster_scores", torch.float32, 2)
    for name, t in (("starts", starts), ("lengths", lengths),
                    ("limits", limits)):
        _check(t, name, torch.int32, 2)
    _check(bias_flat, "bias_flat", torch.float32, 1)
    _check(ids_flat, "ids_flat", torch.int32, 1)
    _check(emb_flat, "emb_flat", torch.float32, 2)
    b, c = cluster_scores.shape
    n, d = emb_flat.shape
    if (u.shape != (b, d) or starts.shape != (b, c)
            or lengths.shape != (b, c) or limits.shape != (b, c)
            or bias_flat.shape != (n,) or ids_flat.shape != (n,)):
        raise ValueError(
            f"shapes disagree: u {tuple(u.shape)}, cluster_scores {(b, c)}, "
            f"starts {tuple(starts.shape)}, lengths {tuple(lengths.shape)}, "
            f"limits {tuple(limits.shape)}, bias_flat "
            f"{tuple(bias_flat.shape)}, ids_flat {tuple(ids_flat.shape)}, "
            f"emb_flat {(n, d)}")
    if (not 1 <= c <= 1024 or not 1 <= n < 2 ** 31 or d < 1 or l < 1
            or chunk < 1 or target < 1):
        raise ValueError(f"fused_gather_rank takes 1 <= C <= 1024, "
                         f"1 <= N < 2**31, d, l, chunk, target >= 1; got "
                         f"C={c}, N={n}, d={d}, l={l}, chunk={chunk}, "
                         f"target={target}")
    dev = u.device
    pos = torch.empty((b, target), dtype=torch.int32, device=dev)
    sc = torch.empty((b, target), dtype=torch.float32, device=dev)
    ids = torch.empty((b, target), dtype=torch.int32, device=dev)
    rk = torch.empty((b, target), dtype=torch.float32, device=dev)
    if b == 0:
        return pos, sc, ids, rk
    lib = build.load("fused_gather_rank")
    steps = n_pops(c, chunk, target, exact)
    _check_smem("fused_gather_rank",
                lib.fused_gather_rank_smem_bytes(target, steps, d),
                f"target={target}, {steps} pops, d={d}")
    with torch.cuda.device(dev):
        code = lib.fused_gather_rank_launch(
            *(t.data_ptr() for t in ts), pos.data_ptr(), sc.data_ptr(),
            ids.data_ptr(), rk.data_ptr(), b, c, l, d, n, chunk, target,
            steps, _stream(dev))
    _raise_on_error(code, "fused_gather_rank")
    LAUNCHES["fused_gather_rank"] += 1
    return pos, sc, ids, rk


def vq_assign(v: torch.Tensor, e: torch.Tensor, r: torch.Tensor
              ) -> torch.Tensor:
    """Eq. 10: v (B, d), e (K, d), r (K,) fp32 -> (B,) int32 ids of
    argmin_k max(||v||^2 - 2 v.e_k + ||e_k||^2, 0) * r_k, first minimum."""
    if _on_cpu(v, e, r):
        return ref.vq_assign_ref(v, e, r)
    _check(v, "v", torch.float32, 2)
    _check(e, "e", torch.float32, 2)
    _check(r, "r", torch.float32, 1)
    b, d = v.shape
    k = e.shape[0]
    if e.shape[1] != d:
        raise ValueError(f"v has width {d}, e has width {e.shape[1]}")
    _check_rows("r", r, k)
    if k < 1 or d < 1:
        raise ValueError(f"vq_assign needs K >= 1 and d >= 1, got K={k}, "
                         f"d={d}")
    out = torch.empty((b,), dtype=torch.int32, device=v.device)
    if b == 0:
        return out
    lib = build.load("vq_assign")
    _check_smem("vq_assign", lib.vq_assign_smem_bytes(d), f"d={d}")
    with torch.cuda.device(v.device):
        code = lib.vq_assign_launch(v.data_ptr(), e.data_ptr(), r.data_ptr(),
                                    out.data_ptr(), b, k, d,
                                    _stream(v.device))
    _raise_on_error(code, "vq_assign")
    LAUNCHES["vq_assign"] += 1
    return out


def _check_inbatch(lib, u, v, vecs) -> Tuple[int, int]:
    _check(u, "u", torch.float32, 2)
    _check(v, "v", torch.float32, 2)
    b, d = u.shape
    if v.shape != (b, d):
        raise ValueError(f"u is {tuple(u.shape)}, v is {tuple(v.shape)}")
    for name, t in vecs.items():
        _check(t, name, torch.float32, 1)
        _check_rows(name, t, b)
    if not 1 <= d <= lib.inbatch_softmax_max_d():
        raise ValueError(f"inbatch_softmax takes 1 <= d <= "
                         f"{lib.inbatch_softmax_max_d()}, got {d}")
    _check_smem("inbatch_softmax", lib.inbatch_softmax_smem_bytes(d),
                f"d={d}")
    return b, d


def inbatch_softmax(u: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    log_q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row in-batch CE over z = u v^T + bias - logQ -> (B,) losses;
    ``log_q=None`` drops the logQ term.  One forward launch."""
    return inbatch_softmax_stats(u, v, bias, log_q)[0]


def inbatch_softmax_stats(u: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          log_q: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-row in-batch CE over z = u v^T + bias - logQ: u, v (B, d),
    bias, log_q (B,) fp32 -> (loss, m, l), each (B,); lse = m + log l.
    ``log_q=None`` means zeros."""
    if log_q is None:
        log_q = torch.zeros_like(bias)
    if _on_cpu(u, v, bias, log_q):
        return ref.inbatch_softmax_ref(u, v, bias, log_q)
    lib = build.load("inbatch_softmax")
    b, d = _check_inbatch(lib, u, v, dict(bias=bias, log_q=log_q))
    loss, m, l = (torch.empty((b,), dtype=torch.float32, device=u.device)
                  for _ in range(3))
    if b == 0:
        return loss, m, l
    with torch.cuda.device(u.device):
        code = lib.inbatch_softmax_fwd_launch(
            u.data_ptr(), v.data_ptr(), bias.data_ptr(), log_q.data_ptr(),
            loss.data_ptr(), m.data_ptr(), l.data_ptr(), b, d,
            _stream(u.device))
    _raise_on_error(code, "inbatch_softmax")
    LAUNCHES["inbatch_softmax"] += 1
    return loss, m, l


def inbatch_softmax_bwd(u: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        log_q: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """VJP of the per-row in-batch CE from the saved lse and the per-row
    cotangent g -> (du, dv, dbias, dlogq) in fp32.  The kernels give the
    sums over the batch; the rank-one terms -g v, -g u and -g are added
    here, as the reference's wrapper adds them."""
    if _on_cpu(u, v, bias, log_q, lse, g):
        return ref.inbatch_softmax_bwd_ref(u, v, bias, log_q, lse, g)
    lib = build.load("inbatch_softmax")
    b, d = _check_inbatch(lib, u, v, dict(bias=bias, log_q=log_q, lse=lse,
                                          g=g))
    du_acc = torch.empty((b, d), dtype=torch.float32, device=u.device)
    dv_acc = torch.empty((b, d), dtype=torch.float32, device=u.device)
    db_acc = torch.empty((b,), dtype=torch.float32, device=u.device)
    if b > 0:
        # scratch: u and v split into tf32 (hi, lo) pairs, padded
        scratch = torch.empty(
            (lib.inbatch_softmax_bwd_scratch_floats(b, d),),
            dtype=torch.float32, device=u.device)
        with torch.cuda.device(u.device):
            code = lib.inbatch_softmax_bwd_launch(
                u.data_ptr(), v.data_ptr(), bias.data_ptr(),
                log_q.data_ptr(), lse.data_ptr(), g.data_ptr(),
                scratch.data_ptr(), du_acc.data_ptr(), dv_acc.data_ptr(),
                db_acc.data_ptr(), b, d, _stream(u.device))
        _raise_on_error(code, "inbatch_softmax_bwd")
        LAUNCHES["inbatch_softmax_bwd"] += 1
    du = g[:, None] * (du_acc - v)        # p minus the identity
    dv = dv_acc - g[:, None] * u
    dbias = db_acc - g
    return du, dv, dbias, -dbias


def ema_segment_sum_slices() -> int:
    """The number of row slices whose sums the card's ``ema_segment_sum``
    takes apart and adds in slice order (builds the kernel)."""
    return build.load("ema_segment_sum").ema_segment_sum_slices()


def ema_segment_sum(v: torch.Tensor, assignment: torch.Tensor,
                    weight: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7-8 batch sums: v (B, d) fp32, assignment (B,) int32, weight
    (B,) fp32 -> (w_add (K, d), c_add (K,)); rows assigned outside
    [0, K) add nothing.  Deterministic: no float atomics."""
    if _on_cpu(v, assignment, weight):
        return ref.ema_segment_sum_ref(v, assignment, weight, k)
    _check(v, "v", torch.float32, 2)
    _check(assignment, "assignment", torch.int32, 1)
    _check(weight, "weight", torch.float32, 1)
    b, d = v.shape
    _check_rows("assignment", assignment, b)
    _check_rows("weight", weight, b)
    if k < 1 or d < 1:
        raise ValueError(f"ema_segment_sum needs K >= 1 and d >= 1, got "
                         f"K={k}, d={d}")
    lib = build.load("ema_segment_sum")
    _check_smem("ema_segment_sum", lib.ema_segment_sum_smem_bytes(d),
                f"d={d}")
    w_add = torch.empty((k, d), dtype=torch.float32, device=v.device)
    c_add = torch.empty((k,), dtype=torch.float32, device=v.device)
    # per-slice partial sums, added in slice order by the second kernel
    n_slices = lib.ema_segment_sum_slices()
    w_part = torch.empty((n_slices, k, d), dtype=torch.float32,
                         device=v.device)
    c_part = torch.empty((n_slices, k), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        code = lib.ema_segment_sum_launch(
            v.data_ptr(), assignment.data_ptr(), weight.data_ptr(),
            w_part.data_ptr(), c_part.data_ptr(), w_add.data_ptr(),
            c_add.data_ptr(), b, k, d, _stream(v.device))
    _raise_on_error(code, "ema_segment_sum")
    LAUNCHES["ema_segment_sum"] += 1
    return w_add, c_add


_TOPK_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TOPK_TILE = 64      # items per sub-tile of the kernel (csrc/topk_dot.cu)


def _f32_input(t: torch.Tensor, name: str, ndim: int) -> torch.Tensor:
    """fp32, bf16 or fp16 -> contiguous fp32 (the upcast is exact)."""
    if t.dtype not in _TOPK_DTYPES:
        raise TypeError(f"{name} must be float32, bfloat16 or float16, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    return t.to(torch.float32).contiguous()


def _topk_chunk(dev: torch.device, n_query_tiles: int, n: int, k: int
                ) -> int:
    """Items per block: about 4 blocks an SM over the whole grid, at least
    4k items and 1,024 (so the partials stay few), a multiple of the
    sub-tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_chunks = max(1, 4 * sms // n_query_tiles)
    chunk = max(-(-n // n_chunks), 4 * k, 1024)
    return -(-chunk // _TOPK_TILE) * _TOPK_TILE


def _merge_partials(part_val: torch.Tensor, part_key: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: the top-k of each row of partials (B, P) by (score desc,
    index asc): one sort of the kernel's unique int64 keys, whose low 31
    bits are the index."""
    order = torch.sort(part_key, dim=1).indices[:, :k]
    idx = torch.gather(part_key, 1, order) & 0x7FFFFFFF
    return torch.gather(part_val, 1, order), idx.to(torch.int32)


def topk_dot(u: torch.Tensor, items: torch.Tensor, bias: torch.Tensor,
             k: int, block_n: Optional[int] = 4096
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores = items @ u + bias in fp32 -> (top-k values fp32, indices
    int32), descending, ties to the lower index.  u: (d,) -> (k,) each,
    as the reference's ``ops.topk_dot``; u: (B, d) -> (B, k), the batched
    oracle of ``baselines.brute_force.mips_topk``.  items (N, d), bias
    (N,); fp32, bf16 or fp16 (upcast to fp32).  ``block_n`` is the items
    one block of the kernel takes (rounded up to a multiple of 64;
    ``None`` picks one that fills the card); the result does not depend
    on it."""
    if _on_cpu(u, items, bias):
        return ref.topk_dot_ref(u, items, bias, k)
    one = u.dim() == 1
    u2 = _f32_input(u.reshape(1, -1) if one else u, "u", 2)
    items = _f32_input(items, "items", 2)
    bias = _f32_input(bias, "bias", 1)
    b, d = u2.shape
    n = items.shape[0]
    if items.shape[1] != d:
        raise ValueError(f"u has width {d}, items have width "
                         f"{items.shape[1]}")
    _check_rows("bias", bias, n)
    if not 1 <= n < 2 ** 31 or d < 1:
        raise ValueError(f"topk_dot takes 1 <= N < 2**31 and d >= 1; got "
                         f"N={n}, d={d}")
    if not 0 < k <= n:
        raise ValueError(f"top-k {k} must lie in [1, N={n}]")
    if block_n is not None and block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    dev = u2.device
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    lib = build.load("topk_dot")
    # 64 queries a block (4 rows a thread) for batches, 16 for a few
    # queries or where a 64-row block's running top-k does not fit
    rpt = 4 if b > 16 else 1
    if lib.topk_dot_smem_bytes(rpt, b, d, k) > _MAX_DYN_SMEM["topk_dot"]:
        rpt = 1
    _check_smem("topk_dot", lib.topk_dot_smem_bytes(rpt, b, d, k),
                f"d={d}, k={k}")
    tb = 16 * rpt
    n_qt = -(-b // tb)
    chunk = (_topk_chunk(dev, n_qt, n, k) if block_n is None
             else -(-block_n // _TOPK_TILE) * _TOPK_TILE)
    n_chunks = -(-n // chunk)
    if n_chunks > 65_535:
        raise ValueError(f"block_n={block_n} cuts N={n} into {n_chunks} "
                         f"blocks; at most 65,535")
    part_val = torch.empty((b, n_chunks * k), dtype=torch.float32,
                           device=dev)
    part_key = torch.empty((b, n_chunks * k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = lib.topk_dot_launch(u2.data_ptr(), items.data_ptr(),
                                   bias.data_ptr(), part_val.data_ptr(),
                                   part_key.data_ptr(), b, n, d, k, chunk,
                                   n_chunks, rpt, _stream(dev))
    _raise_on_error(code, "topk_dot")
    LAUNCHES["topk_dot"] += 1
    vals, idx = _merge_partials(part_val, part_key, k)
    return (vals[0], idx[0]) if one else (vals, idx)


_EMBAG_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EMBAG_ID_DTYPES = {torch.int32: 0, torch.int64: 1}


def _embedding_bag_kernel(table: torch.Tensor, ids: torch.Tensor,
                          combiner: str) -> torch.Tensor:
    """Launch ``csrc/embedding_bag.cu`` on CUDA tensors (the table is read
    in place, fp32 or bf16)."""
    if table.dtype not in _EMBAG_TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if ids.dtype not in _EMBAG_ID_DTYPES:
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    for name, t in (("table", table), ("ids", ids)):
        if t.dim() != 2:
            raise ValueError(f"{name} must have 2 dims, got {t.dim()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    v, d = table.shape
    b, bag = ids.shape
    if v < 1 or d < 1 or bag < 1:
        raise ValueError(f"embedding_bag needs V, d, bag >= 1; got V={v}, "
                         f"d={d}, bag={bag}")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    # 4-element slots (16-byte fp32 / 8-byte bf16 loads) where d and the
    # table's base allow them, else one element a load
    vec = int(d % 4 == 0 and table.data_ptr() % (4 * table.element_size())
              == 0)
    lib = build.load("embedding_bag")
    _check_smem("embedding_bag",
                lib.embedding_bag_smem_bytes(d // 4 if vec else d, bag),
                f"d={d}, bag={bag}")
    with torch.cuda.device(table.device):
        code = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, v, bag, d,
            _EMBAG_TABLE_DTYPES[table.dtype], _EMBAG_ID_DTYPES[ids.dtype],
            int(combiner == "mean"), vec, _stream(table.device))
    _raise_on_error(code, "embedding_bag")
    LAUNCHES["embedding_bag"] += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    """Forward: the kernel on a CUDA table, the plain version on a CPU one.
    Backward (the reference's gradient is XLA's scatter-add, no kernel):
    the cotangent of each row, divided by bag for the mean, added into a
    zero (V, d) fp32 gradient at the row's ids with ``index_add_``.  On
    the card ``index_add_`` adds with atomics, so where an id repeats its
    gradient sums in no fixed order."""

    @staticmethod
    def forward(ctx, table, ids, combiner):
        ctx.save_for_backward(ids)
        ctx.combiner = combiner
        ctx.table_meta = (table.shape, table.dtype)
        if _on_cpu(table, ids):
            return ref.embedding_bag_ref(table, ids, combiner)
        return _embedding_bag_kernel(table, ids, combiner)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.table_meta
        bag = ids.shape[1]
        g = g.to(torch.float32)
        if ctx.combiner == "mean":
            g = g / torch.tensor(float(bag), device=g.device)
        grad = torch.zeros(shape, dtype=torch.float32, device=g.device)
        grad.index_add_(0, ids.reshape(-1).long(),
                        g.repeat_interleave(bag, dim=0))
        return grad.to(dtype), None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table (V, d) fp32 or bf16, ids (B, bag) int32 or int64 pre-hashed
    row indices in [0, V) -> (B, d) fp32 bag sums (``"sum"``) or sums
    divided by bag (``"mean"``), differentiable in the table.  On the
    card an id outside [0, V) makes its row NaN (the plain version
    raises)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner {combiner!r}")
    return _EmbeddingBag.apply(table, ids, combiner)


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention with the online softmax, the TPU kernel's function:
    logits (q . k^T) * hd^-0.5 in fp32, masked to -1e30 above the causal
    diagonal (key j > query i + T - S), softmax, times v, in q's dtype.
    q (B, S, H, hd), k and v (B, T, Hk, hd) with H % Hk == 0 (query head
    h reads kv head h // (H // Hk)); or q, k, v (S, hd), one head, as the
    reference's ``ops.flash_attention``.  fp32 or bf16, contiguous, read
    in place; 1 <= hd <= 256, any S, T >= 1 (T >= S when causal).  On the
    card bf16 runs on the tensor cores (P split into three exact bf16
    parts), fp32 in the fp32 pipes.  No gradient: on the card an input
    that requires one raises."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet: ROADMAP.md item "
            "A22 (LM training at full width)")
    if q.dim() == 2:
        return flash_attention(q[None, :, None], k[None, :, None],
                               v[None, :, None], causal)[0, :, 0]
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.dtype, 4)
    b, s, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    if k.shape != (b, t, hk, hd) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    lib = build.load("flash_attention")
    if (s < 1 or t < 1 or hk < 1 or h % hk != 0
            or not 1 <= hd <= lib.flash_attention_max_hd()
            or (causal and t < s) or b * h > 65_535):
        raise ValueError(f"flash_attention takes S, T >= 1, H % Hk == 0, "
                         f"1 <= hd <= {lib.flash_attention_max_hd()}, "
                         f"B * H <= 65,535 and T >= S when causal; got "
                         f"B={b}, S={s}, T={t}, H={h}, Hk={hk}, hd={hd}, "
                         f"causal={causal}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    bf16 = _FLASH_DTYPES[q.dtype]
    _check_smem("flash_attention", lib.flash_attention_smem_bytes(hd, bf16),
                f"hd={hd}")
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
            h, hk, hd, int(causal), hd ** -0.5, bf16, _stream(q.device))
    _raise_on_error(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
