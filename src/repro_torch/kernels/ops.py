"""Wrappers of the hand-written CUDA kernels.

The device decides: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor goes to the kernel's plain version in ``ref.py``.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.merge_sort import n_pops
from repro_torch.kernels import build, ref

LAUNCHES = {"cluster_rank": 0, "merge_serve": 0, "vq_assign": 0,
            "inbatch_softmax": 0, "inbatch_softmax_bwd": 0,
            "ema_segment_sum": 0}

# dynamic shared memory a block may take on Hopper (sm_90), less each
# kernel's static shared memory
_MAX_DYN_SMEM = {"cluster_rank": 232_448 - 4_096,
                 "merge_serve": 232_448 - 16_384,
                 "vq_assign": 232_448, "inbatch_softmax": 232_448,
                 "ema_segment_sum": 232_448}


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
    scores = torch.empty((b, k), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        code = lib.cluster_rank_launch(u.data_ptr(), e.data_ptr(),
                                       scores.data_ptr(), vals.data_ptr(),
                                       idx.data_ptr(), b, k, d, n,
                                       _stream(u.device))
    _raise_on_error(code, "cluster_rank")
    LAUNCHES["cluster_rank"] += 1
    return vals, idx


def merge_serve(cluster_scores: torch.Tensor, bias_lists: torch.Tensor,
                lengths: torch.Tensor, chunk: int, target: int,
                exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Alg. 1: (B,C) fp32, (B,C,L) fp32, (B,C) int32 ->
    ((B,target) int32 positions c*L+i, (B,target) fp32 scores), padded
    with (-1, NEG); bitwise equal to the plain version."""
    if _on_cpu(cluster_scores, bias_lists, lengths):
        return ref.merge_serve_ref(cluster_scores, bias_lists, lengths,
                                   chunk, target, exact)
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
        raise ValueError(f"merge_serve takes 1 <= C <= 1024, L >= 1, "
                         f"chunk >= 1, target >= 1; got C={c}, L={l}, "
                         f"chunk={chunk}, target={target}")
    pos = torch.empty((b, target), dtype=torch.int32,
                      device=cluster_scores.device)
    sc = torch.empty((b, target), dtype=torch.float32,
                     device=cluster_scores.device)
    if b == 0:
        return pos, sc
    lib = build.load("merge_serve")
    steps = n_pops(c, chunk, target, exact)
    _check_smem("merge_serve", lib.merge_serve_smem_bytes(target, steps),
                f"target={target}, {steps} pops")
    dev = cluster_scores.device
    with torch.cuda.device(dev):
        code = lib.merge_serve_launch(
            cluster_scores.data_ptr(), bias_lists.data_ptr(),
            lengths.data_ptr(), pos.data_ptr(), sc.data_ptr(),
            b, c, l, chunk, target, steps, _stream(dev))
    _raise_on_error(code, "merge_serve")
    LAUNCHES["merge_serve"] += 1
    return pos, sc


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


def inbatch_softmax_stats(u: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, log_q: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-row in-batch CE over z = u v^T + bias - logQ: u, v (B, d),
    bias, log_q (B,) fp32 -> (loss, m, l), each (B,); lse = m + log l."""
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
        with torch.cuda.device(u.device):
            code = lib.inbatch_softmax_bwd_launch(
                u.data_ptr(), v.data_ptr(), bias.data_ptr(),
                log_q.data_ptr(), lse.data_ptr(), g.data_ptr(),
                du_acc.data_ptr(), dv_acc.data_ptr(), db_acc.data_ptr(),
                b, d, _stream(u.device))
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
