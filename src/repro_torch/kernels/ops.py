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

LAUNCHES = {"cluster_rank": 0, "merge_serve": 0}

# dynamic shared memory a block may take on Hopper (sm_90), less each
# kernel's static shared memory
_MAX_DYN_SMEM = {"cluster_rank": 232_448 - 4_096,
                 "merge_serve": 232_448 - 16_384}


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
    smem = lib.cluster_rank_smem_bytes(k, n)
    if smem > _MAX_DYN_SMEM["cluster_rank"]:
        raise ValueError(f"cluster_rank needs {smem} bytes of shared memory "
                         f"for K={k}, n={n}; at most "
                         f"{_MAX_DYN_SMEM['cluster_rank']}")
    scores = torch.empty((b, k), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.cluster_rank_launch(u.data_ptr(), e.data_ptr(),
                                       scores.data_ptr(), vals.data_ptr(),
                                       idx.data_ptr(), b, k, d, n, stream)
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
    smem = lib.merge_serve_smem_bytes(target, steps)
    if smem > _MAX_DYN_SMEM["merge_serve"]:
        raise ValueError(f"merge_serve needs {smem} bytes of shared memory "
                         f"for target={target}, {steps} pops; at most "
                         f"{_MAX_DYN_SMEM['merge_serve']}")
    dev = cluster_scores.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.merge_serve_launch(
            cluster_scores.data_ptr(), bias_lists.data_ptr(),
            lengths.data_ptr(), pos.data_ptr(), sc.data_ptr(),
            b, c, l, chunk, target, steps, stream)
    _raise_on_error(code, "merge_serve")
    LAUNCHES["merge_serve"] += 1
    return pos, sc
