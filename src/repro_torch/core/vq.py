"""Streaming vector quantization: codebook state, assignment, EMA updates.

The paper's Eq. 2-3 (quantization), Eq. 7-9 (popularity-weighted EMA
with counters), Eq. 10 (disturbance-balanced assignment) and the
multi-task reward weighting of Eq. 12-13.

The codebook is the pair (w, c): ``w`` the EMA numerator, ``c`` the
EMA'd counter, and the served embedding is ``e = w / c`` (Eq. 9).
Cluster embeddings get no gradient: they move only by EMA; items get the
cluster's gradient through the straight-through ``quantize``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import ops as kops


class VQState(NamedTuple):
    w: torch.Tensor          # (K, d) EMA numerator
    c: torch.Tensor          # (K,)  EMA counter

    @property
    def n_clusters(self) -> int:
        return self.w.shape[0]

    @property
    def dim(self) -> int:
        return self.w.shape[1]

    def embeddings(self) -> torch.Tensor:
        """Eq. 9: e_k = w_k / c_k."""
        return self.w / torch.clamp(self.c, min=1e-6)[:, None]


def init_vq(gen: torch.Generator, n_clusters: int, dim: int) -> VQState:
    w = torch.randn((n_clusters, dim), generator=gen, device=gen.device) * 0.1
    c = torch.ones((n_clusters,), device=gen.device)
    return VQState(w=w, c=c)


def disturbance(c: torch.Tensor, s: float) -> torch.Tensor:
    """Eq. 10 discount r_k = min(c_k / (mean c) * s, 1)."""
    mean_c = torch.mean(c)
    return torch.clamp(c / torch.clamp(mean_c, min=1e-6) * s, max=1.0)


def assign(vq: VQState, v: torch.Tensor, s: float = 5.0) -> torch.Tensor:
    """Eq. 10: k* = argmin_k max(||v||^2 - 2 v.e_k + ||e_k||^2, 0) * r_k,
    first minimum; the ``vq_assign`` kernel on a CUDA tensor."""
    e = vq.embeddings().to(torch.float32).contiguous()
    r = disturbance(vq.c, s).to(torch.float32).contiguous()
    return kops.vq_assign(v.to(torch.float32).contiguous(), e, r)


def ema_update(vq: VQState, v: torch.Tensor, assignment: torch.Tensor,
               weight: torch.Tensor, alpha: float) -> VQState:
    """Batched Eq. 7-8 / Eq. 12-13 (``weight`` carries the rewards):

        w_k <- alpha*w_k + (1-alpha)*sum_{j->k} weight_j*v_j
        c_k <- alpha*c_k + (1-alpha)*sum_{j->k} weight_j

    The sums are the ``ema_segment_sum`` kernel on a CUDA tensor; rows
    assigned outside [0, K) add nothing.
    """
    w_add, c_add = kops.ema_segment_sum(
        v.to(torch.float32).contiguous(),
        assignment.to(torch.int32).contiguous(),
        weight.to(torch.float32).contiguous(), vq.n_clusters)
    w = alpha * vq.w + (1.0 - alpha) * w_add
    c = alpha * vq.c + (1.0 - alpha) * c_add.to(vq.c.dtype)
    return VQState(w=w, c=c)


def popularity_weight(delta: torch.Tensor, beta: float,
                      rewards: Optional[torch.Tensor] = None,
                      eta: Optional[Sequence[float]] = None,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(delta^beta) * prod_p (1 + h_jp)^eta_p   (Eq. 7 / Eq. 12 weights).

    rewards: (B, P) per-task rewards (None for single task); valid: (B,)
    mask, invalid rows weigh zero.
    """
    w = torch.pow(torch.clamp(delta, min=1e-6), beta)
    if rewards is not None:
        if eta is None or len(eta) != rewards.shape[-1]:
            raise ValueError("eta must give one exponent per reward column")
        eta_t = torch.as_tensor(eta, dtype=w.dtype, device=w.device)
        w = w * torch.prod(torch.pow(1.0 + rewards, eta_t[None, :]), dim=-1)
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
    return w


def quantize(vq: VQState, v: torch.Tensor,
             assignment: torch.Tensor) -> torch.Tensor:
    """Eq. 3 with straight-through: v + sg(Q(v) - v), so the cluster's
    gradient flows to the item embedding."""
    e = vq.embeddings()[assignment.long()].to(v.dtype)
    return v + (e - v).detach()


def cluster_usage_stats(vq: VQState, assignment: torch.Tensor) -> dict:
    """Balance diagnostics (Fig. 4): used clusters, largest cluster,
    usage entropy and perplexity of one batch's assignment."""
    k = vq.n_clusters
    counts = torch.bincount(assignment.long(), minlength=k).to(torch.float32)
    p = counts / torch.clamp(torch.sum(counts), min=1.0)
    entropy = -torch.sum(torch.where(p > 0, p * torch.log(p),
                                     torch.zeros_like(p)))
    return dict(used_clusters=torch.sum(counts > 0),
                max_cluster=torch.max(counts),
                usage_entropy=entropy,
                perplexity=torch.exp(entropy))
