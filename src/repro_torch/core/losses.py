"""Training losses of the streaming VQ retriever.

L_aux (Eq. 1): in-batch softmax on the intermediate embeddings u, v.
L_ind (Eq. 4): in-batch softmax on u and the straight-through quantized
item embedding, so items receive the cluster's gradient.  Both carry the
Eq. 11 item bias and the logQ sampled-softmax correction of Yi et al.
(logits_r - log p_r).  Both go through the in-batch softmax kernels: the
forward and its backward never hold the (B, B) logits on the card.

L_sim (Eq. 6) is kept only for the §3.2 reparability ablation.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops

_DENSE = ("the dense in-batch logits path (logits_dtype='bfloat16' or "
          "temperature != 1) is not ported yet: ROADMAP.md item A15")


def _masked_mean(losses: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is not None:
        losses = torch.where(valid, losses, torch.zeros_like(losses))
        return torch.sum(losses) / torch.clamp(
            torch.sum(valid.to(losses.dtype)), min=1.0)
    return torch.mean(losses)


class _CERows(torch.autograd.Function):
    """Per-row in-batch CE through the kernels (the reference's
    ``_ce_rows_kernel`` custom_vjp): the forward saves lse = m + log(l),
    the backward recomputes p tile by tile from it."""

    @staticmethod
    def forward(ctx, u, item_emb, bias, log_q):
        loss, m, l = kops.inbatch_softmax_stats(u, item_emb, bias, log_q)
        ctx.save_for_backward(u, item_emb, bias, log_q, m + torch.log(l))
        return loss

    @staticmethod
    def backward(ctx, g):
        u, item_emb, bias, log_q, lse = ctx.saved_tensors
        du, dv, dbias, dlogq = kops.inbatch_softmax_bwd(
            u, item_emb, bias, log_q, lse, g.contiguous())
        return (du.to(u.dtype), dv.to(item_emb.dtype), dbias.to(bias.dtype),
                dlogq.to(log_q.dtype))


def _ce_rows(u: torch.Tensor, item_emb: torch.Tensor, bias: torch.Tensor,
             log_q: torch.Tensor) -> torch.Tensor:
    """(B,) per-row -log softmax(z)[o, o], z = u item^T + bias - logQ."""
    return _CERows.apply(u.contiguous(), item_emb.contiguous(),
                         bias.contiguous(), log_q.contiguous())


def _inbatch_ce(u, item_emb, bias, log_q, valid, temperature,
                dtype) -> torch.Tensor:
    if dtype is not None or temperature != 1.0:
        raise NotImplementedError(_DENSE)
    lq = log_q if log_q is not None else torch.zeros_like(bias)
    return _masked_mean(_ce_rows(u, item_emb, bias, lq), valid)


def build_logits(u: torch.Tensor, item_emb: torch.Tensor,
                 item_bias: torch.Tensor,
                 log_q: Optional[torch.Tensor] = None,
                 temperature: float = 1.0, dtype=None) -> torch.Tensor:
    """The dense (B, B) in-batch logits u_o . item_r + bias_r - logQ_r
    (Eq. 1/4 + Eq. 11), for metrics such as two-tower's in-batch
    accuracy; the losses never build them."""
    if dtype is not None or temperature != 1.0:
        raise NotImplementedError(_DENSE)
    logits = u @ item_emb.T + item_bias.to(u.dtype)[None, :]
    if log_q is not None:
        logits = logits - log_q.to(u.dtype)[None, :]
    return logits


def l_aux(u: torch.Tensor, v_emb: torch.Tensor, v_bias: torch.Tensor,
          log_q: Optional[torch.Tensor] = None,
          valid: Optional[torch.Tensor] = None,
          temperature: float = 1.0, dtype=None) -> torch.Tensor:
    """Eq. 1: -log exp(u_o.v_o) / sum_r exp(u_o.v_r), debiased."""
    return _inbatch_ce(u, v_emb, v_bias, log_q, valid, temperature, dtype)


def l_ind(u: torch.Tensor, v_emb: torch.Tensor, e_quantized: torch.Tensor,
          v_bias: torch.Tensor, log_q: Optional[torch.Tensor] = None,
          valid: Optional[torch.Tensor] = None,
          temperature: float = 1.0, dtype=None) -> torch.Tensor:
    """Eq. 4 on the straight-through quantized embeddings
    ``e_quantized = v + sg(e - v)`` (vq.quantize)."""
    del v_emb  # the straight-through composition happened in vq.quantize
    return _inbatch_ce(u, e_quantized, v_bias, log_q, valid, temperature,
                       dtype)


def l_sim(v_emb: torch.Tensor, e: torch.Tensor,
          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 6 (ablation only): ||v - sg(e)||^2 commitment term."""
    d = torch.sum((v_emb - e.detach()) ** 2, dim=-1)
    return _masked_mean(d, valid)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy on logits, for the ranking-step heads."""
    ls = (torch.clamp(logits, min=0) - logits * labels
          + torch.log1p(torch.exp(-torch.abs(logits))))
    return _masked_mean(ls, valid)
