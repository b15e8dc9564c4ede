"""DIN [arXiv:1706.06978] — Deep Interest Network.

Target attention: per history item, an attention MLP scores the
interaction [h, t, h - t, h * t] between the history embedding h and the
target embedding t; the history is pooled with the softmax of those
scores and concatenated with the user, context and target features into
the final MLP.  The archetype of the paper's "VQ Complicated" ranking
step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.losses import bce_logits
from repro_torch.models.dense import init_mlp, mlp
from repro_torch.models.recsys import embedding as emb

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: RecsysConfig, device=None
         ) -> Params:
    """Random params on ``device`` (``cuda`` unless named), drawn from
    ``gen``, which must lie there (``torch.Generator(device)``)."""
    device = emb.init_device(gen, device)
    d = cfg.embed_dim
    # user profile + attention-pooled hist (item+cate) + target + context
    d_cat = d * 6
    return {
        "tables": emb.init_tables(gen, cfg.tables),
        "attn": init_mlp(gen, 8 * d, cfg.attn_mlp + (1,)),
        "head": init_mlp(gen, d_cat, cfg.top_mlp + (1,)),
    }


def _hist_and_target(p: Params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    t = p["tables"]
    hist = torch.cat([
        emb.lookup(t["item_id"], batch["hist_items"]),
        emb.lookup(t["cate_id"], batch["hist_cates"])], -1)   # (B,S,2d)
    target = torch.cat([
        emb.lookup(t["item_id"], batch["target_item"]),
        emb.lookup(t["cate_id"], batch["target_cate"])], -1)  # (...,2d)
    user = torch.cat([
        emb.lookup(t["user_id"], batch["user_id"]),
        emb.lookup(t["context"], batch["context"])], -1)      # (B,2d)
    return hist, target, user


def attention_pool(p: Params, hist: torch.Tensor, target: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DIN local activation unit. hist (B,S,D), target (..., D) -> (..., D).

    A target (B, C, D) pools the history once per candidate through a
    (B, C, S, 4D) interaction.  Masked history positions get logit -1e30.
    """
    if target.dim() == hist.dim():                    # (B, C, D) candidates
        shape = (hist.shape[0], target.shape[1], hist.shape[1],
                 hist.shape[-1])
        h = hist[:, None].expand(shape)               # (B,C,S,D)
        tt = target[:, :, None].expand(shape)
    else:                                             # (B, D) single target
        h = hist
        tt = target[:, None, :].expand(hist.shape)
    x = torch.cat([h, tt, h - tt, h * tt], -1)
    logits = mlp(p["attn"], x, act=torch.sigmoid)[..., 0]   # (..., S)
    if mask is not None:
        while mask.dim() < logits.dim():
            mask = mask[:, None]
        logits = torch.where(mask, logits,
                             torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("...s,...sd->...d", w, h)


def forward(p: Params, cfg: RecsysConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits. target_item (B,) -> (B,); target_item (B,C) -> (B,C)."""
    hist, target, user = _hist_and_target(p, batch)
    pooled = attention_pool(p, hist, target, batch.get("hist_mask"))
    if target.dim() == 3:
        b, c = target.shape[:2]
        user = user[:, None].expand(b, c, user.shape[-1])
    x = torch.cat([user, pooled, target], -1)
    return mlp(p["head"], x)[..., 0]


def loss(p: Params, cfg: RecsysConfig, batch: Dict[str, torch.Tensor]
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(p, cfg, batch)
    l = bce_logits(logits, batch["label"].to(logits.dtype))
    return l, dict(logit_mean=torch.mean(logits))


def serve(p: Params, cfg: RecsysConfig,
          batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pointwise scoring (serve_p99 / serve_bulk cells)."""
    return torch.sigmoid(forward(p, cfg, batch))


def retrieval(p: Params, cfg: RecsysConfig,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """retrieval_cand: one user against (C,) candidate items."""
    b2 = dict(batch)
    b2["target_item"] = batch["cand_items"][None, :]      # (1, C)
    b2["target_cate"] = batch["cand_cates"][None, :]
    return forward(p, cfg, b2)[0]
