"""Retrieval ranking-step model (paper §3.5), the "VQ Two-tower" branch:
DSSM towers plus the item popularity bias.  Multi-task heads are stacked
on a leading task axis, as in the reference."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import SVQConfig
from repro_torch.models.dense import init_mlp, mlp, select, stack

Params = Dict[str, Any]

_COMPLICATED = ("ranking='complicated' is not ported yet: ROADMAP.md "
                "item A11 (the complicated ranking head)")


def init_ranking(gen: torch.Generator, cfg: SVQConfig, d_user_in: int,
                 d_item_in: int) -> Params:
    if cfg.ranking != "two_tower":
        raise NotImplementedError(_COMPLICATED)
    # item tower emits (embedding, popularity-bias): final width d+1
    item_dims = cfg.ranking_mlp[:-1] + (cfg.ranking_mlp[-1] + 1,)
    return {
        "user_mlp": stack([init_mlp(gen, d_user_in, cfg.ranking_mlp)
                           for _ in range(cfg.n_tasks)]),
        "item_mlp": stack([init_mlp(gen, d_item_in, item_dims)
                           for _ in range(cfg.n_tasks)]),
    }


def ranking_scores(p: Params, cfg: SVQConfig, user_feat: torch.Tensor,
                   item_feat: torch.Tensor) -> torch.Tensor:
    """Per-task logits.

    user_feat: (B, d_u); item_feat: (B, d_i), or (B, S, d_i) when serving.
    Returns (P, B) or (P, B, S).
    """
    if cfg.ranking != "two_tower":
        raise NotImplementedError(_COMPLICATED)
    outs = []
    for t in range(cfg.n_tasks):
        ru = mlp(select(p["user_mlp"], t), user_feat)          # (B, d)
        rv_all = mlp(select(p["item_mlp"], t), item_feat)      # (..., d+1)
        rv, rb = rv_all[..., :-1], rv_all[..., -1]
        if item_feat.dim() == 3:
            score = torch.einsum("bd,bsd->bs", ru, rv) + rb
        else:
            score = torch.sum(ru * rv, dim=-1) + rb
        outs.append(score)
    return torch.stack(outs)
