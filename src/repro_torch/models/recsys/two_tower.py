"""Two-tower retrieval [Covington RecSys'16, Yi et al. RecSys'19].

The paper's indexing-step model family: the user and item towers give
the intermediate embeddings u, v of Fig. 1, and training uses the
in-batch sampled softmax with the logQ correction (L_aux, Eq. 1).  The
item tower emits (personality embedding, popularity bias), Eq. 11's
decomposition.  The user history is a mean bag through the
``embedding_bag`` kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core import losses
from repro_torch.models.dense import init_mlp, mlp
from repro_torch.models.recsys import embedding as emb

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: RecsysConfig, device=None
         ) -> Params:
    """Random params on ``device`` (``cuda`` unless named), drawn from
    ``gen``, which must lie there (``torch.Generator(device)``)."""
    device = emb.init_device(gen, device)
    d = cfg.embed_dim
    return {
        "tables": emb.init_tables(gen, cfg.tables),
        "user_tower": init_mlp(gen, 2 * d, cfg.tower_mlp),
        # +1: popularity bias head (Eq. 11)
        "item_tower": init_mlp(
            gen, 2 * d, cfg.tower_mlp[:-1] + (cfg.tower_mlp[-1] + 1,)),
    }


def encode_user(p: Params, cfg: RecsysConfig,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    t = p["tables"]
    uid = emb.lookup(t["user_id"], batch["user_id"])
    hist = emb.embedding_bag(t["user_hist"], batch["user_hist"], "mean")
    return mlp(p["user_tower"], torch.cat([uid, hist], -1))


def encode_item(p: Params, cfg: RecsysConfig, item_id: torch.Tensor,
                item_cate: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = p["tables"]
    iid = emb.lookup(t["item_id"], item_id)
    cat = emb.lookup(t["item_cate"], item_cate)
    v = mlp(p["item_tower"], torch.cat([iid, cat], -1))
    return v[..., :-1], v[..., -1]


def loss(p: Params, cfg: RecsysConfig, batch: Dict[str, torch.Tensor],
         log_q: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled softmax (L_aux, Eq. 1) with optional logQ debias;
    the in-batch accuracy is a metric read from the dense logits."""
    u = encode_user(p, cfg, batch)
    v, v_bias = encode_item(p, cfg, batch["item_id"], batch["item_cate"])
    l = losses.l_aux(u, v, v_bias, log_q)
    with torch.no_grad():
        logits = losses.build_logits(u, v, v_bias, log_q)
        hit = torch.argmax(logits, -1) == torch.arange(logits.shape[0],
                                                       device=u.device)
        acc = torch.mean(hit.to(torch.float32))
    return l, dict(inbatch_acc=acc)


def serve(p: Params, cfg: RecsysConfig,
          batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pointwise user-item scores (serve cells)."""
    u = encode_user(p, cfg, batch)
    v, v_bias = encode_item(p, cfg, batch["item_id"], batch["item_cate"])
    return torch.sum(u * v, dim=-1) + v_bias


def retrieval(p: Params, cfg: RecsysConfig, batch: Dict[str, torch.Tensor],
              top_k: int = 0) -> Dict[str, torch.Tensor]:
    """retrieval_cand: one user against (C,) candidates, one (1, d) x
    (d, C) product.  ``top_k`` adds the k best (scores, int32 indices),
    descending, ties to the lower index as ``lax.top_k`` (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    u = encode_user(p, cfg, batch)                       # (1, d)
    v, v_bias = encode_item(p, cfg, batch["cand_items"],
                            batch["cand_cates"])         # (C, d), (C,)
    scores = (u @ v.T)[0] + v_bias                       # (C,)
    if top_k:
        top_s, top_i = torch.sort(scores, descending=True, stable=True)
        return dict(scores=scores, top_scores=top_s[:top_k],
                    top_idx=top_i[:top_k].to(torch.int32))
    return dict(scores=scores)
