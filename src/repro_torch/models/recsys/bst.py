"""BST [arXiv:1905.06874] — Behavior Sequence Transformer (Alibaba).

The target item is appended to the behavior sequence; a small
transformer block (post-LN, as in the paper) crosses them; the outputs
are flattened and concatenated with the user and context features into
the final MLP.  The block's attention is plain torch (einsum + softmax).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.losses import bce_logits
from repro_torch.models.dense import init_layernorm, init_linear, init_mlp, \
    layernorm, linear, mlp
from repro_torch.models.recsys import embedding as emb

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: RecsysConfig, device=None
         ) -> Params:
    """Random params on ``device`` (``cuda`` unless named), drawn from
    ``gen``, which must lie there (``torch.Generator(device)``)."""
    device = emb.init_device(gen, device)
    d = 2 * cfg.embed_dim            # item + cate embedding per position
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": init_linear(gen, d, d),
            "wk": init_linear(gen, d, d),
            "wv": init_linear(gen, d, d),
            "wo": init_linear(gen, d, d),
            "ln1": init_layernorm(d, device),
            "ffn1": init_linear(gen, d, 4 * d),
            "ffn2": init_linear(gen, 4 * d, d),
            "ln2": init_layernorm(d, device),
        })
    d_cat = d * (cfg.seq_len + 1) + 2 * cfg.embed_dim
    return {
        "tables": emb.init_tables(gen, cfg.tables),
        "pos": torch.randn((cfg.seq_len + 1, d), generator=gen,
                           device=device) * 0.02,
        "blocks": blocks,
        "head": init_mlp(gen, d_cat, cfg.top_mlp + (1,)),
    }


def _block(bp: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b = x.shape[:-2]
    s, d = x.shape[-2:]
    hd = d // n_heads
    q = linear(bp["wq"], x).reshape(*b, s, n_heads, hd)
    k = linear(bp["wk"], x).reshape(*b, s, n_heads, hd)
    v = linear(bp["wv"], x).reshape(*b, s, n_heads, hd)
    logits = torch.einsum("...shd,...thd->...hst", q, k) / (hd ** 0.5)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("...hst,...thd->...shd", w, v).reshape(*b, s, d)
    x = layernorm(bp["ln1"], x + linear(bp["wo"], o))
    h = torch.relu(linear(bp["ffn1"], x))
    return layernorm(bp["ln2"], x + linear(bp["ffn2"], h))


def forward(p: Params, cfg: RecsysConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    t = p["tables"]
    hist = torch.cat([
        emb.lookup(t["item_id"], batch["hist_items"]),
        emb.lookup(t["cate_id"], batch["hist_cates"])], -1)  # (B,S,2e)
    target = torch.cat([
        emb.lookup(t["item_id"], batch["target_item"]),
        emb.lookup(t["cate_id"], batch["target_cate"])], -1)
    user = torch.cat([
        emb.lookup(t["user_id"], batch["user_id"]),
        emb.lookup(t["context"], batch["context"])], -1)

    if target.dim() == 3:                      # candidate axis (B, C, 2e)
        bsz, c = target.shape[:2]
        seq = torch.cat(
            [hist[:, None].expand((bsz, c) + tuple(hist.shape[1:])),
             target[:, :, None]], dim=-2)      # (B,C,S+1,2e)
        user = user[:, None].expand(bsz, c, user.shape[-1])
    else:
        seq = torch.cat([hist, target[:, None]], dim=-2)
    seq = seq + p["pos"]
    for bp in p["blocks"]:
        seq = _block(bp, seq, cfg.n_heads)
    flat = seq.reshape(*seq.shape[:-2], -1)
    x = torch.cat([flat, user], -1)
    return mlp(p["head"], x)[..., 0]


def loss(p: Params, cfg: RecsysConfig, batch: Dict[str, torch.Tensor]
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(p, cfg, batch)
    return (bce_logits(logits, batch["label"].to(logits.dtype)),
            dict(logit_mean=torch.mean(logits)))


def serve(p: Params, cfg: RecsysConfig,
          batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sigmoid(forward(p, cfg, batch))


def retrieval(p: Params, cfg: RecsysConfig,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    b2 = dict(batch)
    b2["target_item"] = batch["cand_items"][None, :]
    b2["target_cate"] = batch["cand_cates"][None, :]
    return forward(p, cfg, b2)[0]
