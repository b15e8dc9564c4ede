"""DLRM-RM2 [arXiv:1906.00091] — dense bottom MLP + dot interaction.

26 sparse fields (4 huge multi-hot tables through the ``embedding_bag``
kernel, 8 medium, 14 small single-hot) are looked up, the 13 dense
features pass the bottom MLP, and the pairwise dot products of all 27
vectors (the bottom output included) feed the top MLP.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

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
    n_f = len(cfg.tables) + 1
    d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "tables": emb.init_tables(gen, cfg.tables),
        "bot": init_mlp(gen, cfg.n_dense, cfg.bot_mlp),
        "top": init_mlp(gen, d_int, cfg.top_mlp),
    }


def sparse_vectors(p: Params, cfg: RecsysConfig,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> (B, n_tables, d): one pooled vector per sparse field."""
    outs = []
    for spec in cfg.tables:
        ids = batch[spec.name]
        table = p["tables"][spec.name]
        if ids.dim() == 2:                        # multi-hot bag
            outs.append(emb.embedding_bag(table, ids, spec.combiner))
        else:
            outs.append(emb.lookup(table, ids))
    return torch.stack(outs, dim=-2)


def forward(p: Params, cfg: RecsysConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    dense = mlp(p["bot"], batch["dense"], final_act=True)   # (B, d)
    sp = sparse_vectors(p, cfg, batch)                      # (B, T, d)
    f = torch.cat([dense[..., None, :], sp], dim=-2)        # (B, T+1, d)
    # pairwise dot interaction (upper triangle, no self), row-major as
    # jnp.triu_indices
    z = torch.einsum("...td,...ud->...tu", f, f)
    n_f = f.shape[-2]
    iu, ju = torch.triu_indices(n_f, n_f, offset=1, device=f.device)
    inter = z[..., iu, ju]                                  # (B, T(T+1)/2)
    x = torch.cat([dense, inter], dim=-1)
    return mlp(p["top"], x)[..., 0]


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
    """retrieval_cand: one user context against C candidate item rows.

    Every field's ids carry the candidate axis as the batch axis; a
    single dense row broadcasts over the C candidates.
    """
    c = batch[cfg.tables[0].name].shape[0]
    b2 = {spec.name: batch[spec.name] for spec in cfg.tables}
    dense = batch["dense"]
    b2["dense"] = (dense.expand((c,) + tuple(dense.shape[1:]))
                   if dense.shape[0] == 1 else dense)
    return forward(p, cfg, b2)
