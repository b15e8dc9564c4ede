"""Config dataclasses of the SVQ retriever (own copy of the JAX package's
``configs/base.py`` ``EmbeddingSpec`` and ``SVQConfig``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class EmbeddingSpec:
    """One sparse feature field -> one (possibly huge) embedding table."""
    name: str
    vocab: int
    dim: int
    # multiplicity of ids per sample for this field (1 = single-hot)
    bag_size: int = 1
    combiner: str = "sum"      # sum | mean


@dataclass(frozen=True)
class SVQConfig:
    """Config of the paper's streaming VQ retriever."""
    name: str = "svq"
    n_clusters: int = 16384            # 16K single-task, 32K multi-task
    embed_dim: int = 64                # intermediate embedding dim (u, v)
    n_tasks: int = 1
    # towers
    user_tower: Tuple[int, ...] = (512, 256, 64)
    item_tower: Tuple[int, ...] = (512, 256, 64)
    # item/user sparse feature tables (2^k so rows shard over any mesh)
    n_items: int = 2_097_152           # corpus capacity (hashed)
    n_users: int = 1_048_576
    item_embed_dim: int = 64
    user_embed_dim: int = 64
    user_hist_len: int = 50
    # EMA / balancing (Eq. 7-10)
    ema_alpha: float = 0.99
    beta: float = 0.6                  # popularity exponent on delta
    disturbance_s: float = 5.0
    # multi-task reward exponents eta_p (Eq. 12-13)
    eta: Tuple[float, ...] = (1.0,)
    # ranking step
    ranking: str = "two_tower"         # two_tower | complicated
    ranking_mlp: Tuple[int, ...] = (512, 256, 64)
    ranking_heads: int = 4
    # serving
    clusters_per_query: int = 128      # top clusters in indexing step
    candidates_out: int = 512          # merge-sort output size (50K in prod)
    chunk_size: int = 8                # Alg. 1 chunk
    # loss
    use_l_sim: bool = False            # ablation: vanilla VQ-VAE L_sim
    logq_debias: bool = True
    dtype: str = "float32"
    logits_dtype: str = "float32"

    def with_(self, **kw) -> "SVQConfig":
        return dataclasses.replace(self, **kw)
