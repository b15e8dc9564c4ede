"""Config dataclasses of the SVQ retriever and the recsys families (own
copy of the JAX package's ``configs/base.py`` ``ShapeSpec``,
``recsys_shapes``, ``EmbeddingSpec``, ``RecsysConfig`` and
``SVQConfig``).

Every architecture module exports ``CONFIG`` (the published config),
``SHAPES`` (its input-shape set) and ``smoke()`` (a reduced config of the
same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell; recsys kinds: "train", "serve", "retrieval"."""

    name: str
    kind: str
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, key: str) -> int:
        return self.dims[key]

    def get(self, key: str, default: int = 0) -> int:
        return self.dims.get(key, default)


def recsys_shapes() -> List[ShapeSpec]:
    return [
        ShapeSpec("train_batch", "train", dict(batch=65536)),
        ShapeSpec("serve_p99", "serve", dict(batch=512)),
        ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        ShapeSpec("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1000000)),
    ]


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
class RecsysConfig:
    name: str
    kind: str                                 # din | bst | dlrm | two_tower
    embed_dim: int
    tables: Tuple[EmbeddingSpec, ...] = ()
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    tower_mlp: Tuple[int, ...] = ()
    attn_mlp: Tuple[int, ...] = ()
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    interaction: str = "dot"
    dtype: str = "float32"
    # streaming-VQ integration (retrieval archs only)
    vq_clusters: int = 0

    def n_embedding_rows(self) -> int:
        return sum(t.vocab for t in self.tables)

    def n_params(self) -> int:
        n = sum(t.vocab * t.dim for t in self.tables)

        def mlp(dims, d_in):
            tot, d = 0, d_in
            for h in dims:
                tot += d * h + h
                d = h
            return tot
        if self.kind == "dlrm":
            n += mlp(self.bot_mlp, self.n_dense)
            n_f = len(self.tables) + 1
            d_int = n_f * (n_f - 1) // 2 + self.bot_mlp[-1]
            n += mlp(self.top_mlp, d_int)
        elif self.kind == "two_tower":
            n += 2 * mlp(self.tower_mlp, self.embed_dim * 4)
        return n


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
