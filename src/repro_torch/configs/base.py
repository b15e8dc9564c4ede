"""Config dataclasses of the SVQ retriever, the recsys families and the
LM family (own copy of the JAX package's ``configs/base.py``
``ShapeSpec``, ``lm_shapes``, ``recsys_shapes``, ``MoEConfig``,
``LMConfig``, ``EmbeddingSpec``, ``RecsysConfig`` and ``SVQConfig``).

Every architecture module exports ``CONFIG`` (the published config),
``SHAPES`` (its input-shape set) and ``smoke()`` (a reduced config of the
same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell.  LM kinds: "train", "prefill", "decode" (one
    new token against a KV cache of seq_len); recsys kinds: "train",
    "serve", "retrieval"."""

    name: str
    kind: str
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, key: str) -> int:
        return self.dims[key]

    def get(self, key: str, default: int = 0) -> int:
        return self.dims.get(key, default)


def lm_shapes() -> List[ShapeSpec]:
    return [
        ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeSpec("decode_32k", "decode",
                  dict(seq_len=32768, global_batch=128)),
        # one token against a 524,288-entry KV cache
        ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
    ]


def recsys_shapes() -> List[ShapeSpec]:
    return [
        ShapeSpec("train_batch", "train", dict(batch=65536)),
        ShapeSpec("serve_p99", "serve", dict(batch=512)),
        ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        ShapeSpec("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1000000)),
    ]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # capacity factor for dispatch (tokens per expert = cf * tokens * top_k / E)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class LMConfig:
    """A decoder-only LM.  The port runs every field's function; the
    reference's mesh and compile knobs (``remat``, ``scan_layers``,
    ``attn_unroll``, ``seq_shard``, ``force_fsdp``, ``moe_impl``,
    ``microbatch``) are kept as data, since none changes what the model
    computes."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "dots"
    scan_layers: bool = True
    attn_unroll: int = 1
    seq_shard: bool = True
    force_fsdp: int = -1
    block_kv: int = 1024          # flash-attention route above this length
    moe_impl: str = "shard_map"
    microbatch: int = 1

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        return (self.d_model * self.n_heads * hd           # q
                + 2 * self.d_model * self.n_kv_heads * hd  # k, v
                + self.n_heads * hd * self.d_model)        # o

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        if self.moe is None:
            ffn = 3 * self.d_model * self.d_ff
        else:
            ffn = self.moe.n_experts * 3 * self.d_model * self.d_ff \
                + self.d_model * self.moe.n_experts        # router
        block = self._attn_params() + ffn + 2 * self.d_model
        return (self.vocab * self.d_model + self.n_layers * block
                + self.d_model + self.vocab * self.d_model)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        ffn_active = self.moe.top_k * 3 * self.d_model * self.d_ff \
            + self.d_model * self.moe.n_experts
        block = self._attn_params() + ffn_active + 2 * self.d_model
        return (self.vocab * self.d_model + self.n_layers * block
                + self.d_model + self.vocab * self.d_model)


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
