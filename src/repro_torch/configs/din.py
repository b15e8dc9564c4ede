"""DIN [arXiv:1706.06978] — Deep Interest Network (target attention).

embed_dim=18, seq_len=100, attn_mlp=80-40, mlp=200-80.
"""
from repro_torch.configs.base import EmbeddingSpec, RecsysConfig, \
    recsys_shapes

E = 18
CONFIG = RecsysConfig(
    name="din",
    kind="din",
    embed_dim=E,
    seq_len=100,
    attn_mlp=(80, 40),
    top_mlp=(200, 80),
    interaction="target-attn",
    tables=(
        EmbeddingSpec("item_id", 16_777_216, E),
        EmbeddingSpec("cate_id", 65_536, E),
        EmbeddingSpec("user_id", 8_388_608, E),
        EmbeddingSpec("context", 4_096, E),
    ),
)

SHAPES = recsys_shapes()


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="din-smoke", kind="din", embed_dim=8, seq_len=10,
        attn_mlp=(16, 8), top_mlp=(32, 16), interaction="target-attn",
        tables=(
            EmbeddingSpec("item_id", 1000, 8),
            EmbeddingSpec("cate_id", 50, 8),
            EmbeddingSpec("user_id", 500, 8),
            EmbeddingSpec("context", 16, 8),
        ),
    )
