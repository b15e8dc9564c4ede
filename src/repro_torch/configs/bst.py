"""BST [arXiv:1905.06874] — Behavior Sequence Transformer (Alibaba).

embed_dim=32, seq_len=20, n_blocks=1, n_heads=8, mlp=1024-512-256.
"""
from repro_torch.configs.base import EmbeddingSpec, RecsysConfig, \
    recsys_shapes

E = 32
CONFIG = RecsysConfig(
    name="bst",
    kind="bst",
    embed_dim=E,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    top_mlp=(1024, 512, 256),
    interaction="transformer-seq",
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
        name="bst-smoke", kind="bst", embed_dim=8, seq_len=6, n_blocks=1,
        n_heads=2, top_mlp=(32, 16), interaction="transformer-seq",
        tables=(
            EmbeddingSpec("item_id", 1000, 8),
            EmbeddingSpec("cate_id", 50, 8),
            EmbeddingSpec("user_id", 500, 8),
            EmbeddingSpec("context", 16, 8),
        ),
    )
