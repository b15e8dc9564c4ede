"""Two-tower retrieval [Covington RecSys'16 / Yi RecSys'19].

embed_dim=256, tower_mlp=1024-512-256, dot interaction, sampled softmax.
This arch is the paper's own indexing-step model family: the streaming VQ
index attaches directly on top of the item tower (vq_clusters=16384).
"""
from repro_torch.configs.base import EmbeddingSpec, RecsysConfig, \
    recsys_shapes

E = 256
CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    kind="two_tower",
    embed_dim=E,
    tower_mlp=(1024, 512, 256),
    interaction="dot",
    vq_clusters=16384,
    tables=(
        EmbeddingSpec("user_id", 33_554_432, E),
        EmbeddingSpec("user_hist", 33_554_432, E, bag_size=50),
        EmbeddingSpec("item_id", 33_554_432, E),
        EmbeddingSpec("item_cate", 65_536, E),
    ),
)

SHAPES = recsys_shapes()


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-smoke", kind="two_tower", embed_dim=16,
        tower_mlp=(32, 16), interaction="dot", vq_clusters=64,
        tables=(
            EmbeddingSpec("user_id", 500, 16),
            EmbeddingSpec("user_hist", 1000, 16, bag_size=5),
            EmbeddingSpec("item_id", 1000, 16),
            EmbeddingSpec("item_cate", 50, 16),
        ),
    )
