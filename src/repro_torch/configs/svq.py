"""The paper's own model: streaming VQ retriever (single task)."""
from repro_torch.configs.base import SVQConfig

CONFIG = SVQConfig()                       # 16K clusters, single task


def smoke() -> SVQConfig:
    return SVQConfig(
        name="svq-smoke", n_clusters=64, embed_dim=16,
        user_tower=(32, 16), item_tower=(32, 16),
        n_items=2000, n_users=1000, item_embed_dim=16, user_embed_dim=16,
        user_hist_len=8, clusters_per_query=8, candidates_out=64,
        chunk_size=4)
