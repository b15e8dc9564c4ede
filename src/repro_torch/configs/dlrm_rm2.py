"""DLRM-RM2 [arXiv:1906.00091] — dot-interaction DLRM.

n_dense=13, n_sparse=26, embed_dim=64, bot 13-512-256-64, top 512-512-256-1.
Vocab mix follows the RM2 sizing posture (few huge + many medium tables).
"""
from repro_torch.configs.base import EmbeddingSpec, RecsysConfig, \
    recsys_shapes

E = 64


def _tables():
    tabs = []
    for i in range(4):                       # huge id spaces, multi-hot
        tabs.append(EmbeddingSpec(f"sparse_{i}", 8_000_000, E, bag_size=20))
    for i in range(4, 12):                   # medium
        tabs.append(EmbeddingSpec(f"sparse_{i}", 1_000_000, E))
    for i in range(12, 26):                  # small
        tabs.append(EmbeddingSpec(f"sparse_{i}", 100_000, E))
    return tuple(tabs)


CONFIG = RecsysConfig(
    name="dlrm-rm2",
    kind="dlrm",
    embed_dim=E,
    n_dense=13,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
    tables=_tables(),
)

SHAPES = recsys_shapes()


def smoke() -> RecsysConfig:
    tabs = tuple(
        EmbeddingSpec(f"sparse_{i}", 200, 8, bag_size=(3 if i < 2 else 1))
        for i in range(6))
    return RecsysConfig(
        name="dlrm-rm2-smoke", kind="dlrm", embed_dim=8, n_dense=13,
        bot_mlp=(16, 8), top_mlp=(16, 8, 1), interaction="dot", tables=tabs)
