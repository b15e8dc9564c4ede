from repro_torch.configs.base import EmbeddingSpec, SVQConfig  # noqa: F401
