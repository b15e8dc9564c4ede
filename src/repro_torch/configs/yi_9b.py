"""Yi-9B [arXiv:2403.04652] — llama-arch dense LM with GQA (kv=4)."""
from repro_torch.configs.base import LMConfig, lm_shapes

CONFIG = LMConfig(
    name="yi-9b",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    # the reference's memory settings for training on a mesh (full remat,
    # FSDP); kept as data
    remat="full",
    force_fsdp=1,
)

SHAPES = lm_shapes()


def smoke() -> LMConfig:
    return LMConfig(name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=8,
                    n_kv_heads=1, d_ff=160, vocab=256, dtype="float32")
