"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family] — dense LM with qk_norm, GQA kv=8."""
from repro_torch.configs.base import LMConfig, lm_shapes

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,          # qwen3 uses head_dim 128 (> d_model/n_heads)
    qk_norm=True,
    rope_theta=1000000.0,
)

SHAPES = lm_shapes()


def smoke() -> LMConfig:
    return LMConfig(name="qwen3-0.6b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                    head_dim=32, qk_norm=True, dtype="float32")
