"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small dense LM."""
from repro_torch.configs.base import LMConfig, lm_shapes

CONFIG = LMConfig(
    name="smollm-360m",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
)

SHAPES = lm_shapes()


def smoke() -> LMConfig:
    return LMConfig(name="smollm-360m-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                    dtype="float32")
