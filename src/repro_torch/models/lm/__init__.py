from repro_torch.models.lm.attention import KVCache, init_cache
from repro_torch.models.lm.transformer import (
    decode_step, forward, greedy_generate, init_lm, lm_loss, prefill)
