"""LM-family transformer: GQA + RoPE + qk-norm, dense FFN (own copy of
the JAX package's ``models/lm/transformer.py``).

Covers the dense LM archs (smollm-360m, yi-9b, qwen3-0.6b) from one
definition.  Params keep the reference's layout, stacked over layers
(``layers[name]`` of shape (L, ...)), so the numpy bridge carries them
as they are; the port loops over the layers.  Train and prefill take
``attention_full`` up to ``block_kv`` tokens and the flash route above
(the ``flash_attention`` kernel on the card); decode attends one token
against a KV cache, which it updates in place.  The reference's mesh
machinery (``LMSharding``, ``param_specs``, the sharding constraints)
waits for ROADMAP.md A9, the MoE FFN for A21, and rematerialisation for
training at full width for A22.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.attention import KVCache

Params = Dict[str, Any]

NEG_LOGIT = -1e30          # the vocab padding's logits


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _no_moe(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN is not ported "
                                  f"yet: ROADMAP.md item A21")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: LMConfig, device=None) -> Params:
    """Random params on ``device`` (``cuda`` unless named), drawn from
    ``gen``, which must lie there: N(0, 1/fan_in) weights drawn in fp32
    and cast to ``cfg.dtype``, unit norms, the vocab padded to
    ``cfg.padded_vocab``.  The numbers differ from the reference's
    ``jax.random`` init; a parity run bridges the reference's params."""
    _no_moe(cfg)
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, init on {device}")
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    d, h, hk, f, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                      cfg.n_layers)

    def w(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(fan_in ** -0.5).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers: Params = {
        "attn_norm": ones((n, d)),
        "wq": w((n, d, h * hd), d),
        "wk": w((n, d, hk * hd), d),
        "wv": w((n, d, hk * hd), d),
        "wo": w((n, h * hd, d), h * hd),
        "ffn_norm": ones((n, d)),
        "w1": w((n, d, f), d),
        "w3": w((n, d, f), d),
        "w2": w((n, f, d), f),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones((n, hd))
        layers["k_norm"] = ones((n, hd))
    vp = cfg.padded_vocab
    return {"embed": w((vp, d), d), "layers": layers,
            "final_norm": ones((d,)), "lm_head": w((d, vp), d)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 only for the (B, S, 1) statistics; x * inv * g are two products
    # in x's dtype, as the reference computes them
    ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * g


def _attention_block(p: Params, cfg: LMConfig, h: torch.Tensor,
                     positions: torch.Tensor,
                     kv_layer: Optional[Tuple[torch.Tensor, torch.Tensor]],
                     cache_pos: Optional[int], block_kv: int):
    """Returns (attn_out, (k, v) for the prefill cache, or the cache layer
    updated in place)."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    nh, nk = cfg.n_heads, cfg.n_kv_heads
    x = _rmsnorm(h, p["attn_norm"], cfg.norm_eps)
    q = (x @ p["wq"]).reshape(b, s, nh, hd)
    k = (x @ p["wk"]).reshape(b, s, nk, hd)
    v = (x @ p["wv"]).reshape(b, s, nk, hd)
    if cfg.qk_norm:
        q = attn.rmsnorm_headwise(q, p["q_norm"], cfg.norm_eps)
        k = attn.rmsnorm_headwise(k, p["k_norm"], cfg.norm_eps)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)

    if kv_layer is not None:                      # decode path
        k_c, v_c = kv_layer
        out, k_c, v_c = attn.attention_decode(q, k_c, v_c, k, v, cache_pos)
        aux = (k_c, v_c)
    else:
        if s <= block_kv:
            out = attn.attention_full(q, k, v, causal=True)
        else:
            out = attn.attention_flash_scan(q, k, v, block_kv=block_kv,
                                            causal=True)
        aux = (k, v)                              # raw kv for prefill cache
    out = out.reshape(b, s, nh * hd) @ p["wo"]
    return out, aux


def _ffn_block(p: Params, cfg: LMConfig, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    _no_moe(cfg)
    x = _rmsnorm(h, p["ffn_norm"], cfg.norm_eps)
    h1 = x @ p["w1"]
    h3 = x @ p["w3"]
    y = (torch.nn.functional.silu(h1.to(torch.float32)).to(h1.dtype) * h3) \
        @ p["w2"]
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


def _layer(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            mode: str = "train", cache: Optional[KVCache] = None,
            block_kv: int = 0
            ) -> Tuple[torch.Tensor, Optional[KVCache], torch.Tensor]:
    """-> (logits (B, S, padded_vocab), cache', moe_aux_loss).

    mode "train"/"prefill": tokens (B, S); prefill also returns the
    filled KVCache (S_max = S).  mode "decode": tokens (B, 1) and
    ``cache`` required; the cache is updated in place and returned with
    ``pos`` advanced.  ``block_kv`` (default ``cfg.block_kv``): sequences
    longer than it take the flash route."""
    _no_moe(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    b, s = tokens.shape
    block_kv = block_kv or cfg.block_kv
    dt = _dt(cfg)
    h = params["embed"][tokens.long()].to(dt)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        positions = (cache.pos + torch.arange(s, device=h.device))[None, :]
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            out, _ = _attention_block(p, cfg, h, positions,
                                      (cache.k[i], cache.v[i]), cache.pos,
                                      block_kv)
            h = h + out
            y, _ = _ffn_block(p, cfg, h)
            h = h + y
        new_cache = KVCache(k=cache.k, v=cache.v, pos=cache.pos + s)
    else:
        positions = torch.arange(s, device=h.device)[None, :]
        new_cache = None
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            out, (k, v) = _attention_block(p, cfg, h, positions, None, None,
                                           block_kv)
            h = h + out
            y, aux_l = _ffn_block(p, cfg, h)
            h = h + y
            aux_total = aux_total + aux_l
            if mode == "prefill":
                if new_cache is None:
                    new_cache = KVCache(
                        k=torch.empty((cfg.n_layers, *k.shape), dtype=k.dtype,
                                      device=k.device),
                        v=torch.empty((cfg.n_layers, *v.shape), dtype=v.dtype,
                                      device=v.device), pos=s)
                new_cache.k[i] = k
                new_cache.v[i] = v

    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ params["lm_head"]
    if cfg.padded_vocab != cfg.vocab:      # mask vocab-padding logits
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits.masked_fill_(pad, NEG_LOGIT)
    return logits, new_cache, aux_total


# ---------------------------------------------------------------------------
# Losses / steps
# ---------------------------------------------------------------------------

def lm_loss(params: Params, cfg: LMConfig, batch: Dict[str, torch.Tensor],
            block_kv: int = 0, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy; labels < 0 are masked."""
    logits, _, aux = forward(params, cfg, batch["tokens"], "train",
                             block_kv=block_kv)
    labels = batch["labels"].long()
    mask = labels >= 0
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    ce = torch.where(mask, logz - gold, 0.0)
    ntok = torch.clamp(mask.sum(), min=1)
    loss = ce.sum() / ntok + aux_weight * aux
    return loss, dict(ce=ce.sum() / ntok, moe_aux=aux, n_tokens=ntok)


def decode_step(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """serve_step: one new token per sequence against the KV cache, which
    is updated in place (do not use ``cache`` again; use the one
    returned)."""
    logits, new_cache, _ = forward(params, cfg, tokens, "decode",
                                   cache=cache)
    return logits, new_cache


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            block_kv: int = 0) -> Tuple[torch.Tensor, KVCache]:
    logits, cache, _ = forward(params, cfg, tokens, "prefill",
                               block_kv=block_kv)
    return logits, cache


def grow_cache(cache: KVCache, extra: int) -> KVCache:
    """The cache with ``extra`` more (zero) slots on the sequence axis."""
    l, b, s, hk, hd = cache.k.shape
    k = cache.k.new_zeros((l, b, s + extra, hk, hd))
    v = cache.v.new_zeros((l, b, s + extra, hk, hd))
    k[:, :, :s] = cache.k
    v[:, :, :s] = cache.v
    return KVCache(k=k, v=v, pos=cache.pos)


def greedy_generate(params: Params, cfg: LMConfig, prompt: torch.Tensor,
                    n_steps: int) -> torch.Tensor:
    """Greedy sampler: prefill the prompt (B, S), then ``n_steps - 1``
    decode steps -> (B, n_steps) tokens."""
    logits, cache = prefill(params, cfg, prompt)
    cache = grow_cache(cache, n_steps)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
    outs = [tok]
    for _ in range(n_steps - 1):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
        outs.append(tok)
    return torch.cat(outs, dim=1)
