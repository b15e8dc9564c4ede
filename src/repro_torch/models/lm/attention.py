"""Attention for the LM family: RoPE, GQA, qk-norm, flash attention,
decode (own copy of the JAX package's ``models/lm/attention.py``).

Three execution shapes:
  - ``full``      : the (B, H, S, T) scores made whole; short sequences.
  - ``flash_scan``: the online softmax over key blocks.  On the card one
                    ``flash_attention`` kernel launch takes every
                    (batch, head); on the CPU it is the reference's
                    blockwise recurrence, written out.
  - ``decode``    : one query token against a KV cache, which it updates
                    in place.

GQA: query head h reads kv head h // (H // Hk).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rmsnorm_headwise(x: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm used by qk_norm archs (qwen3). x: (..., hd)."""
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(ms + eps)) * g).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA broadcast
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hk, hd) -> (B, S, Hk*n_rep, hd), kv head j repeated n_rep
    times in place."""
    if n_rep == 1:
        return x
    b, s, hk, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, n_rep, hd) \
        .reshape(b, s, hk * n_rep, hd)


# ---------------------------------------------------------------------------
# Full (materialized) causal attention — short sequences
# ---------------------------------------------------------------------------

def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,Hk,hd); GQA-broadcast inside. -> like q.

    The logits are fp32 products of the inputs (exact for bf16), the
    softmax weights are rounded to v's dtype before the second product,
    which sums in fp32 and rounds to v's dtype, as the reference's
    einsums do."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    t = k.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
        kpos = torch.arange(t, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w.to(torch.float32),
                        v.to(torch.float32)).to(v.dtype)


# ---------------------------------------------------------------------------
# Flash attention: online softmax over KV blocks
# ---------------------------------------------------------------------------

def attention_flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         block_kv: int = 512,
                         causal: bool = True) -> torch.Tensor:
    """Blockwise causal attention with the flash recurrence.

    q: (B,S,H,hd); k/v: (B,T,Hk,hd).  On the card: one ``flash_attention``
    launch over every (b, h), which scales the logits after the product as
    the TPU kernel does and skips key tiles above the diagonal; it has no
    backward (ROADMAP.md A22).  On the CPU: the reference's recurrence
    over ``block_kv`` keys at a time, q pre-scaled in fp32 and a ragged
    key tail padded and masked."""
    if q.is_cuda:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal)
    b, s, h, hd = q.shape
    hk = k.shape[2]
    n_rep = h // hk
    t = k.shape[1]
    t_pad = -(-t // block_kv) * block_kv
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    scale = hd ** -0.5
    q32 = q.to(torch.float32) * scale
    qpos = torch.arange(s, device=q.device) + (t - s)   # absolute q position

    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    for i in range(t_pad // block_kv):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        k_blk = repeat_kv(k[:, sl], n_rep)                 # (B,block,H,hd)
        v_blk = repeat_kv(v[:, sl], n_rep)
        kpos = i * block_kv + torch.arange(block_kv, device=q.device)
        logits = torch.einsum("bshd,bthd->bhst", q32,
                              k_blk.to(torch.float32))     # (B,H,S,block)
        mask = kpos[None, :] < t
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))     # (B,H,S)
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])           # (B,H,S,block)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] \
            + torch.einsum("bhst,bthd->bshd", p, v_blk.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode: one query token against a fixed-capacity cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """k, v: (L, B, S_max, Hk, hd); pos: the fill length (uniform over the
    batch), a Python int so that slicing at it needs no device sync.
    ``decode_step`` writes its token's row into k and v in place (at full
    width one copy of the cache is tens of GB), so a cache passed to it
    must not be used again; use the cache it returns."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int

    @property
    def s_max(self) -> int:
        return self.k.shape[2]


def init_cache(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a cache layer.

    q: (B,1,H,hd); k_cache/v_cache: (B,S_max,Hk,hd); k_new/v_new:
    (B,1,Hk,hd).  Writes k_new and v_new at ``pos`` into the caches IN
    PLACE (the reference returns updated copies) and returns
    (out (B,1,H,hd), k_cache, v_cache).  The scores run over the whole
    S_max axis in fp32, slots after ``pos`` masked, as the reference's."""
    b, _, h, hd = q.shape
    s_max = k_cache.shape[1]
    hk = k_cache.shape[2]
    n_rep = h // hk
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    scale = hd ** -0.5
    q32 = q.to(torch.float32) * scale
    qh = q32.reshape(b, 1, hk, n_rep, hd)
    logits = torch.einsum("bqkrd,btkd->bkrqt", qh,
                          k_cache.to(torch.float32))       # (B,Hk,rep,1,S)
    valid = torch.arange(s_max, device=q.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqt,btkd->bqkrd", w, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype), k_cache, v_cache
