"""Plain dense building blocks on dicts of tensors."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.utils import tree

Params = Dict[str, Any]


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                scale: float | None = None) -> Params:
    if scale is None:
        scale = d_in ** -0.5
    return {
        "w": torch.randn((d_in, d_out), generator=gen,
                         device=gen.device) * scale,
        "b": torch.zeros((d_out,), device=gen.device),
    }


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def init_mlp(gen: torch.Generator, d_in: int,
             hidden: Sequence[int]) -> Params:
    layers = []
    d = d_in
    for h in hidden:
        layers.append(init_linear(gen, d, h))
        d = h
    return {"layers": layers}


def mlp(p: Params, x: torch.Tensor, act=torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """``act`` between layers, none after the last unless ``final_act``."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def init_layernorm(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Over the last axis, with the biased variance (as ``jnp.var``)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def init_rmsnorm(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * p["g"]


def count_params(params: Any) -> int:
    return sum(x.numel() for x in tree.leaves(params)
               if isinstance(x, torch.Tensor))


def stack(trees: Sequence[Any]) -> Any:
    """Stack per-task param trees on a new leading axis (the layout the
    reference's vmapped init produces)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(list(trees))


def select(tree: Any, t: int) -> Any:
    """Task ``t``'s slice of a stacked param tree."""
    if isinstance(tree, dict):
        return {k: select(v, t) for k, v in tree.items()}
    if isinstance(tree, list):
        return [select(v, t) for v in tree]
    return tree[t]
