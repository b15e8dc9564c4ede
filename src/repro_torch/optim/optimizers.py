"""Functional optimizers on param trees of tensors (the reference's
optax-style pairs, with the same formulas written out; ``torch.optim``'s
update rules differ).

Each optimizer is ``(init, update)`` with
  init(params) -> state
  update(grads, state, params, step) -> (new_params, new_state)
State is fp32.  ``multi_optimizer`` routes each param leaf by its path:
Adagrad on the embedding tables, AdamW on the dense nets.
``adafactor``, ``sgd_momentum`` and the schedules wait (ROADMAP.md A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.utils import tree

Params = Any
Grads = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Grads, Any, Params, torch.Tensor], Tuple[Params, Any]]


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@torch.no_grad()
def clip_by_global_norm(grads: Grads, max_norm: float
                        ) -> Tuple[Grads, torch.Tensor]:
    """-> (grads scaled to global norm <= max_norm, the global norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree.leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                         grads), gn


def adamw(lr: Callable[[torch.Tensor], Any] | float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        return {"m": tree.tree_map(_zeros, params),
                "v": tree.tree_map(_zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        out_p, out_m, out_v = [], [], []
        for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state["m"]),
                              tree.leaves(state["v"]), tree.leaves(params)):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            out_p.append((p.to(torch.float32) - lr_t * u).to(p.dtype))
            out_m.append(m)
            out_v.append(v)
        return (tree.unflatten(params, out_p),
                {"m": tree.unflatten(params, out_m),
                 "v": tree.unflatten(params, out_v)})

    return Optimizer(init, update)


def adagrad(lr: float = 0.05, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return tree.tree_map(_zeros, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        out_p, out_a = [], []
        for g, a, p in zip(tree.leaves(grads), tree.leaves(state),
                           tree.leaves(params)):
            g32 = g.to(torch.float32)
            a = a + g32 * g32
            out_p.append((p.to(torch.float32)
                          - lr * g32 / (torch.sqrt(a) + eps)).to(p.dtype))
            out_a.append(a)
        return tree.unflatten(params, out_p), tree.unflatten(params, out_a)

    return Optimizer(init, update)


def multi_optimizer(route: Callable[[tree.Path], str],
                    optimizers: Dict[str, Optimizer]) -> Optimizer:
    """Route each param leaf (by its path) to a named optimizer; the
    per-leaf states sit at the leaf positions of the params tree."""
    def init(params):
        return tree.unflatten(params, [
            optimizers[route(path)].init(p)
            for path, p in tree.flatten_with_path(params)])

    def update(grads, state, params, step):
        g_flat = tree.flatten_up_to(params, grads)
        s_flat = tree.flatten_up_to(params, state)
        new_p, new_s = [], []
        for (path, p), g, s in zip(tree.flatten_with_path(params), g_flat,
                                   s_flat):
            np_, ns = optimizers[route(path)].update(g, s, p, step)
            new_p.append(np_)
            new_s.append(ns)
        return tree.unflatten(params, new_p), tree.unflatten(params, new_s)

    return Optimizer(init, update)
