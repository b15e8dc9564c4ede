"""The trainer of the streaming-VQ retriever, end to end.

``train_svq`` trains the paper's retriever on the impression + candidate
streams with the reference's production loop: Adagrad on the embedding
tables and AdamW on the dense nets, gradient clipping, the EMA codebook
and the real-time assignment write-back in every step.  It runs on
``cuda`` unless ``device="cpu"`` is passed.  ``train_svq_live`` (training
into a live service through deltas) waits for ROADMAP.md item A8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SVQConfig
from repro_torch.core import retriever
from repro_torch.data.streaming import RecsysStream
from repro_torch.optim import adagrad, adamw, clip_by_global_norm, \
    multi_optimizer
from repro_torch.train import LoopConfig, run_loop


def _route(path) -> str:
    return "adagrad" if "tables" in path else "adamw"


def _svq_opt():
    return multi_optimizer(_route, {"adagrad": adagrad(0.05),
                                    "adamw": adamw(1e-3)})


def _svq_step_fn(cfg: SVQConfig, opt, device=None):
    """The SVQ train step: train_step, clip, optimizer update."""
    device = resolve_device(device)

    def step_fn(state, batch):
        grads, new_index, metrics = retriever.train_step(
            state["params"], state["index"], cfg, batch["imp"],
            batch["cand"], device=device)
        grads, gn = clip_by_global_norm(grads, 10.0)
        params, opt_state = opt.update(grads, state["opt"],
                                       state["params"], state["step"])
        return ({"params": params, "index": new_index, "opt": opt_state,
                 "step": state["step"] + 1},
                dict(loss=metrics["loss"], grad_norm=gn,
                     used_clusters=metrics["used_clusters"],
                     perplexity=metrics["perplexity"]))

    return step_fn


def train_svq(cfg: SVQConfig, stream: RecsysStream, n_steps: int,
              batch: int, seed: int = 0, device=None,
              loop: Optional[LoopConfig] = None):
    """-> (params, index_state, loop_result).

    ``loop`` sets the loop's other settings (its ``n_steps`` is replaced
    by ``n_steps``); by default the metrics are read back every 10 steps,
    as in the reference's trainer.  The init is drawn from a
    ``torch.Generator`` seeded with ``seed``, so its numbers differ from
    the reference's ``jax.random`` init; a parity run builds
    ``_svq_step_fn`` and ``run_loop`` from bridged params.
    """
    device = resolve_device(device)
    opt = _svq_opt()
    gen = torch.Generator(device=device).manual_seed(seed)
    params, index = retriever.init(gen, cfg, device=device)
    state = {"params": params, "index": index, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = _svq_step_fn(cfg, opt, device)

    def batch_iter(step):
        return {"imp": stream.impression_batch(batch),
                "cand": stream.candidate_batch(batch)}

    loop_cfg = dataclasses.replace(loop or LoopConfig(), n_steps=n_steps)
    res = run_loop(step_fn, state, batch_iter, loop_cfg)
    return res.state["params"], res.state["index"], res
