"""The trainer of the streaming-VQ retriever, end to end.

``train_svq`` trains the paper's retriever on the impression + candidate
streams with the reference's production loop: Adagrad on the embedding
tables and AdamW on the dense nets, gradient clipping, the EMA codebook
and the real-time assignment write-back in every step.
``eval_svq_recall`` reads the trained state's Recall@K.
``train_arch_smoke`` trains one recsys or dense LM architecture's smoke
config for a few steps.  All run on ``cuda`` unless ``device="cpu"`` is
passed.
``train_svq_live`` (training into a live service through deltas) waits
for ROADMAP.md item A8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.baselines.brute_force import recall_at_k
from repro_torch.configs import get_smoke
from repro_torch.configs.base import LMConfig, RecsysConfig, SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import retriever
from repro_torch.data.streaming import RecsysStream, lm_batch
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.recsys import _RECSYS_MODS
from repro_torch.optim import adagrad, adamw, clip_by_global_norm, \
    multi_optimizer
from repro_torch.train import LoopConfig, run_loop
from repro_torch.utils import tree


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
              batch: int, ckpt_dir: Optional[str] = None,
              log_every: int = 0, seed: int = 0, *, device=None,
              loop: Optional[LoopConfig] = None):
    """-> (params, index_state, loop_result).

    The reference's positional order; ``ckpt_dir`` (checkpointing) is not
    ported yet and must be None.  ``log_every`` prints the last recorded
    metrics every that many steps (0 = silent).  ``loop`` sets the loop's
    other settings (its ``n_steps`` and ``log_every`` are replaced by the
    arguments); by default the metrics are read back every 10 steps, as
    in the reference's trainer.  The init is drawn from a
    ``torch.Generator`` seeded with ``seed``, so its numbers differ from
    the reference's ``jax.random`` init; a parity run builds
    ``_svq_step_fn`` and ``run_loop`` from bridged params.
    """
    if ckpt_dir is not None:
        raise NotImplementedError("checkpointing in train_svq is not ported "
                                  "yet: ROADMAP.md item A7")
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

    loop_cfg = dataclasses.replace(loop or LoopConfig(), n_steps=n_steps,
                                   log_every=log_every)
    res = run_loop(step_fn, state, batch_iter, loop_cfg)
    return res.state["params"], res.state["index"], res


def eval_svq_recall(cfg: SVQConfig, params, index_state,
                    stream: RecsysStream, n_users: int = 64, k: int = 50,
                    *, device=None) -> Dict[str, float]:
    """Recall@K of the VQ retrieval path vs the stream's ground-truth
    affinity: a serving index built from the store serves users
    0..n_users-1 (mod the stream's users), and the first K ranked ids of
    each are held to ``stream.true_topk``.  ``params`` and
    ``index_state`` lie on ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    idx = astore.build_serving_index(index_state.store, cfg.n_clusters)
    users = np.arange(n_users) % stream.cfg.n_users
    batch = dict(user_id=users.astype(np.int32),
                 hist=stream.user_hist[users].astype(np.int32))
    with torch.no_grad():
        out = retriever.serve(params, index_state, cfg, idx, batch,
                              device=device)
    got = out["item_ids"].cpu().numpy()[:, :k]
    truth = stream.true_topk(users, k)
    return dict(recall=recall_at_k(got, truth),
                served_valid=float(out["valid"].cpu().numpy().mean()))


# ---------------------------------------------------------------------------
# Per-arch smoke training (reduced configs)
# ---------------------------------------------------------------------------

def train_arch_smoke(arch: str, n_steps: int = 5, batch: int = 8,
                     seed: int = 0, *, device=None) -> Dict[str, float]:
    """Train one architecture's smoke config for ``n_steps`` steps of
    ``batch`` with the reference's optimizer -> first and last loss.
    Recsys: Adagrad on the tables, AdamW elsewhere, gradients clipped to
    norm 10.  Dense LM: AdamW 1e-3, clipped to norm 1, on ``lm_batch``
    sequences of 32 tokens.  The init is drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``, the batches from
    ``np.random.default_rng(seed)`` as the reference draws them.  MoE LM
    and GNN archs raise naming their ROADMAP.md items."""
    cfg = get_smoke(arch)
    if not isinstance(cfg, (RecsysConfig, LMConfig)):
        raise ValueError(f"{arch}: train_arch_smoke trains the recsys and "
                         f"LM families; the SVQ retriever trains with "
                         f"train_svq")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    if isinstance(cfg, LMConfig):
        params = tfm.init_lm(gen, cfg, device)
        _, losses = _train_lm(cfg, params, rng, n_steps, batch, device)
    else:
        params = _RECSYS_MODS[cfg.kind].init(gen, cfg, device)
        _, losses = _train_recsys(cfg, params, rng, n_steps, batch, device)
    return dict(first_loss=losses[0], last_loss=losses[-1])


LM_SMOKE_SEQ = 32          # train_arch_smoke's LM sequence length


def _train_lm(cfg: LMConfig, params, rng: np.random.Generator, n_steps: int,
              batch: int, device) -> Tuple[dict, List[float]]:
    """The LM step loop of ``train_arch_smoke`` from the given params:
    AdamW 1e-3, gradients clipped to norm 1 -> (params, the loss of each
    step)."""
    device = resolve_device(device)
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    losses = []
    for step in range(n_steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in lm_batch(rng, batch, LM_SMOKE_SEQ, cfg.vocab).items()}
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in tree.leaves(params)]
        with torch.enable_grad():
            loss, _ = tfm.lm_loss(tree.unflatten(params, leaves), cfg, b)
            grads = torch.autograd.grad(loss, leaves)
        grads, _ = clip_by_global_norm(tree.unflatten(params, list(grads)),
                                       1.0)
        params, opt_state = opt.update(
            grads, opt_state, params,
            torch.tensor(step, dtype=torch.int32, device=device))
        losses.append(float(loss.detach()))
    return params, losses


def _train_recsys(cfg: RecsysConfig, params, rng: np.random.Generator,
                  n_steps: int, batch: int, device
                  ) -> Tuple[dict, List[float]]:
    """The step loop of ``train_arch_smoke`` from the given params ->
    (params, the loss of each step)."""
    mod = _RECSYS_MODS[cfg.kind]
    device = resolve_device(device)
    opt = _svq_opt()             # the reference's recsys optimizer too
    opt_state = opt.init(params)
    losses = []
    for step in range(n_steps):
        b = _smoke_recsys_batch(cfg, rng, batch, device)
        paths = tree.flatten_with_path(params)
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in paths]
        with torch.enable_grad():
            loss, _ = mod.loss(tree.unflatten(params, leaves), cfg, b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree.unflatten(params, [
            torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, grads)])
        grads, _ = clip_by_global_norm(grads, 10.0)
        params, opt_state = opt.update(
            grads, opt_state, params,
            torch.tensor(step, dtype=torch.int32, device=device))
        losses.append(float(loss.detach()))
    return params, losses


def _smoke_recsys_batch(cfg: RecsysConfig, rng: np.random.Generator,
                        b: int, device) -> Dict[str, torch.Tensor]:
    """A smoke batch of ``cfg``'s family, drawn from ``rng`` in the
    reference's order, as tensors on ``device``."""
    def t(x):
        return torch.from_numpy(x).to(device)

    if cfg.kind in ("din", "bst"):
        s = cfg.seq_len
        return dict(
            user_id=t(rng.integers(0, 500, b).astype(np.int32)),
            context=t(rng.integers(0, 16, b).astype(np.int32)),
            hist_items=t(rng.integers(0, 1000, (b, s)).astype(np.int32)),
            hist_cates=t(rng.integers(0, 50, (b, s)).astype(np.int32)),
            target_item=t(rng.integers(0, 1000, b).astype(np.int32)),
            target_cate=t(rng.integers(0, 50, b).astype(np.int32)),
            label=t((rng.random(b) > 0.5).astype(np.float32)))
    if cfg.kind == "dlrm":
        out = dict(dense=t(rng.normal(size=(b, cfg.n_dense))
                           .astype(np.float32)),
                   label=t((rng.random(b) > 0.5).astype(np.float32)))
        for spec in cfg.tables:
            shp = (b, spec.bag_size) if spec.bag_size > 1 else (b,)
            out[spec.name] = t(rng.integers(0, spec.vocab, shp)
                               .astype(np.int32))
        return out
    bag = next(s.bag_size for s in cfg.tables if s.name == "user_hist")
    return dict(user_id=t(rng.integers(0, 500, b).astype(np.int32)),
                user_hist=t(rng.integers(0, 1000, (b, bag))
                            .astype(np.int32)),
                item_id=t(rng.integers(0, 1000, b).astype(np.int32)),
                item_cate=t(rng.integers(0, 50, b).astype(np.int32)))
