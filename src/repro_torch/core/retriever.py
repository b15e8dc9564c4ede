"""The streaming VQ retriever: indexing step + ranking step (paper Fig. 1).

Functional model: ``params`` (gradient-trained, a dict of tensors laid
out like the reference's pytree) plus ``IndexState`` (codebook and PS
tables, updated in the same train step: index immediacy, §3.1).

``train_step`` consumes one impression-stream batch and optionally one
candidate-stream batch; both update the item -> cluster assignment store
in the step that computes the assignment.  ``serve`` runs the two-step
retrieval: cluster ranking (u.Q(v_emb)), the k-way merge-sort candidate
generation (Alg. 1), and the ranking-step model that orders the final
set.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import EmbeddingSpec, SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import freq_estimator as freq
from repro_torch.core import losses, merge_sort, ranking, vq
from repro_torch.kernels import ops as kops
from repro_torch.models.dense import init_mlp, mlp, select, stack
from repro_torch.models.recsys import embedding as emb
from repro_torch.utils import tree

Params = Dict[str, Any]

_FUSED = ("fused=True is not ported yet: ROADMAP.md item A5 (the fused "
          "merge+gather+rank serve path, fused_gather_rank)")


class IndexState(NamedTuple):
    """Non-gradient state: codebook, PS tables, step counter."""
    vq: vq.VQState
    store: astore.AssignmentStore
    freq: freq.FreqState
    step: torch.Tensor


def _table_specs(cfg: SVQConfig) -> Tuple[EmbeddingSpec, ...]:
    return (
        EmbeddingSpec("user_id", cfg.n_users, cfg.user_embed_dim),
        EmbeddingSpec("item_id", cfg.n_items, cfg.item_embed_dim),
        EmbeddingSpec("item_cate", 4096, cfg.item_embed_dim),
    )


def d_feature_dims(cfg: SVQConfig) -> Tuple[int, int]:
    d_user_in = cfg.user_embed_dim + cfg.item_embed_dim
    d_item_in = 2 * cfg.item_embed_dim
    return d_user_in, d_item_in


def init(gen: torch.Generator, cfg: SVQConfig, device=None
         ) -> Tuple[Params, IndexState]:
    """Random params and an empty index state on ``device``.

    ``gen`` draws every weight and must lie on ``device`` (a
    ``torch.Generator(device)``).  The numbers differ from the reference's
    ``jax.random`` init of the same seed; parity runs go through the
    bridge instead.
    """
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, init on {device}")
    d_user_in, d_item_in = d_feature_dims(cfg)
    params: Params = {
        "tables": emb.init_tables(gen, _table_specs(cfg)),
        # item tower outputs personality embedding + popularity bias
        "item_tower": init_mlp(gen, d_item_in,
                               cfg.item_tower[:-1] + (cfg.embed_dim + 1,)),
        # one user tower per task (stacked)
        "user_towers": stack([
            init_mlp(gen, d_user_in, cfg.user_tower[:-1] + (cfg.embed_dim,))
            for _ in range(cfg.n_tasks)]),
        "rank": ranking.init_ranking(gen, cfg, d_user_in, d_item_in),
    }
    state = IndexState(
        vq=vq.init_vq(gen, cfg.n_clusters, cfg.embed_dim),
        store=astore.init_store(cfg.n_items, cfg.embed_dim, device=device),
        freq=freq.init_freq(cfg.n_items, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))
    return params, state


# ---------------------------------------------------------------------------
# Feature extraction (embeddings shared by indexing + ranking steps)
# ---------------------------------------------------------------------------

def user_features(params: Params, user_id: torch.Tensor, hist: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (user_feat (B, d_u_in), hist_emb (B, H, d_e))."""
    uid = emb.lookup(params["tables"]["user_id"], user_id)
    hist_emb = emb.lookup(params["tables"]["item_id"], hist)
    hist_pool = torch.mean(hist_emb, dim=-2)
    return torch.cat([uid, hist_pool], -1), hist_emb


def item_features(params: Params, item_id: torch.Tensor,
                  item_cate: torch.Tensor) -> torch.Tensor:
    iid = emb.lookup(params["tables"]["item_id"], item_id)
    cat = emb.lookup(params["tables"]["item_cate"], item_cate)
    return torch.cat([iid, cat], -1)


def user_tower(params: Params, user_feat: torch.Tensor,
               task: int) -> torch.Tensor:
    """Task ``task``'s user tower -> u (B, d)."""
    return mlp(select(params["user_towers"], task), user_feat)


def index_forward(params: Params, cfg: SVQConfig, user_feat: torch.Tensor,
                  item_feat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indexing-step towers -> (u (P,B,d), v_emb (B,d), v_bias (B,))."""
    u = torch.stack([user_tower(params, user_feat, t)
                     for t in range(cfg.n_tasks)])
    v_all = mlp(params["item_tower"], item_feat)
    return u, v_all[..., :-1], v_all[..., -1]


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def _loss(p: Params, state: IndexState, cfg: SVQConfig,
          batch: Dict[str, torch.Tensor], logq: Optional[torch.Tensor]):
    """-> (total loss, assignment, v_emb, v_bias, per-term metrics)."""
    user_feat, _ = user_features(p, batch["user_id"], batch["hist"])
    item_feat = item_features(p, batch["item_id"], batch["item_cate"])
    u, v_emb, v_bias = index_forward(p, cfg, user_feat, item_feat)

    # Eq. 10 assignment (no gradient through the assignment itself)
    with record_function("vq_assign"):
        assignment = vq.assign(state.vq, v_emb.detach(), cfg.disturbance_s)
    e_st = vq.quantize(state.vq, v_emb, assignment)

    labels = batch["labels"]                     # (B, P) rewards
    ldt = torch.bfloat16 if cfg.logits_dtype == "bfloat16" else None
    total = 0.0
    per_task = {}
    for t in range(cfg.n_tasks):
        pos = labels[:, t] > 0
        with record_function("inbatch_softmax"):
            la = losses.l_aux(u[t], v_emb, v_bias, logq, valid=pos,
                              dtype=ldt)
            li = losses.l_ind(u[t], v_emb, e_st, v_bias, logq, valid=pos,
                              dtype=ldt)
        total = total + la + li
        per_task[f"l_aux_{t}"] = la
        per_task[f"l_ind_{t}"] = li
    if cfg.use_l_sim:   # §3.2 ablation: vanilla VQ-VAE commitment
        lsim = losses.l_sim(v_emb,
                            state.vq.embeddings()[assignment.long()])
        total = total + lsim
        per_task["l_sim"] = lsim

    # ranking step (shared embeddings, own towers)
    rlogits = ranking.ranking_scores(p["rank"], cfg, user_feat, item_feat)
    lrank = 0.0
    for t in range(cfg.n_tasks):
        lr = losses.bce_logits(rlogits[t],
                               (labels[:, t] > 0).to(rlogits.dtype))
        lrank = lrank + lr
        per_task[f"l_rank_{t}"] = lr
    total = total + lrank
    return total, assignment, v_emb, v_bias, per_task


def train_step(params: Params, state: IndexState, cfg: SVQConfig,
               batch: Dict[str, Any],
               cand_batch: Optional[Dict[str, Any]] = None, device=None):
    """One impression-stream step -> (grads, new_state, metrics).

    The caller owns the optimizer (train/loop.py); ``grads`` has the tree
    layout of ``params``.  ``batch``: user_id (B,), hist (B, H), item_id
    (B,), item_cate (B,), labels (B, P) rewards in [0, inf), as tensors
    or numpy arrays, moved to ``device`` (``cuda`` unless named), where
    ``params`` and ``state`` must already lie.
    """
    device = resolve_device(device)
    if state.vq.w.device.type != device.type:
        raise ValueError(f"index state lies on {state.vq.w.device}, "
                         f"train_step runs on {device}")
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    step = state.step + 1

    # -- streaming frequency estimation (also = popularity for Eq. 7) ----
    new_freq, delta = freq.update(state.freq, batch["item_id"], step)
    logq = freq.log_q(delta) if cfg.logq_debias else None

    # the grads are taken over detached copies of the param leaves
    paths = tree.flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in paths]
    p = tree.unflatten(params, leaves)
    with torch.enable_grad():
        loss, assignment, v_emb, v_bias, per_task = _loss(p, state, cfg,
                                                          batch, logq)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree.unflatten(params, [
        torch.zeros_like(leaf) if g is None else g
        for leaf, g in zip(leaves, grads)])

    with torch.no_grad():
        v_emb, v_bias, loss = v_emb.detach(), v_bias.detach(), loss.detach()
        per_task = {k: t.detach() for k, t in per_task.items()}
        # -- EMA codebook update, popularity/reward weighted (Eq. 7-9) ----
        multi = cfg.n_tasks > 1
        impressed = torch.max(batch["labels"], dim=-1).values >= 0
        weight = vq.popularity_weight(
            delta, cfg.beta, rewards=batch["labels"] if multi else None,
            eta=cfg.eta if multi else None, valid=impressed)
        with record_function("ema_segment_sum"):
            new_vq = vq.ema_update(state.vq, v_emb, assignment, weight,
                                   cfg.ema_alpha)

        # -- real-time PS write-back (index immediacy) --------------------
        new_store = astore.write(state.store, batch["item_id"], assignment,
                                 v_emb, v_bias)

        # -- candidate stream: forward-only assignment refresh (§3.1) -----
        if cand_batch is not None:
            cand = {k: torch.as_tensor(v, device=device)
                    for k, v in cand_batch.items()}
            c_feat = item_features(params, cand["item_id"],
                                   cand["item_cate"])
            cv_all = mlp(params["item_tower"], c_feat)
            cv_emb, cv_bias = cv_all[..., :-1], cv_all[..., -1]
            with record_function("vq_assign"):
                c_assign = vq.assign(new_vq, cv_emb, cfg.disturbance_s)
            new_store = astore.write(new_store, cand["item_id"], c_assign,
                                     cv_emb, cv_bias)

        new_state = IndexState(vq=new_vq, store=new_store, freq=new_freq,
                               step=step)
        metrics = dict(loss=loss, **per_task,
                       **vq.cluster_usage_stats(new_vq, assignment))
    return grads, new_state, metrics


# ---------------------------------------------------------------------------
# Serving (indexing step -> merge sort -> ranking step)
# ---------------------------------------------------------------------------

def rank_codebook(e: torch.Tensor, u: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n of ``u @ e.T`` per query: the ``cluster_rank`` kernel on a
    CUDA tensor, its plain version on a CPU one."""
    return kops.cluster_rank(u, e, n)


def rank_clusters(state: IndexState, u: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 5/11 cluster ranking: top-n clusters by u.e_k (per query)."""
    return rank_codebook(state.vq.embeddings(), u, n)


def serve_kernel(top_scores: torch.Tensor, bias: torch.Tensor,
                 lengths: torch.Tensor, chunk: int, target: int,
                 exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched Alg. 1 merge stage: (B, C) cluster scores, (B, C, L)
    pre-sorted bias slabs, (B, C) lengths -> ((B, target) flat positions,
    (B, target) merge scores)."""
    return kops.merge_serve(top_scores, bias, lengths.to(torch.int32),
                            chunk, target, exact)


def serve_stage_rank(params: Params, state: IndexState, cfg: SVQConfig,
                     batch: Dict[str, torch.Tensor], task: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """Stage 1 of serve: user tower + Eq. 11 cluster ranking."""
    user_feat, hist_emb = user_features(params, batch["user_id"],
                                        batch["hist"])
    u = user_tower(params, user_feat, task)
    with record_function("cluster_rank"):
        top_scores, top_clusters = rank_clusters(state, u,
                                                 cfg.clusters_per_query)
    return dict(user_feat=user_feat, hist_emb=hist_emb, u=u,
                top_scores=top_scores, top_clusters=top_clusters)


def serve_stage_merge(cfg: SVQConfig, index: astore.ServingIndex,
                      s1: Dict[str, torch.Tensor],
                      items_per_cluster: int = 256,
                      fused: bool = False) -> Dict[str, torch.Tensor]:
    """Stage 2 of serve: slab fetch + Alg. 1 merge -> candidate ids."""
    if fused:
        raise NotImplementedError(_FUSED)
    top_scores = s1["top_scores"]
    top_clusters = s1["top_clusters"].long()
    starts = index.offsets[top_clusters].long()               # (B, C)
    counts = index.counts[top_clusters]       # live prefix (tombstone-aware)
    L = items_per_cluster
    lengths = torch.clamp(counts, max=L)
    S = cfg.candidates_out
    ar = torch.arange(L, device=starts.device)
    slab = torch.clamp(starts[..., None] + ar, max=index.n_items - 1)
    bias = index.item_bias[slab]                              # (B, C, L)

    # ---- Alg. 1 merge sort over (cluster personality + item bias) ------
    with record_function("merge_serve"):
        pos, msort_scores = serve_kernel(top_scores, bias, lengths,
                                         cfg.chunk_size, S)
    valid = pos >= 0
    flat = torch.gather(slab.reshape(slab.shape[0], -1), 1,
                        torch.clamp(pos.long(), min=0))       # (B, S)
    cand_ids = index.item_ids[flat]
    # exact Eq. 11 candidate score u.v + bias from the index payload
    exact_scores = torch.where(
        valid,
        torch.einsum("bsd,bd->bs", index.item_emb[flat].to(torch.float32),
                     s1["u"].to(torch.float32))
        + index.item_bias[flat].to(torch.float32),
        merge_sort.NEG)
    return dict(cand_ids=cand_ids, valid=valid,
                merge_scores=msort_scores, exact_scores=exact_scores)


def serve_stage_ranking(params: Params, cfg: SVQConfig,
                        s1: Dict[str, torch.Tensor],
                        s2: Dict[str, torch.Tensor],
                        task: int = 0) -> Dict[str, torch.Tensor]:
    """Stage 3 of serve: ranking step over the compact candidate set."""
    user_feat = s1["user_feat"]
    cand_ids, valid = s2["cand_ids"], s2["valid"]
    item_feat = item_features(params, cand_ids, torch.zeros_like(cand_ids))
    rscores = ranking.ranking_scores(params["rank"], cfg, user_feat,
                                     item_feat)[task]
    rscores = torch.where(valid, rscores, merge_sort.NEG)
    order = torch.argsort(-rscores, dim=-1, stable=True)
    return dict(
        item_ids=torch.gather(cand_ids, 1, order),
        scores=torch.gather(rscores, 1, order),
        merge_scores=s2["merge_scores"],
        exact_scores=s2["exact_scores"],
        index_ids=cand_ids,
        valid=torch.gather(valid, 1, order))


def serve(params: Params, state: IndexState, cfg: SVQConfig,
          index: astore.ServingIndex, batch: Dict[str, Any],
          items_per_cluster: int = 256, task: int = 0,
          fused: bool = False, device=None) -> Dict[str, torch.Tensor]:
    """Full retrieval for a user batch -> final candidate ids + scores.

    ``batch`` holds ``user_id`` (B,) and ``hist`` (B, H), as tensors or
    numpy arrays; they are moved to ``device`` (``cuda`` unless named),
    where ``params``, ``state`` and ``index`` must already lie.
    """
    if fused:
        raise NotImplementedError(_FUSED)
    device = resolve_device(device)
    if state.vq.w.device.type != device.type:
        raise ValueError(f"index state lies on {state.vq.w.device}, "
                         f"serve runs on {device}")
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    s1 = serve_stage_rank(params, state, cfg, tb, task=task)
    s2 = serve_stage_merge(cfg, index, s1,
                           items_per_cluster=items_per_cluster)
    return serve_stage_ranking(params, cfg, s1, s2, task=task)
