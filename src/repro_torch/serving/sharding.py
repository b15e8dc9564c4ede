"""Cluster-major sharding of the Appendix-B serving index, served on one
device (logical shards).

``shard_serving_index`` partitions a ``ServingIndex`` CLUSTER-MAJOR over
``n_shards``: shard d owns clusters [d*Ks, (d+1)*Ks) and, because the
layout is cluster-sorted, the contiguous global item range
[item_base[d], item_base[d+1]).  Per-shard arrays are padded to a
power-of-two capacity bucket, and the constant sentinel tail (empty
store slots: id -1, bias 0, embedding 0) is synthesized at gather time
instead of being stored D times.  The partition is built on the index's
device with tensor ops.

``sharded_serve`` is the sharded two-step pipeline:

  1. per-shard indexing step: every shard ranks its own Ks codebook rows
     (``rank_codebook``, the ``cluster_rank`` kernel on a card) and emits
     its local top-n(C) cluster candidates;
  2. cross-shard cluster merge: a global top-C over the per-shard lists
     concatenated in shard order, sorted stably, so ties go to the lower
     global cluster id as in the single-device ranking;
  3. routed slab fetch from the owning shards (or, fused, flat addresses
     ``owner * cap + local`` clamped at the shard's ``cap - 1``);
  4. one Alg. 1 merge over the merged clusters, the candidate ids routed
     back to their shards, and the ranking step.

The shards are logical: one device holds them all, as in the reference
without a mesh.  A mesh over several cards and batch-parallel ranking
(``mesh``, ``rank_parallel``) are ROADMAP item A9's remaining work.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import merge_sort
from repro_torch.core.retriever import (IndexState, Params, fused_gather_rank,
                                        rank_codebook, serve_kernel,
                                        serve_stage_ranking, user_features,
                                        user_tower)

_MESH = ("a device mesh and rank_parallel=True are not ported yet: ROADMAP.md "
         "item A9 (sharded serving over several cards)")


class ShardedServingIndex(NamedTuple):
    """Cluster-major shards of one ServingIndex generation.

    Shard d holds its real items in [0, count_d) of the padded capacity;
    ``offsets[d]`` are shard-local segment starts of its Ks clusters;
    ``item_base[d]`` maps local back to global flat positions.
    """
    item_ids: torch.Tensor   # (D, cap) int32, -1 padded
    item_bias: torch.Tensor  # (D, cap) sorted desc within each segment
    item_emb: torch.Tensor   # (D, cap, d) personality embeddings, 0 padded
    offsets: torch.Tensor    # (D, Ks+1) int32 shard-local segment starts
    item_base: torch.Tensor  # (D,) int32 global pos of shard's first item
    n_real: torch.Tensor     # () int32: global end of the sharded region
    n_items: torch.Tensor    # () int32: global capacity incl. sentinels
    counts: torch.Tensor     # (D, Ks) int32 live items per local segment

    @property
    def n_shards(self) -> int:
        return self.item_ids.shape[0]

    @property
    def clusters_per_shard(self) -> int:
        return self.offsets.shape[1] - 1

    @property
    def capacity(self) -> int:
        return self.item_ids.shape[1]


def _bucket(n: int, quantum: int) -> int:
    """Smallest power-of-two multiple of quantum holding n items."""
    b = max(quantum, 1)
    while b < n:
        b *= 2
    return b


def shard_serving_index(index: astore.ServingIndex, n_clusters: int,
                        n_shards: int,
                        cap_quantum: int = 256) -> ShardedServingIndex:
    """Cluster-major partition of ``index`` on its own device."""
    if n_clusters % n_shards:
        raise ValueError(f"n_clusters={n_clusters} not divisible by "
                         f"n_shards={n_shards}")
    ks = n_clusters // n_shards
    offs = index.offsets.long()
    live = index.counts.long()
    dev = offs.device
    n = index.n_items
    # Every non-live slot (per-cluster spare capacity and the sentinel
    # tail of never-written store slots) must be constant, so that the
    # sharded gather can synthesize it.  A position is live when it lies
    # in the live prefix of the segment whose start is the last <= it.
    pos = torch.arange(n, device=dev)
    seg = torch.searchsorted(offs[:n_clusters], pos, right=True) - 1
    seg_c = seg.clamp(min=0)
    live_mask = ((seg >= 0) & (pos < offs[n_clusters])
                 & (pos - offs[seg_c] < live[seg_c]))
    dead = ~live_mask
    if not (bool((index.item_ids[dead] == -1).all())
            and bool((index.item_bias[dead] == 0.0).all())
            and bool((index.item_emb[dead] == 0.0).all())):
        raise ValueError("non-live slots are not constant "
                         "(-1 id, 0 bias, 0 emb)")

    shard = torch.arange(n_shards, device=dev)
    base = offs[shard * ks]
    region = offs[(shard + 1) * ks] - base
    cap = _bucket(int(region.max()), cap_quantum)
    # shard d's slot j holds global position base[d] + j for j < region[d]
    j = torch.arange(cap, device=dev)
    outside = j[None, :] >= region[:, None]                    # (D, cap)
    src = torch.clamp(base[:, None] + j[None, :], max=n - 1)
    s_ids = index.item_ids[src].masked_fill_(outside, -1)
    s_bias = index.item_bias[src].masked_fill_(outside, 0.0)
    s_emb = index.item_emb[src].masked_fill_(outside[..., None], 0.0)
    cols = shard[:, None] * ks + torch.arange(ks + 1, device=dev)[None, :]
    s_offs = (offs[cols] - base[:, None]).to(torch.int32)
    return ShardedServingIndex(
        item_ids=s_ids, item_bias=s_bias, item_emb=s_emb, offsets=s_offs,
        item_base=base.to(torch.int32),
        n_real=offs[n_clusters].to(torch.int32),
        n_items=torch.tensor(n, dtype=torch.int32, device=dev),
        counts=index.counts.reshape(n_shards, ks).clone())


def _no_mesh(mesh: Any, rank_parallel: bool) -> None:
    if mesh is not None or rank_parallel:
        raise NotImplementedError(_MESH)


def sharded_stage_rank(params: Params, state: IndexState, cfg: SVQConfig,
                       sidx: ShardedServingIndex,
                       batch: Dict[str, torch.Tensor], task: int = 0,
                       mesh: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """Stages 1-2: per-shard cluster ranking + cross-shard merge (the keys
    of ``retriever.serve_stage_rank``)."""
    _no_mesh(mesh, False)
    D = sidx.n_shards
    ks = sidx.clusters_per_shard
    C = cfg.clusters_per_query
    n_local = min(C, ks)
    user_feat, hist_emb = user_features(params, batch["user_id"],
                                        batch["hist"])
    u = user_tower(params, user_feat, task)

    # ---- stage 1: per-shard indexing step (local cluster ranking) ------
    e_all = state.vq.embeddings()
    vals_l, ids_l = [], []
    with record_function("cluster_rank"):
        for d in range(D):
            v, i = rank_codebook(e_all[d * ks:(d + 1) * ks], u, n_local)
            vals_l.append(v)
            ids_l.append(i + d * ks)
    # shard-order concat, sorted stably: ties go to the lower global
    # cluster id, as in the single-device ranking over the full codebook
    vals = torch.cat(vals_l, dim=1)
    gids = torch.cat(ids_l, dim=1)

    # ---- stage 2: cross-shard cluster merge ----------------------------
    top_scores, sel = torch.sort(vals, dim=1, descending=True, stable=True)
    top_scores = top_scores[:, :C].contiguous()
    top_clusters = torch.gather(gids, 1, sel[:, :C])            # (B, C)
    return dict(user_feat=user_feat, hist_emb=hist_emb, u=u,
                top_scores=top_scores, top_clusters=top_clusters)


def _route_candidate_ids(sidx: ShardedServingIndex, flat: torch.Tensor
                         ) -> torch.Tensor:
    """Route global flat positions back to their owning shard; sentinel
    tail positions (>= n_real) give the constant empty-slot id -1."""
    fowner, flocal = _owner_local(sidx, flat)
    return torch.where(flat >= sidx.n_real, -1, sidx.item_ids[fowner, flocal])


def _owner_local(sidx: ShardedServingIndex, flat: torch.Tensor):
    """Global flat positions -> (owning shard, local slot), clamped."""
    base = sidx.item_base.long()
    fowner = torch.clamp(torch.searchsorted(base, flat, right=True) - 1,
                         0, sidx.n_shards - 1)
    flocal = torch.clamp(flat - base[fowner], 0, sidx.capacity - 1)
    return fowner, flocal


def sharded_stage_merge(cfg: SVQConfig, sidx: ShardedServingIndex,
                        s1: Dict[str, torch.Tensor],
                        items_per_cluster: int = 256,
                        fused: bool = False,
                        mesh: Optional[Any] = None
                        ) -> Dict[str, torch.Tensor]:
    """Stages 3-4a: routed slab fetch + Alg. 1 merge + payload gather.

    ``fused=True`` merges over flattened shard-local addresses
    (``owner * cap + local``) whose per-lane clamp at ``owner * cap +
    cap - 1`` is the slab path's ``cap - 1`` clamp, and scores the
    candidates in the same kernel from the sharded embeddings.  Candidate
    ids are routed outside the kernel (searchsorted over ``item_base``),
    so the sentinel-tail synthesis is the slab path's.
    """
    _no_mesh(mesh, False)
    ks = sidx.clusters_per_shard
    cap = sidx.capacity
    L = items_per_cluster
    S = cfg.candidates_out
    top_scores = s1["top_scores"]
    top_clusters = s1["top_clusters"].long()

    # ---- stage 3: routed slab fetch from the owning shards -------------
    owner = top_clusters // ks                                   # (B, C)
    local_c = top_clusters % ks
    lstart = sidx.offsets[owner, local_c].long()
    counts = sidx.counts[owner, local_c]      # live prefix (tombstone-aware)
    lengths = torch.clamp(counts, max=L)
    ar = torch.arange(L, device=owner.device)
    n_last = sidx.n_items.long() - 1
    base = sidx.item_base.long()

    if fused:
        starts = owner * cap + lstart
        limits = owner * cap + (cap - 1)
        with record_function("fused_gather_rank"):
            pos, msort_scores, _, exact_scores = fused_gather_rank(
                s1["u"], top_scores, starts, lengths, limits,
                sidx.item_bias.reshape(-1), sidx.item_ids.reshape(-1),
                sidx.item_emb.reshape(-1, sidx.item_emb.shape[-1]),
                cfg.chunk_size, S, L)
        valid = pos >= 0
        p = torch.clamp(pos.long(), min=0)
        c_idx, i_idx = p // L, p % L
        owner_s = torch.gather(owner, 1, c_idx)
        lstart_s = torch.gather(lstart, 1, c_idx)
        flat = torch.minimum(base[owner_s] + lstart_s + i_idx, n_last)
        return dict(cand_ids=_route_candidate_ids(sidx, flat), valid=valid,
                    merge_scores=msort_scores, exact_scores=exact_scores)

    # global flat positions, identical (incl. the n-1 clamp) to the
    # single-device slab
    slab = torch.minimum(base[owner][..., None] + lstart[..., None] + ar,
                         n_last)
    # bias values from the owning shard; lanes past ``lengths`` are
    # padding in both paths and the merge masks them
    lslab = torch.clamp(lstart[..., None] + ar, max=cap - 1)
    bias = sidx.item_bias[owner[..., None], lslab]               # (B, C, L)

    # ---- stage 4a: Alg. 1 merge ----------------------------------------
    with record_function("merge_serve"):
        pos, msort_scores = serve_kernel(top_scores, bias, lengths,
                                         cfg.chunk_size, S)
    valid = pos >= 0
    flat = torch.gather(slab.reshape(slab.shape[0], -1), 1,
                        torch.clamp(pos.long(), min=0))         # (B, S)
    cand_ids = _route_candidate_ids(sidx, flat)
    # exact Eq. 11 candidate score from the sharded payload
    fowner, flocal = _owner_local(sidx, flat)
    exact_scores = torch.where(
        valid,
        torch.einsum("bsd,bd->bs",
                     sidx.item_emb[fowner, flocal].to(torch.float32),
                     s1["u"].to(torch.float32))
        + sidx.item_bias[fowner, flocal].to(torch.float32),
        merge_sort.NEG)
    return dict(cand_ids=cand_ids, valid=valid,
                merge_scores=msort_scores, exact_scores=exact_scores)


def sharded_stage_ranking(params: Params, cfg: SVQConfig,
                          s1: Dict[str, torch.Tensor],
                          s2: Dict[str, torch.Tensor], task: int = 0,
                          mesh: Optional[Any] = None,
                          rank_parallel: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Stage 4b: the ranking step over the merged candidates, replicated:
    the single-device ``serve_stage_ranking`` itself."""
    _no_mesh(mesh, rank_parallel)
    return serve_stage_ranking(params, cfg, s1, s2, task=task)


def sharded_serve(params: Params, state: IndexState, cfg: SVQConfig,
                  sidx: ShardedServingIndex, batch: Dict[str, Any],
                  items_per_cluster: int = 256, task: int = 0,
                  fused: bool = False, mesh: Optional[Any] = None,
                  rank_parallel: bool = False,
                  device=None) -> Dict[str, torch.Tensor]:
    """Sharded two-step retrieval: the outputs of ``retriever.serve`` on
    the unsharded index (rank -> merge -> ranking).

    ``batch`` holds ``user_id`` (B,) and ``hist`` (B, H), as tensors or
    numpy arrays, moved to ``device`` (``cuda`` unless named), where
    ``params``, ``state`` and ``sidx`` must already lie.
    """
    _no_mesh(mesh, rank_parallel)
    device = resolve_device(device)
    if sidx.item_ids.device.type != device.type:
        raise ValueError(f"sharded index lies on {sidx.item_ids.device}, "
                         f"sharded_serve runs on {device}")
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    s1 = sharded_stage_rank(params, state, cfg, sidx, tb, task=task)
    with record_function("stage_merge"):
        s2 = sharded_stage_merge(cfg, sidx, s1,
                                 items_per_cluster=items_per_cluster,
                                 fused=fused)
    return sharded_stage_ranking(params, cfg, s1, s2, task=task)
