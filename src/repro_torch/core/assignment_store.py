"""Parameter-server analog: the item -> cluster assignment table and the
Appendix-B serving index built from it.

The store is a set of fixed-capacity tensors indexed by a multiplicative
hash of the item id; besides the cluster id it keeps the item's serving
payload (personality embedding + popularity bias, Eq. 11) so a serving
index can be built at any moment.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.freq_estimator import hash_ids, last_of_slot
from repro_torch.kernels import ref as kref


class AssignmentStore(NamedTuple):
    item_id: torch.Tensor    # (capacity,) int32 stored id (collision check)
    cluster: torch.Tensor    # (capacity,) int32 cluster id, -1 = empty
    item_emb: torch.Tensor   # (capacity, d) personality embedding v_emb
    item_bias: torch.Tensor  # (capacity,) popularity bias v_bias

    @property
    def capacity(self) -> int:
        return self.cluster.shape[0]


def init_store(capacity: int, dim: int, device=None) -> AssignmentStore:
    return AssignmentStore(
        item_id=torch.full((capacity,), -1, dtype=torch.int32,
                           device=device),
        cluster=torch.full((capacity,), -1, dtype=torch.int32,
                           device=device),
        item_emb=torch.zeros((capacity, dim), dtype=torch.float32,
                             device=device),
        item_bias=torch.zeros((capacity,), dtype=torch.float32,
                              device=device))


def write(store: AssignmentStore, ids: torch.Tensor, cluster: torch.Tensor,
          v_emb: torch.Tensor, v_bias: torch.Tensor,
          valid: torch.Tensor | None = None) -> AssignmentStore:
    """Real-time assignment write-back; returns a new store.

    Rows hashing to one slot resolve scatter-last, as in the reference.
    A CUDA ``index_put_`` with repeated indices writes in no fixed order,
    so only the last row of each slot is scattered.  Invalid rows re-write
    the slot's current content (and still count as the slot's last row).
    """
    slots = hash_ids(ids, store.capacity)
    rows = torch.arange(slots.shape[0], device=slots.device)
    keep = last_of_slot(slots, store.capacity)
    slots, rows = slots[keep], rows[keep]
    wid = ids.to(torch.int32)[rows]
    wcl = cluster.to(torch.int32)[rows]
    wemb = v_emb.to(torch.float32)[rows]
    wbias = v_bias.to(torch.float32)[rows]
    if valid is not None:
        v = valid[rows]
        wid = torch.where(v, wid, store.item_id[slots])
        wcl = torch.where(v, wcl, store.cluster[slots])
        wemb = torch.where(v[:, None], wemb, store.item_emb[slots])
        wbias = torch.where(v, wbias, store.item_bias[slots])
    out = AssignmentStore(*(t.clone() for t in store))
    out.item_id[slots] = wid
    out.cluster[slots] = wcl
    out.item_emb[slots] = wemb
    out.item_bias[slots] = wbias
    return out


def read_cluster(store: AssignmentStore, ids: torch.Tensor) -> torch.Tensor:
    """The cluster held in each id's slot (-1 where the slot is empty; a
    colliding id reads its slot's holder, as in the reference)."""
    return store.cluster[hash_ids(ids, store.capacity)]


def collision_rate(store: AssignmentStore, ids: torch.Tensor
                   ) -> torch.Tensor:
    """Fraction of ids whose slot currently holds a DIFFERENT id."""
    held = store.item_id[hash_ids(ids, store.capacity)]
    return ((held >= 0) & (held != ids.to(torch.int32))).to(
        torch.float32).mean()


class ServingIndex(NamedTuple):
    """Appendix-B layout: compact item list segmented by cluster.

    Items inside a cluster are sorted by descending popularity bias, the
    pre-sorted per-cluster list the Alg. 1 merge consumes.  A segment
    occupies ``[offsets[c], offsets[c+1])``; only its first ``counts[c]``
    slots are live, the rest is spare capacity holding the sentinel
    payload (id -1, bias 0).
    """
    item_ids: torch.Tensor   # (n,) int32, -1 in spare / sentinel slots
    item_emb: torch.Tensor   # (n, d)
    item_bias: torch.Tensor  # (n,) sorted desc within each live prefix
    cluster_of: torch.Tensor  # (n,) int32 (n_clusters in non-live slots)
    offsets: torch.Tensor    # (K+1,) int32 segment starts (incl. spare)
    counts: torch.Tensor     # (K,) int32 live items per segment

    @property
    def n_items(self) -> int:
        return self.item_ids.shape[0]


def build_serving_index(store: AssignmentStore, n_clusters: int,
                        spare_per_cluster: int = 0) -> ServingIndex:
    """Sort occupied slots by (cluster asc, bias desc) -> segments.

    Empty slots (cluster == -1) sort to the end of a sentinel segment and
    are excluded via the offsets table.  ``spare_per_cluster > 0`` spreads
    the segments apart so every cluster owns that many sentinel slots
    after its live prefix; serving reads only live prefixes.
    """
    occupied = store.cluster >= 0
    cl = torch.where(occupied, store.cluster,
                     torch.full_like(store.cluster, n_clusters))
    with torch.profiler.record_function("index_sort"):
        order = kref.index_sort_ref(cl, store.item_bias)
    cl_sorted = cl[order]
    offsets = torch.searchsorted(
        cl_sorted, torch.arange(n_clusters + 1, dtype=cl_sorted.dtype,
                                device=cl_sorted.device),
        side="left").to(torch.int32)
    live_counts = offsets[1:] - offsets[:-1]
    ids_s = store.item_id[order]
    emb_s = store.item_emb[order]
    bias_s = store.item_bias[order]
    if spare_per_cluster == 0:
        return ServingIndex(item_ids=ids_s, item_emb=emb_s,
                            item_bias=bias_s, cluster_of=cl_sorted,
                            offsets=offsets, counts=live_counts)
    # Spread segments: sorted position i moves to i + cluster_i * spare,
    # a strictly increasing map into a larger sentinel-filled buffer.
    n = ids_s.shape[0]
    spare = int(spare_per_cluster)
    total = n + n_clusters * spare
    dev = ids_s.device
    newpos = (torch.arange(n, device=dev)
              + torch.clamp(cl_sorted.long(), max=n_clusters) * spare)
    ids_sp = torch.full((total,), -1, dtype=torch.int32, device=dev)
    ids_sp[newpos] = ids_s
    bias_sp = torch.zeros((total,), dtype=bias_s.dtype, device=dev)
    bias_sp[newpos] = bias_s
    emb_sp = torch.zeros((total, emb_s.shape[1]), dtype=emb_s.dtype,
                         device=dev)
    emb_sp[newpos] = emb_s
    clof_sp = torch.full((total,), n_clusters, dtype=torch.int32,
                         device=dev)
    clof_sp[newpos] = cl_sorted
    offsets_sp = offsets + torch.arange(
        n_clusters + 1, dtype=torch.int32, device=dev) * spare
    return ServingIndex(item_ids=ids_sp, item_emb=emb_sp,
                        item_bias=bias_sp, cluster_of=clof_sp,
                        offsets=offsets_sp, counts=live_counts)
