"""Retrieval service: the two-step serving pipeline of Fig. 1 / §3.4.

``RetrievalService`` holds the trained retriever params, the live
IndexState and the ServingIndex built from its store, and serves request
batches: cluster ranking (Eq. 11) -> k-way chunked merge sort (Alg. 1) ->
ranking-step model -> final ordered candidates, returned as numpy.
``fused=True`` serves through the slab-free merge + gather + rank stage;
``n_shards=D`` partitions the index cluster-major into D logical shards
on the service's device (``sharding.py``).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import retriever
from repro_torch.serving import sharding
from repro_torch.utils.tree import to_device as _to

_LIFECYCLE = ("{} is not ported yet: ROADMAP.md item A8 (the service "
              "lifecycle: deltas, tracing)")


class RetrievalService:
    """Serves batches from ``params`` + ``index_state`` on ``device``
    (``cuda`` unless named; ``device="cpu"`` runs the plain versions)."""

    def __init__(self, cfg: SVQConfig, params, index_state,
                 items_per_cluster: int = 256, fused: bool = False,
                 n_shards: Optional[int] = None, mesh=None,
                 delta_spare: int = 0, tracer=None,
                 rank_parallel: bool = False, device=None):
        if mesh is not None or rank_parallel:
            raise NotImplementedError(sharding._MESH)
        if delta_spare:
            raise NotImplementedError(_LIFECYCLE.format("delta_spare"))
        if tracer is not None:
            raise NotImplementedError(_LIFECYCLE.format("tracer"))
        self.cfg = cfg
        self.items_per_cluster = items_per_cluster
        self.fused = fused
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._params = _to(params, self.device)
        self._index_state = _to(index_state, self.device)
        self._index = self._build_index()

    def _build_index(self):
        """Snapshot the live store -> fresh Appendix-B layout (+shards)."""
        with self._lock:
            state = self._index_state
        index = astore.build_serving_index(state.store, self.cfg.n_clusters)
        if self.n_shards:
            index = sharding.shard_serving_index(index, self.cfg.n_clusters,
                                                 self.n_shards)
        return index

    def swap_model(self, params, index_state) -> None:
        """Atomic model dump swap (the §3.1 cadence)."""
        params = _to(params, self.device)
        index_state = _to(index_state, self.device)
        with self._lock:
            self._params = params
            self._index_state = index_state

    def rebuild_index(self):
        """Synchronous candidate scan -> the next serving index."""
        index = self._build_index()
        with self._lock:
            self._index = index
        return index

    @property
    def index(self):
        """The serving index: a ``ServingIndex``, or with ``n_shards`` a
        ``sharding.ShardedServingIndex``."""
        return self._index

    def serve_batch(self, batch: Dict[str, np.ndarray], task: int = 0
                    ) -> Dict[str, np.ndarray]:
        """Serve one request batch (``user_id`` (B,), ``hist`` (B, H))."""
        with self._lock:
            params, state, index = (self._params, self._index_state,
                                    self._index)
        serve = sharding.sharded_serve if self.n_shards else retriever.serve
        with torch.no_grad():
            out = serve(params, state, self.cfg, index, batch,
                        items_per_cluster=self.items_per_cluster, task=task,
                        fused=self.fused, device=self.device)
        return {k: v.cpu().numpy() for k, v in out.items()}
