"""Retrieval service: the two-step serving pipeline of Fig. 1 / §3.4.

``RetrievalService`` holds the trained retriever params, the live
IndexState and the ServingIndex built from its store, and serves request
batches: cluster ranking (Eq. 11) -> k-way chunked merge sort (Alg. 1) ->
ranking-step model -> final ordered candidates, returned as numpy.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import retriever
from repro_torch.utils.tree import to_device as _to


class RetrievalService:
    """Serves batches from ``params`` + ``index_state`` on ``device``
    (``cuda`` unless named; ``device="cpu"`` runs the plain versions)."""

    def __init__(self, cfg: SVQConfig, params, index_state,
                 items_per_cluster: int = 256, fused: bool = False,
                 device=None):
        if fused:
            raise NotImplementedError(retriever._FUSED)
        self.cfg = cfg
        self.items_per_cluster = items_per_cluster
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._params = _to(params, self.device)
        self._index_state = _to(index_state, self.device)
        self._index = self._build_index()

    def _build_index(self) -> astore.ServingIndex:
        """Snapshot the live store -> fresh Appendix-B layout."""
        with self._lock:
            state = self._index_state
        return astore.build_serving_index(state.store, self.cfg.n_clusters)

    def swap_model(self, params, index_state) -> None:
        """Atomic model dump swap (the §3.1 cadence)."""
        params = _to(params, self.device)
        index_state = _to(index_state, self.device)
        with self._lock:
            self._params = params
            self._index_state = index_state

    def rebuild_index(self) -> astore.ServingIndex:
        """Synchronous candidate scan -> the next serving index."""
        index = self._build_index()
        with self._lock:
            self._index = index
        return index

    @property
    def index(self) -> astore.ServingIndex:
        return self._index

    def serve_batch(self, batch: Dict[str, np.ndarray], task: int = 0
                    ) -> Dict[str, np.ndarray]:
        """Serve one request batch (``user_id`` (B,), ``hist`` (B, H))."""
        with self._lock:
            params, state, index = (self._params, self._index_state,
                                    self._index)
        with torch.no_grad():
            out = retriever.serve(params, state, self.cfg, index, batch,
                                  items_per_cluster=self.items_per_cluster,
                                  task=task, device=self.device)
        return {k: v.cpu().numpy() for k, v in out.items()}
