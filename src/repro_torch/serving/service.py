"""Retrieval service: the two-step serving pipeline of Fig. 1 / §3.4.

``RetrievalService`` holds the trained retriever params, the live
IndexState and the ServingIndex built from its store, and serves request
batches: cluster ranking (Eq. 11) -> k-way chunked merge sort (Alg. 1) ->
ranking-step model -> final ordered candidates, returned as numpy.
``fused=True`` serves through the slab-free merge + gather + rank stage;
``n_shards=D`` partitions the index cluster-major into D logical shards
on the service's device (``sharding.py``).  ``enable_probes`` attaches
the shadow recall probes (``obs/quality.py``): sampled serves are
re-scored off the hot path against the exact MIPS oracle over the live
store, which launches the ``topk_dot`` kernel on the card.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.baselines import brute_force
from repro_torch.configs.base import SVQConfig
from repro_torch.core import assignment_store as astore
from repro_torch.core import merge_sort, retriever
from repro_torch.obs import quality as quality_lib
from repro_torch.obs import registry as registry_lib
from repro_torch.obs import sampling as sampling_lib
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
        # the index generation: 0 for the first build, one more for each
        # rebuild (the reference's double-buffered epoch waits for A8)
        self._generation = 0
        self.prober: Optional[quality_lib.QualityProber] = None
        self._probe_k = 0

    def _user_emb(self, params, batch: Dict[str, np.ndarray],
                  task: int) -> torch.Tensor:
        """(B, d) user-tower embedding on the service's device."""
        tb = {k: torch.as_tensor(v, device=self.device)
              for k, v in batch.items()}
        with torch.no_grad():
            user_feat, _ = retriever.user_features(params, tb["user_id"],
                                                   tb["hist"])
            return retriever.user_tower(params, user_feat, task)

    def user_embedding(self, batch: Dict[str, np.ndarray],
                       task: int = 0) -> np.ndarray:
        """(B, dim) user-tower embedding for a request batch: the query
        the shadow-probe oracle scores the corpus with."""
        with self._lock:
            params = self._params
        return self._user_emb(params, batch, task).cpu().numpy()

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
            self._generation += 1
        return index

    @property
    def index(self):
        """The serving index: a ``ServingIndex``, or with ``n_shards`` a
        ``sharding.ShardedServingIndex``."""
        return self._index

    def serve_batch(self, batch: Dict[str, np.ndarray], task: int = 0,
                    n_valid: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Serve one request batch (``user_id`` (B,), ``hist`` (B, H)).

        ``n_valid`` says how many leading rows are real (a padding caller's
        count); a shadow probe of this batch scores only those rows.
        """
        with self._lock:
            params, state, index, generation = (
                self._params, self._index_state, self._index,
                self._generation)
        serve = sharding.sharded_serve if self.n_shards else retriever.serve
        with torch.no_grad():
            out = serve(params, state, self.cfg, index, batch,
                        items_per_cluster=self.items_per_cluster, task=task,
                        fused=self.fused, device=self.device)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        prober = self.prober
        if prober is not None and prober.should_sample():
            # merge-order view keeps ids, validity and exact scores
            # aligned in ONE order (exact_scores carries NEG sentinels
            # exactly where the candidate slot is invalid)
            exact = out["exact_scores"]
            prober.submit(quality_lib.ProbeJob(
                batch={k: np.asarray(v) for k, v in batch.items()},
                served_ids=out["index_ids"],
                served_valid=exact > merge_sort.NEG / 2,
                served_exact=exact, task=task, generation=generation,
                t_serve=time.monotonic(), n_valid=n_valid))
        return out

    # -- shadow quality probes (obs/quality.py) -----------------------------
    def _probe_oracle(self, job: quality_lib.ProbeJob
                      ) -> quality_lib.OracleAnswer:
        """Exact re-scoring of one sampled serve (probe worker thread).

        Params and store are read under ONE lock acquisition, so the
        oracle never scores against a half-swapped model.  The corpus is
        the CURRENT store, so an item the store holds but the index
        cannot retrieve is a probe miss.  Empty slots carry zero
        embeddings; the NEG bias keeps them below every live slot, and
        among themselves they tie and come in ascending slot order.
        """
        with self._lock:
            params = self._params
            store = self._index_state.store
        u = self._user_emb(params, job.batch, job.task)
        with torch.no_grad():
            bias = torch.where(store.cluster >= 0, store.item_bias,
                               merge_sort.NEG)
            vals, slots = brute_force.mips_topk(u, store.item_emb, bias,
                                                self._probe_k)
            exact_ids = store.item_id[slots.long()].cpu().numpy()
            served = np.where(job.served_valid, job.served_ids, 0)
            clof = astore.read_cluster(
                store, torch.as_tensor(served, device=self.device))
        clof = np.where(job.served_valid, clof.cpu().numpy(), -1)
        shard_of, n_shards = None, 0
        if self.n_shards:
            per = max(self.cfg.n_clusters // self.n_shards, 1)
            shard_of = np.where(clof >= 0, clof // per, -1)
            n_shards = self.n_shards
        return quality_lib.OracleAnswer(
            exact_ids=exact_ids, exact_scores=vals.cpu().numpy(),
            cluster_of=clof, n_clusters=self.cfg.n_clusters,
            shard_of=shard_of, n_shards=n_shards)

    def enable_probes(self, k: int = 20, sample_every: int = 8,
                      window: int = 512, max_queue: int = 64,
                      sampler: Optional[sampling_lib.CounterSampler] = None,
                      registry: Optional[
                          registry_lib.MetricRegistry] = None,
                      namespace: str = "svq"
                      ) -> quality_lib.QualityProber:
        """Attach the shadow-probe pipeline to this service.

        Sampled ``serve_batch`` calls are re-scored against the exact
        MIPS oracle over the live store, off the hot path.  Pass
        ``registry=`` to export the probe gauges.
        """
        if self.prober is not None:
            raise RuntimeError("probes already enabled")
        self._probe_k = k
        self.prober = quality_lib.QualityProber(
            self._probe_oracle, k=k, sample_every=sample_every,
            sampler=sampler, window=window, max_queue=max_queue)
        if registry is not None:
            self.prober.register(registry, namespace=namespace)
        return self.prober

    def disable_probes(self) -> None:
        """Stop the probe worker (idempotent)."""
        prober, self.prober = self.prober, None
        if prober is not None:
            prober.close()
