"""Streaming VQ codebook state.  Serving reads only the codebook
(Eq. 9); assignment and the EMA update are ported with the train step."""
from __future__ import annotations

from typing import NamedTuple

import torch


class VQState(NamedTuple):
    w: torch.Tensor          # (K, d) EMA numerator
    c: torch.Tensor          # (K,)  EMA counter

    @property
    def n_clusters(self) -> int:
        return self.w.shape[0]

    @property
    def dim(self) -> int:
        return self.w.shape[1]

    def embeddings(self) -> torch.Tensor:
        """Eq. 9: e_k = w_k / c_k."""
        return self.w / torch.clamp(self.c, min=1e-6)[:, None]


def init_vq(gen: torch.Generator, n_clusters: int, dim: int) -> VQState:
    w = torch.randn((n_clusters, dim), generator=gen, device=gen.device) * 0.1
    c = torch.ones((n_clusters,), device=gen.device)
    return VQState(w=w, c=c)
