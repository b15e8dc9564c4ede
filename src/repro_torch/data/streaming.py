"""Synthetic streaming recsys data with ground-truth affinity + drift
and the LM token stream (own numpy copy of the JAX package's
``data/streaming.py`` recsys stream and ``lm_batch``; the same seed gives
the same batches, bit for bit).

A latent topic model gives every experiment a measurable ground truth:

  - ``n_topics`` centers in a ``d_latent`` space; items cluster around a
    topic, users mix a few topics;
  - item popularity is Zipf(``zipf_a``);
  - TRUE affinity(u, i) = <u_lat, i_lat> + pop_bias_i;
  - ``drift(t)``: topic centers rotate slowly;
  - two streams, as in Fig. 1: the **impression stream** samples items
    ~ softmax(affinity) * popularity (labels = Bernoulli of a noisy
    affinity), and the **candidate stream** cycles all items uniformly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StreamConfig:
    n_items: int = 20_000
    n_users: int = 5_000
    n_topics: int = 32
    n_cates: int = 64
    d_latent: int = 16
    hist_len: int = 8
    zipf_a: float = 1.1
    label_noise: float = 1.0
    drift_rate: float = 0.0          # radians/step of topic rotation
    n_tasks: int = 1
    seed: int = 0


class RecsysStream:
    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        c = cfg
        self.topic_centers = rng.normal(size=(c.n_topics, c.d_latent))
        self.topic_centers /= np.linalg.norm(self.topic_centers, axis=1,
                                             keepdims=True)
        self.item_topic = rng.integers(0, c.n_topics, c.n_items)
        self.item_local = rng.normal(size=(c.n_items, c.d_latent)) * 0.3
        self.item_cate = (self.item_topic * (c.n_cates // c.n_topics)
                          + rng.integers(0, max(c.n_cates // c.n_topics, 1),
                                         c.n_items)).astype(np.int32)
        # users mix 2 topics
        ut = rng.integers(0, c.n_topics, (c.n_users, 2))
        w = rng.uniform(0.3, 0.7, (c.n_users, 1))
        self.user_lat = (w * self.topic_centers[ut[:, 0]]
                         + (1 - w) * self.topic_centers[ut[:, 1]]
                         + rng.normal(size=(c.n_users, c.d_latent)) * 0.1)
        # Zipf popularity over a random permutation of items
        ranks = rng.permutation(c.n_items) + 1
        pop = ranks ** (-c.zipf_a)
        self.popularity = pop / pop.sum()
        self.pop_bias = np.log(self.popularity * c.n_items + 1e-9) * 0.3
        self.step = 0
        # per-user rolling history
        self.user_hist = rng.integers(
            0, c.n_items, (c.n_users, c.hist_len)).astype(np.int32)
        self._drift_plane: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if c.drift_rate > 0:
            a = rng.normal(size=c.d_latent)
            b = rng.normal(size=c.d_latent)
            a /= np.linalg.norm(a)
            b -= a * (a @ b)
            b /= np.linalg.norm(b)
            self._drift_plane = (a, b)

    # -- latent geometry -----------------------------------------------------
    def item_latent(self, ids: np.ndarray | None = None,
                    at_step: Optional[int] = None) -> np.ndarray:
        ids = np.arange(self.cfg.n_items) if ids is None else ids
        t = self.step if at_step is None else at_step
        centers = self.topic_centers
        if self._drift_plane is not None and t > 0:
            a, b = self._drift_plane
            theta = self.cfg.drift_rate * t
            # rotate centers in the (a, b) plane
            ca = centers @ a
            cb = centers @ b
            perp = centers - np.outer(ca, a) - np.outer(cb, b)
            centers = (perp
                       + np.outer(ca * np.cos(theta) - cb * np.sin(theta), a)
                       + np.outer(ca * np.sin(theta) + cb * np.cos(theta), b))
        return centers[self.item_topic[ids]] + self.item_local[ids]

    def true_affinity(self, user_ids: np.ndarray,
                      item_ids: np.ndarray | None = None) -> np.ndarray:
        """(B, N) ground-truth scores at the current step."""
        il = self.item_latent(item_ids)
        return self.user_lat[user_ids] @ il.T + self.pop_bias[
            np.arange(self.cfg.n_items) if item_ids is None else item_ids]

    def true_topk(self, user_ids: np.ndarray, k: int) -> np.ndarray:
        aff = self.true_affinity(user_ids)
        return np.argsort(-aff, axis=1)[:, :k]

    # -- streams --------------------------------------------------------------
    def impression_batch(self, batch: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        self.step += 1
        users = self.rng.integers(0, c.n_users, batch)
        # candidate pool per impression: popularity sample, user picks best
        pool = self.rng.choice(c.n_items, size=(batch, 8),
                               p=self.popularity)
        il = self.item_latent(pool.reshape(-1)).reshape(batch, 8, -1)
        aff = np.einsum("bd,bkd->bk", self.user_lat[users], il) \
            + self.pop_bias[pool]
        pick = aff.argmax(axis=1)
        items = pool[np.arange(batch), pick]
        true = aff[np.arange(batch), pick]
        labels = np.empty((batch, c.n_tasks), np.float32)
        for t in range(c.n_tasks):
            noise = self.rng.normal(size=batch) * c.label_noise
            labels[:, t] = (true + noise
                            > np.median(true)).astype(np.float32)
        hist = self.user_hist[users].copy()
        # roll positive impressions into history
        pos = labels[:, 0] > 0
        hu = users[pos]
        self.user_hist[hu] = np.roll(self.user_hist[hu], 1, axis=1)
        self.user_hist[hu, 0] = items[pos]
        return dict(
            user_id=users.astype(np.int32),
            hist=hist.astype(np.int32),
            item_id=items.astype(np.int32),
            item_cate=self.item_cate[items],
            labels=labels,
        )

    def candidate_batch(self, batch: int) -> Dict[str, np.ndarray]:
        """Uniform pass over the corpus (the paper's candidate stream)."""
        start = (self.step * batch) % self.cfg.n_items
        ids = (np.arange(batch) + start) % self.cfg.n_items
        return dict(item_id=ids.astype(np.int32),
                    item_cate=self.item_cate[ids])


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def lm_batch(rng: np.random.Generator, batch: int, seq: int,
             vocab: int, zipf_a: float = 1.2) -> Dict[str, np.ndarray]:
    """Zipf-distributed synthetic token stream -> {tokens, labels}."""
    ranks = np.arange(1, vocab + 1)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])
