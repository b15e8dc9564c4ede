"""PyTorch port vs the JAX reference: the fused serve path.

On the CPU the port's ``fused_gather_rank`` wrapper runs its plain
version, the batched loop of pops, which is held to the reference's lax
version ``kernels/ref.fused_gather_rank_ref`` (the reference's Pallas
kernel does not trace on this JAX: ROADMAP C1).  ``merge_serve_ds`` is
held to the reference's Pallas kernel in interpret mode.  The fused
stage and service are held to the reference's fused path with
``use_kernel=False``.  Contract: pos, merge_scores and cand_ids bitwise
where the reference's stage-1 outputs are fed in; exact_scores within
rtol 1e-5 / atol 1e-5 (another summation order); end to end, candidate
ids equal and scores close (the GEMMs of the two libraries round
differently: C4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SVQConfig as JSVQConfig
from repro.core import assignment_store as j_astore
from repro.core import merge_sort as j_merge_sort
from repro.core import retriever as j_retriever
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.serving import RetrievalService as JRetrievalService

from repro_torch import bridge
from repro_torch.configs.base import SVQConfig
from repro_torch.core import merge_sort as t_merge_sort
from repro_torch.core import retriever as t_retriever
from repro_torch.kernels import ops as t_ops
from repro_torch.serving.service import RetrievalService

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("pos", "merge_scores", "cand_ids", "exact_scores")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _assert_fused_equal(want, got, tag=""):
    """pos, merge_scores, cand_ids bitwise (dtype too); exact close."""
    for name, a, b in zip(NAMES, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, name)
        if name == "exact_scores":
            np.testing.assert_allclose(a, b, err_msg=f"{tag}:{name}", **TOL)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"{tag}:{name}")


def _slab_case(rng, b, c, l, d, zeros=False, nan_tail=False):
    """The layout of tests/test_fused_serve.py: C slabs of L items in a
    flat array (cluster c at c*L), a short tail, limits N-1.  Returns the
    arrays and the bias without NaN."""
    tail = int(rng.integers(1, 5))
    n = c * l + tail
    cs = rng.normal(size=(b, c)).astype(np.float32)
    if zeros:
        # heavy ±0.0 merge-score ties: IEEE equality must collapse them
        slab = -np.sort(-rng.integers(-1, 2, (c, l)).astype(np.float32),
                        axis=1)
        zmask = slab == 0.0
        slab[zmask] = np.where(rng.random(int(zmask.sum())) < 0.5, 0.0, -0.0)
        cs[:] = 0.0
    else:
        slab = -np.sort(-rng.normal(size=(c, l)).astype(np.float32), axis=1)
    starts = np.broadcast_to(np.arange(c, dtype=np.int32) * l, (b, c)).copy()
    lengths = np.broadcast_to(rng.integers(0, l + 1, (c,)).astype(np.int32),
                              (b, c)).copy()
    bias = np.concatenate([slab.reshape(-1),
                           rng.normal(size=(tail,)).astype(np.float32)])
    clean = bias.copy()
    if nan_tail:
        for ci in range(c):
            bias[ci * l + lengths[0, ci]:(ci + 1) * l] = np.nan
    limits = np.full((b, c), n - 1, np.int32)
    ids = rng.permutation(n).astype(np.int32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.normal(size=(b, d)).astype(np.float32)
    return (u, cs, starts, lengths, limits, bias, ids, emb), clean


def _sharded_case(rng, b, c, l, d, shards, cap):
    """Flat (shards * cap) layout; each lane clamps at its shard's last
    slot, and many lists run past the end of their shard."""
    n = shards * cap
    owner = rng.integers(0, shards, size=(b, c))
    local = rng.integers(cap // 2, cap + 1, size=(b, c))
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, c)).astype(np.float32),
            (owner * cap + local).astype(np.int32),
            rng.integers(0, l + 1, size=(b, c)).astype(np.int32),
            (owner * cap + cap - 1).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.permutation(n).astype(np.int32),
            rng.normal(size=(n, d)).astype(np.float32))


def _both(arrays, chunk, target, l):
    """-> (reference lax version, port through its CPU wrapper)."""
    want = j_ref.fused_gather_rank_ref(*map(jnp.asarray, arrays), chunk,
                                       target, l)
    got = t_ops.fused_gather_rank(*map(torch.from_numpy, arrays), chunk,
                                  target, l)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("b,c,l,d,chunk,target,zeros", [
    (2, 6, 10, 8, 4, 25, False),
    (3, 13, 17, 12, 3, 70, False),         # non-pow2 everything
    (1, 5, 3, 4, 8, 9, False),             # chunk > every list
    (2, 9, 12, 8, 4, 30, True),            # ±0.0 tie storm
])
def test_fused_gather_rank_plain_matches_reference(rng, b, c, l, d, chunk,
                                                   target, zeros):
    arrays, _ = _slab_case(rng, b, c, l, d, zeros=zeros)
    t_ops.reset_launches()
    want, got = _both(arrays, chunk, target, l)
    _assert_fused_equal(want, got)
    assert t_ops.LAUNCHES["fused_gather_rank"] == 0
    # the merge decisions are those of the slab merge over the same lists
    slab = np.minimum(arrays[2][..., None] + np.arange(l), arrays[5].size - 1)
    pos, sc = t_ops.merge_serve(torch.from_numpy(arrays[1]),
                                torch.from_numpy(arrays[5][slab]),
                                torch.from_numpy(arrays[3]), chunk, target)
    np.testing.assert_array_equal(pos.numpy(), got[0])
    np.testing.assert_array_equal(_bits(sc.numpy()), _bits(got[1]))


@pytest.mark.parametrize("exact", [True, False])
def test_fused_gather_rank_plain_inexact_budget(rng, exact):
    arrays, _ = _slab_case(rng, 3, 11, 6, 8)
    want = j_ref.fused_gather_rank_ref(*map(jnp.asarray, arrays), 4, 40, 6,
                                       exact)
    got = t_merge_sort.fused_gather_rank(*map(torch.from_numpy, arrays), 4,
                                         40, 6, exact)
    _assert_fused_equal(want, [x.numpy() for x in got], f"exact={exact}")


def test_fused_gather_rank_plain_nan_dead_tail(rng):
    """NaN in every lane past a cluster's length changes nothing, in the
    port and in the reference."""
    arrays, clean = _slab_case(rng, 2, 7, 9, 8, nan_tail=True)
    assert np.isnan(arrays[5]).any()
    want_nan, got_nan = _both(arrays, 4, 30, 9)
    _assert_fused_equal(want_nan, got_nan, "nan")
    clean_arrays = arrays[:5] + (clean,) + arrays[6:]
    _, got_clean = _both(clean_arrays, 4, 30, 9)
    _assert_fused_equal(got_clean, got_nan, "nan vs clean")


@pytest.mark.parametrize("shards,cap", [(4, 16), (3, 7)])
def test_fused_gather_rank_plain_sharded_limits(rng, shards, cap):
    """Per-lane limits at each shard's last slot, with lists that run past
    the end of their shard."""
    arrays = _sharded_case(rng, 4, 10, 12, 8, shards, cap)
    assert (arrays[2] + arrays[3] > arrays[4] + 1).any()
    want, got = _both(arrays, 4, 50, 12)
    _assert_fused_equal(want, got)


def test_fused_gather_rank_plain_n_below_chunk(rng):
    """N < chunk: the reference's lax version reads clamped addresses,
    as the port does (the Pallas wrapper pads to chunk instead)."""
    b, c, d, n = 3, 2, 4, 3
    arrays = (rng.normal(size=(b, d)).astype(np.float32),
              rng.normal(size=(b, c)).astype(np.float32),
              np.zeros((b, c), np.int32), np.full((b, c), n, np.int32),
              np.full((b, c), n - 1, np.int32),
              -np.sort(-rng.normal(size=n)).astype(np.float32),
              np.arange(n, dtype=np.int32),
              rng.normal(size=(n, d)).astype(np.float32))
    want, got = _both(arrays, 8, 10, 5)
    _assert_fused_equal(want, got)


@pytest.mark.parametrize("b,c,l,chunk,target", [
    (3, 6, 10, 4, 25), (2, 13, 17, 3, 70), (1, 5, 3, 8, 9),
    (4, 7, 32, 16, 100),              # chunk wider than some lists
    (2, 6, 2, 8, 12),                 # L < chunk: the reference pads L
])
def test_merge_serve_ds_plain_matches_pallas(rng, b, c, l, chunk, target):
    cs = rng.normal(size=(b, c)).astype(np.float32)
    bl = -np.sort(-rng.normal(size=(b, c, l)).astype(np.float32), axis=-1)
    ln = rng.integers(0, l + 1, size=(b, c)).astype(np.int32)
    pos_j, sc_j = j_ops.merge_serve_ds(*map(jnp.asarray, (cs, bl, ln)),
                                       chunk, target)
    t_ops.reset_launches()
    pos_t, sc_t = t_ops.merge_serve_ds(*map(torch.from_numpy, (cs, bl, ln)),
                                       chunk, target)
    assert t_ops.LAUNCHES["merge_serve_ds"] == 0
    np.testing.assert_array_equal(np.asarray(pos_j), pos_t.numpy())
    np.testing.assert_array_equal(_bits(sc_j), _bits(sc_t.numpy()))


def test_merge_serve_ds_plain_tied_scores():
    """Integer-valued biases force heavy cross-cluster ties."""
    for seed in range(3):
        r = np.random.default_rng(seed)
        cs = r.integers(-1, 2, size=(2, 9)).astype(np.float32)
        bl = -np.sort(-r.integers(-2, 3, size=(2, 9, 12))
                      .astype(np.float32), axis=-1)
        ln = r.integers(0, 13, size=(2, 9)).astype(np.int32)
        pos_j, sc_j = j_ops.merge_serve_ds(*map(jnp.asarray, (cs, bl, ln)),
                                           4, 40)
        pos_t, sc_t = t_ops.merge_serve_ds(
            *map(torch.from_numpy, (cs, bl, ln)), 4, 40)
        np.testing.assert_array_equal(np.asarray(pos_j), pos_t.numpy())
        np.testing.assert_array_equal(_bits(sc_j), _bits(sc_t.numpy()))


@pytest.mark.parametrize("c,l,target,ties", [(6, 10, 25, False),
                                             (9, 12, 100, True),
                                             (5, 3, 9, False)])
def test_full_sort_topk_matches_reference(rng, c, l, target, ties):
    b = 3
    if ties:
        cs = rng.integers(-1, 2, size=(b, c)).astype(np.float32)
        bl = rng.integers(-2, 3, size=(b, c, l)).astype(np.float32)
    else:
        cs = rng.normal(size=(b, c)).astype(np.float32)
        bl = rng.normal(size=(b, c, l)).astype(np.float32)
    ln = rng.integers(0, l + 1, size=(b, c)).astype(np.int32)
    pos_t, sc_t = t_merge_sort.full_sort_topk(
        *map(torch.from_numpy, (cs, bl, ln)), target)
    for q in range(b):
        pos_j, sc_j = j_merge_sort.full_sort_topk(
            *map(jnp.asarray, (cs[q], bl[q], ln[q])), target)
        np.testing.assert_array_equal(np.asarray(pos_j), pos_t[q].numpy())
        np.testing.assert_array_equal(_bits(sc_j), _bits(sc_t[q].numpy()))


# ---------------------------------------------------------------------------
# the fused stage 2, serve and the service, from a trained reference
# ---------------------------------------------------------------------------

def trained_reference():
    """The reference trained 3 steps at the config of
    tests/test_fused_serve.py (24 clusters: 1, 4 and 8 shards divide
    them), bridged into the port."""
    cfg = JSVQConfig(n_users=500, n_items=800, n_clusters=24, embed_dim=16,
                     user_embed_dim=8, item_embed_dim=8,
                     user_tower=(32, 16), item_tower=(32, 17),
                     clusters_per_query=6, candidates_out=48, chunk_size=8)
    params, state = j_retriever.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = dict(
            user_id=jnp.asarray(rng.integers(0, cfg.n_users, 64)),
            hist=jnp.asarray(rng.integers(0, cfg.n_items, (64, 5))),
            item_id=jnp.asarray(rng.integers(0, cfg.n_items, 64)),
            item_cate=jnp.asarray(rng.integers(0, 4096, 64)),
            labels=jnp.asarray(rng.random((64, cfg.n_tasks))
                               .astype(np.float32)))
        _, state, _ = j_retriever.train_step(params, state, cfg, batch)
    batch = dict(user_id=rng.integers(0, cfg.n_users, 9).astype(np.int32),
                 hist=rng.integers(0, cfg.n_items, (9, 5)).astype(np.int32))
    return dict(cfg=cfg, params=params, state=state, batch=batch,
                tcfg=SVQConfig(**dataclasses.asdict(cfg)),
                tparams=bridge.params_to_torch(jax.device_get(params)),
                tstate=bridge.index_state_to_torch(jax.device_get(state)))


@pytest.fixture(scope="module")
def trained():
    return trained_reference()


def _stage1(t):
    j1 = j_retriever.serve_stage_rank(
        t["params"], t["state"], t["cfg"],
        {k: jnp.asarray(v) for k, v in t["batch"].items()})
    s1 = {k: bridge.tensor(jax.device_get(j1[k]))
          for k in ("u", "top_scores", "top_clusters")}
    return j1, s1


@pytest.mark.parametrize("spare", [0, 3])
def test_stage_merge_fused_bitwise_given_reference_ranking(trained, spare):
    """Fed the reference's stage-1 outputs, the port's fused stage 2 gives
    the reference's fused cand_ids, validity and merge scores bitwise, and
    so does the port's unfused stage."""
    t = trained
    j1, s1 = _stage1(t)
    jidx = j_astore.build_serving_index(t["state"].store,
                                        t["cfg"].n_clusters,
                                        spare_per_cluster=spare)
    tidx = bridge.serving_index_to_torch(jax.device_get(jidx))
    j2 = j_retriever.serve_stage_merge(t["cfg"], jidx, j1,
                                       items_per_cluster=32, fused=True)
    assert int(np.asarray(j2["valid"]).sum()) > 0
    for fused in (True, False):
        t2 = t_retriever.serve_stage_merge(t["tcfg"], tidx, s1,
                                           items_per_cluster=32, fused=fused)
        for k in ("cand_ids", "valid", "merge_scores"):
            a, b = np.asarray(j2[k]), t2[k].numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"fused={fused}:{k}")
        np.testing.assert_allclose(np.asarray(j2["exact_scores"]),
                                   t2["exact_scores"].numpy(), **TOL)


def test_serve_fused_equals_unfused_in_the_port(trained):
    t = trained
    idx = bridge.serving_index_to_torch(jax.device_get(
        j_astore.build_serving_index(t["state"].store, t["cfg"].n_clusters)))
    outs = [t_retriever.serve(t["tparams"], t["tstate"], t["tcfg"], idx,
                              t["batch"], items_per_cluster=32, fused=f,
                              device="cpu") for f in (False, True)]
    assert int(outs[0]["valid"].sum()) > 0
    for k in outs[0]:
        if k == "exact_scores":
            torch.testing.assert_close(outs[1][k], outs[0][k], **TOL)
        else:
            assert torch.equal(outs[1][k], outs[0][k]), k


def test_service_fused_matches_reference(trained):
    """RetrievalService(fused=True) on the CPU against the reference's
    fused service: candidate ids equal, scores close."""
    t = trained
    ref = JRetrievalService(t["cfg"], t["params"], t["state"],
                            items_per_cluster=32, fused=True
                            ).serve_batch(t["batch"])
    t_ops.reset_launches()
    got = RetrievalService(t["tcfg"], t["tparams"], t["tstate"],
                           items_per_cluster=32, fused=True, device="cpu"
                           ).serve_batch(t["batch"])
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].shape == got[k].shape and ref[k].dtype == got[k].dtype
    assert ref["valid"].sum() > 0
    for k in ("index_ids", "item_ids", "valid"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    for k in ("scores", "merge_scores", "exact_scores"):
        np.testing.assert_allclose(ref[k], got[k], err_msg=k, **TOL)
    assert all(n == 0 for n in t_ops.LAUNCHES.values())
