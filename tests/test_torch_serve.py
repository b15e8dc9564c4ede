"""PyTorch port vs the JAX reference: the serve slice end to end.

The reference is trained for 20 steps at the smoke config (the fixture
of tests/test_sharded_serving.py); its params and state go through the
numpy bridge into the port, which serves on the CPU (plain versions of
the kernels).  The reference serves with ``use_kernel=True`` (its Pallas
kernels in interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import assignment_store as j_astore
from repro.core import retriever as j_retriever
from repro.data import RecsysStream, StreamConfig
from repro.launch.train import train_svq
from repro.serving import RetrievalService as JRetrievalService

from repro_torch import bridge
from repro_torch.configs import svq as t_svq
from repro_torch.core import retriever as t_retriever
from repro_torch.kernels import ops as t_ops
from repro_torch.serving.service import RetrievalService

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg():
    return get_smoke("svq").with_(n_clusters=64, n_items=2000,
                                  n_users=500, embed_dim=16,
                                  clusters_per_query=16,
                                  candidates_out=128)


def _port_cfg(cfg):
    """The port's own SVQConfig with the reference config's values."""
    import dataclasses
    return t_svq.SVQConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg()
    stream = RecsysStream(StreamConfig(n_items=cfg.n_items,
                                       n_users=cfg.n_users,
                                       hist_len=cfg.user_hist_len))
    params, index, _ = train_svq(cfg, stream, n_steps=20, batch=128)
    users = np.arange(24) % cfg.n_users
    batch = dict(user_id=users.astype(np.int32),
                 hist=stream.user_hist[users].astype(np.int32))
    np_params, np_index = jax.device_get(params), jax.device_get(index)
    return dict(cfg=cfg, params=params, index=index, batch=batch,
                tcfg=_port_cfg(cfg),
                tparams=bridge.params_to_torch(np_params),
                tstate=bridge.index_state_to_torch(np_index))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_copy_matches_reference():
    import dataclasses
    from repro.configs import get_config
    assert dataclasses.asdict(t_svq.CONFIG) == dataclasses.asdict(
        get_config("svq"))
    assert dataclasses.asdict(t_svq.smoke()) == dataclasses.asdict(
        get_smoke("svq"))


def test_features_and_towers_match_reference(trained):
    t = trained
    jb, tb = _jbatch(t["batch"]), _tbatch(t["batch"])
    jf, jh = j_retriever.user_features(t["params"], jb["user_id"],
                                       jb["hist"])
    tf, th = t_retriever.user_features(t["tparams"], tb["user_id"],
                                       tb["hist"])
    np.testing.assert_allclose(np.asarray(jf), tf.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    items = np.arange(50, dtype=np.int32) * 37
    cate = (items % 4096).astype(np.int32)
    jif = j_retriever.item_features(t["params"], jnp.asarray(items),
                                    jnp.asarray(cate))
    tif = t_retriever.item_features(t["tparams"], torch.from_numpy(items),
                                    torch.from_numpy(cate))
    np.testing.assert_array_equal(np.asarray(jif), tif.numpy())
    ju, jv, jvb = j_retriever.index_forward(t["params"], t["cfg"], jf, jif)
    tu, tv, tvb = t_retriever.index_forward(t["tparams"], t["tcfg"],
                                            bridge.tensor(jax.device_get(jf)),
                                            tif)
    for a, b in ((ju, tu), (jv, tv), (jvb, tvb)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def test_stage_rank_matches_reference(trained):
    t = trained
    j1 = j_retriever.serve_stage_rank(t["params"], t["index"], t["cfg"],
                                      _jbatch(t["batch"]), use_kernel=True)
    t1 = t_retriever.serve_stage_rank(t["tparams"], t["tstate"], t["tcfg"],
                                      _tbatch(t["batch"]))
    np.testing.assert_allclose(np.asarray(j1["u"]), t1["u"].numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(j1["top_clusters"]),
                                  t1["top_clusters"].numpy())
    np.testing.assert_allclose(np.asarray(j1["top_scores"]),
                               t1["top_scores"].numpy(), **TOL)


@pytest.mark.parametrize("spare", [0, 5])
def test_stage_merge_bitwise_given_reference_ranking(trained, spare):
    """Fed the reference's own stage-1 outputs, stage 2's ids, validity
    and merge scores are bitwise; exact scores allclose (dot order)."""
    t = trained
    cfg = t["cfg"]
    j1 = j_retriever.serve_stage_rank(t["params"], t["index"], cfg,
                                      _jbatch(t["batch"]), use_kernel=True)
    jidx = j_astore.build_serving_index(t["index"].store, cfg.n_clusters,
                                        use_kernel=True,
                                        spare_per_cluster=spare)
    j2 = j_retriever.serve_stage_merge(cfg, jidx, j1, use_kernel=True)
    tidx = bridge.serving_index_to_torch(jax.device_get(jidx))
    s1 = {k: bridge.tensor(jax.device_get(j1[k]))
          for k in ("u", "top_scores", "top_clusters")}
    t2 = t_retriever.serve_stage_merge(t["tcfg"], tidx, s1)
    for k in ("cand_ids", "valid", "merge_scores"):
        ref, got = np.asarray(j2[k]), t2[k].numpy()
        assert ref.dtype == got.dtype, k
        if ref.dtype == np.float32:
            ref, got = ref.view(np.uint32), got.view(np.uint32)
        np.testing.assert_array_equal(ref, got, err_msg=k)
    np.testing.assert_allclose(np.asarray(j2["exact_scores"]),
                               t2["exact_scores"].numpy(), **TOL)


@pytest.fixture(scope="module")
def served(trained):
    t = trained
    jsvc = JRetrievalService(t["cfg"], t["params"], t["index"],
                             use_kernel=True)
    tsvc = RetrievalService(t["tcfg"], t["tparams"], t["tstate"],
                            device="cpu")
    return jsvc, tsvc, jsvc.serve_batch(t["batch"]), \
        tsvc.serve_batch(t["batch"])


def test_service_index_bitwise(trained, served):
    jsvc, tsvc, _, _ = served
    ref = jax.device_get(jsvc.index_generation.index)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(tsvc.index, f).numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_service_serve_batch_end_to_end(served):
    _, _, ref, got = served
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].shape == got[k].shape, k
        assert ref[k].dtype == got[k].dtype, k
    np.testing.assert_array_equal(ref["index_ids"], got["index_ids"])
    np.testing.assert_array_equal(ref["item_ids"], got["item_ids"])
    np.testing.assert_array_equal(ref["valid"], got["valid"])
    for k in ("scores", "merge_scores", "exact_scores"):
        np.testing.assert_allclose(ref[k], got[k], err_msg=k, **TOL)


def test_service_rebuild_after_swap(trained):
    """A swapped-in store shows up after rebuild_index, equal to the
    reference's index of the same store."""
    t = trained
    cfg = t["cfg"]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.n_items, size=64).astype(np.int32)
    cl = rng.integers(0, cfg.n_clusters, size=64).astype(np.int32)
    emb = rng.normal(size=(64, cfg.embed_dim)).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    jstore = j_astore.write(t["index"].store, *map(jnp.asarray,
                                                   (ids, cl, emb, bias)))
    jstate = t["index"]._replace(store=jstore)
    tsvc = RetrievalService(t["tcfg"], t["tparams"], t["tstate"],
                            device="cpu")
    tsvc.swap_model(t["tparams"],
                    bridge.index_state_to_torch(jax.device_get(jstate)))
    got = tsvc.rebuild_index()
    ref = jax.device_get(j_astore.build_serving_index(jstore,
                                                      cfg.n_clusters))
    for f in ref._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)).view(np.uint32)
            if getattr(ref, f).dtype == np.float32
            else np.asarray(getattr(ref, f)),
            getattr(got, f).numpy().view(np.uint32)
            if getattr(got, f).dtype == torch.float32
            else getattr(got, f).numpy(), err_msg=f)
    out = tsvc.serve_batch(t["batch"])
    assert out["item_ids"].shape == (24, cfg.candidates_out)


def test_port_init_matches_reference_layout():
    cfg = _cfg()
    jp, js = jax.eval_shape(lambda k: j_retriever.init(k, cfg),
                            jax.random.PRNGKey(0))
    tp, ts = t_retriever.init(torch.Generator().manual_seed(0),
                              _port_cfg(cfg), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
    assert tuple(js.vq.w.shape) == tuple(ts.vq.w.shape)
    assert tuple(js.store.item_emb.shape) == tuple(ts.store.item_emb.shape)
    assert tuple(js.freq.interval.shape) == tuple(ts.freq.interval.shape)


def test_port_alone_serves_at_smoke_config():
    """The port's own init, a store written through its item tower, and a
    served batch: full, in-range, rank-ordered candidates."""
    cfg = t_svq.smoke()
    gen = torch.Generator().manual_seed(0)
    params, state = t_retriever.init(gen, cfg, device="cpu")
    ids = torch.arange(cfg.n_items)
    cate = torch.randint(0, 4096, (cfg.n_items,), generator=gen)
    _, v_emb, v_bias = t_retriever.index_forward(
        params, cfg, torch.zeros(1, 2 * cfg.item_embed_dim),
        t_retriever.item_features(params, ids, cate))
    clusters = torch.randint(0, cfg.n_clusters, (cfg.n_items,),
                             generator=gen)
    from repro_torch.core import assignment_store as t_astore
    state = state._replace(store=t_astore.write(state.store, ids, clusters,
                                                v_emb, v_bias))
    t_ops.reset_launches()
    svc = RetrievalService(cfg, params, state, device="cpu")
    users = np.arange(16, dtype=np.int32)
    hist = np.random.default_rng(0).integers(
        0, cfg.n_items, size=(16, cfg.user_hist_len)).astype(np.int32)
    out = svc.serve_batch(dict(user_id=users, hist=hist))
    assert out["item_ids"].shape == (16, cfg.candidates_out)
    assert out["valid"].all()
    assert ((out["item_ids"] >= 0) & (out["item_ids"] < cfg.n_items)).all()
    assert (np.diff(out["scores"], axis=1) <= 0).all()
    assert t_ops.LAUNCHES == {name: 0 for name in (
        "cluster_rank", "merge_serve", "vq_assign", "inbatch_softmax",
        "inbatch_softmax_bwd", "ema_segment_sum")}


def test_unported_options_raise(trained):
    t = trained
    with pytest.raises(NotImplementedError, match="A5"):
        RetrievalService(t["tcfg"], t["tparams"], t["tstate"], fused=True,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        t_retriever.init(torch.Generator().manual_seed(0),
                         t["tcfg"].with_(ranking="complicated"),
                         device="cpu")


def test_entry_points_need_a_card_unless_cpu_named(trained, monkeypatch):
    t = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalService(t["tcfg"], t["tparams"], t["tstate"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_retriever.init(torch.Generator().manual_seed(0), t["tcfg"])
