"""PyTorch port vs the JAX reference: the retrieval-quality path.

The exact MIPS oracle (``topk_dot`` and ``mips_topk``), the ordering
contract (``order_desc_stable``, ``search_topk``), ``recall_at_k``, the
store queries (``read_cluster``, ``collision_rate``), ``eval_svq_recall``
and ``train_svq``'s signature (ROADMAP.md C8).  The same numpy inputs go
to both packages; the reference's trained params and state come through
the numpy bridge.  The port runs on the CPU, where ``topk_dot`` runs its
plain version; the reference's ``ops.topk_dot`` runs its Pallas kernel in
interpret mode.  Scores may differ in the last bits (fp32 sums in another
order), so values are held within rtol 1e-5 and ids equal; on
integer-valued inputs every sum is exact and both are bitwise.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import brute_force as j_bf
from repro.configs import get_smoke
from repro.core import assignment_store as j_astore
from repro.data import RecsysStream as JStream
from repro.data import StreamConfig as JStreamConfig
from repro.kernels import ops as j_ops
from repro.launch import train as j_train

from repro_torch import bridge
from repro_torch.baselines import brute_force as t_bf
from repro_torch.configs import svq as t_svq
from repro_torch.core import assignment_store as t_astore
from repro_torch.data.streaming import RecsysStream, StreamConfig
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import train as t_train
from repro_torch.train import LoopConfig

TOL = dict(rtol=1e-5)
NEG = -1e30


def _topk_inputs(g, n, d, integer=False, b=None):
    shape_u = (d,) if b is None else (b, d)
    if integer:
        u = g.integers(-2, 3, size=shape_u).astype(np.float32)
        items = g.integers(-1, 2, size=(n, d)).astype(np.float32)
        bias = g.integers(-2, 3, size=n).astype(np.float32)
    else:
        u = g.normal(size=shape_u).astype(np.float32)
        items = g.normal(size=(n, d)).astype(np.float32)
        bias = g.normal(size=n).astype(np.float32)
    return u, items, bias


def _assert_same(got, want, bitwise):
    (gv, gi), (wv, wi) = got, want
    gv, gi = gv.numpy(), gi.numpy()
    wv, wi = np.asarray(wv), np.asarray(wi)
    assert gi.dtype == wi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    if bitwise:
        np.testing.assert_array_equal(gv.view(np.uint32), wv.view(np.uint32))
    else:
        np.testing.assert_allclose(gv, wv, **TOL)


# ---------------------------------------------------------------------------
# topk_dot (B9) against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,bn", [
    (1000, 32, 8, 256), (5000, 64, 50, 512), (777, 16, 16, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_dot_matches_reference_kernel(n, d, k, bn, dtype):
    g = np.random.default_rng(n + k)
    u, items, bias = _topk_inputs(g, n, d)
    jargs = [jnp.asarray(x).astype(dtype) for x in (u, items, bias)]
    targs = [bridge.tensor(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in jargs]
    want = j_ops.topk_dot(*jargs, k, block_n=bn)
    got = t_ops.topk_dot(*targs, k, block_n=bn)
    assert got[0].dtype == torch.float32 and got[0].shape == (k,)
    _assert_same(got, want, bitwise=False)


@pytest.mark.parametrize("n,d,k,bn", [(1000, 32, 8, 256), (777, 16, 16, 128),
                                      (600, 8, 600, 1024)])
def test_topk_dot_ties_bitwise(n, d, k, bn):
    """Integer-valued inputs with ties within and across blocks (item 0
    repeated at spread slots): values and ids bitwise, ties to the lower
    index, k == N included."""
    g = np.random.default_rng(n)
    u, items, bias = _topk_inputs(g, n, d, integer=True)
    at = g.choice(n, size=n // 10, replace=False)
    items[at], bias[at] = items[0], bias[0]
    want = j_ops.topk_dot(*map(jnp.asarray, (u, items, bias)), k,
                          block_n=bn)
    got = t_ops.topk_dot(*map(bridge.tensor, (u, items, bias)), k,
                         block_n=bn)
    _assert_same(got, want, bitwise=True)


def test_topk_dot_does_not_depend_on_block_n_and_refuses_k_above_n():
    g = np.random.default_rng(3)
    args = [bridge.tensor(x) for x in _topk_inputs(g, 300, 8)]
    want = t_ops.topk_dot(*args, 20)
    for bn in (128, 256, None):
        got = t_ops.topk_dot(*args, 20, block_n=bn)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
    with pytest.raises(ValueError):
        t_ops.topk_dot(*args, 301)


# ---------------------------------------------------------------------------
# the exact oracle and the ordering contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bias", "no_bias", "masked", "few_live",
                                  "integer"])
def test_mips_topk_matches_reference(case):
    """With and without bias, with NEG-masked empty slots (the probe
    oracle's corpus), with fewer live slots than k (the masked slots tie
    at NEG and come in ascending slot order), and on integer inputs."""
    g = np.random.default_rng(7)
    n, d, b, k = 500, 16, 8, 20
    u, items, bias = _topk_inputs(g, n, d, integer=case == "integer", b=b)
    if case in ("masked", "few_live"):
        dead = g.choice(n, size=n - (10 if case == "few_live" else 200),
                        replace=False)
        items[dead], bias[dead] = 0.0, NEG
    jb = None if case == "no_bias" else jnp.asarray(bias)
    tb = None if case == "no_bias" else bridge.tensor(bias)
    want = j_bf.mips_topk(jnp.asarray(u), jnp.asarray(items), jb, k)
    got = t_bf.mips_topk(bridge.tensor(u), bridge.tensor(items), tb, k)
    assert got[0].shape == (b, k)
    _assert_same(got, want, bitwise=case in ("integer", "few_live"))


def test_order_desc_stable_bitwise(rng):
    scores = rng.integers(0, 4, 64).astype(np.float64)       # many ties
    ids = rng.permutation(64).astype(np.int64)
    np.testing.assert_array_equal(t_bf.order_desc_stable(scores, ids),
                                  j_bf.order_desc_stable(scores, ids))


@pytest.mark.parametrize("with_bias", [False, True])
def test_search_topk_bitwise_with_a_permuted_corpus(rng, with_bias):
    d, n, k = 8, 50, 10
    items = np.round(rng.normal(size=(n, d)))
    u = np.round(rng.normal(size=(3, d)))          # ties at the boundary
    bias = np.round(rng.normal(size=n)) if with_bias else None
    ids = np.arange(n, dtype=np.int64)
    perm = rng.permutation(n)
    for args in ((items, bias, ids),
                 (items[perm], None if bias is None else bias[perm],
                  ids[perm])):
        w_ids, w_scores = j_bf.search_topk(u, args[0], args[1], k,
                                           ids=args[2])
        g_ids, g_scores = t_bf.search_topk(u, args[0], args[1], k,
                                           ids=args[2])
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_array_equal(g_scores.view(np.uint64),
                                      w_scores.view(np.uint64))


def test_recall_at_k_equal(rng):
    retrieved = rng.integers(0, 40, size=(6, 12))
    truth = rng.integers(0, 40, size=(6, 9))
    assert t_bf.recall_at_k(retrieved, truth) == \
        j_bf.recall_at_k(retrieved, truth)
    assert t_bf.recall_at_k(np.zeros((0, 3)), np.zeros((0, 3))) == \
        j_bf.recall_at_k(np.zeros((0, 3)), np.zeros((0, 3)))


# ---------------------------------------------------------------------------
# trained state: store queries and eval_svq_recall
# ---------------------------------------------------------------------------

def _cfg():
    """The smoke config of tests/test_retriever_system.py."""
    return get_smoke("svq").with_(n_clusters=64, n_items=2000,
                                  n_users=500, embed_dim=16,
                                  clusters_per_query=16,
                                  candidates_out=128)


def _stream_cfg(cfg, cls):
    return cls(n_items=cfg.n_items, n_users=cfg.n_users,
               hist_len=cfg.user_hist_len)


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg()
    params, index, _ = j_train.train_svq(cfg, JStream(_stream_cfg(
        cfg, JStreamConfig)), n_steps=10, batch=128)
    return dict(cfg=cfg, params=params, index=index,
                tcfg=t_svq.SVQConfig(**dataclasses.asdict(cfg)),
                tparams=bridge.params_to_torch(jax.device_get(params)),
                tstate=bridge.index_state_to_torch(jax.device_get(index)))


def test_read_cluster_and_collision_rate_equal(trained):
    store = trained["index"].store
    tstore = trained["tstate"].store
    ids = np.concatenate([np.arange(trained["cfg"].n_items),
                          np.random.default_rng(0).integers(
                              -5, 10 * trained["cfg"].n_items, 500)]
                         ).astype(np.int32)
    np.testing.assert_array_equal(
        t_astore.read_cluster(tstore, torch.from_numpy(ids)).numpy(),
        np.asarray(j_astore.read_cluster(store, jnp.asarray(ids))))
    want = np.asarray(j_astore.collision_rate(store, jnp.asarray(ids)))
    got = t_astore.collision_rate(tstore, torch.from_numpy(ids)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got == want
    assert 0.0 < float(got) < 1.0


@pytest.mark.parametrize("n_users,k", [(64, 50), (32, 20)])
def test_eval_svq_recall_equal(trained, n_users, k):
    t = trained
    want = j_train.eval_svq_recall(
        t["cfg"], t["params"], t["index"],
        JStream(_stream_cfg(t["cfg"], JStreamConfig)), n_users=n_users, k=k)
    got = t_train.eval_svq_recall(
        t["tcfg"], t["tparams"], t["tstate"],
        RecsysStream(_stream_cfg(t["cfg"], StreamConfig)), n_users=n_users,
        k=k, device="cpu")
    assert got == want
    assert 0.0 < got["recall"] < 1.0 and got["served_valid"] > 0.0


# ---------------------------------------------------------------------------
# C8: train_svq takes the reference's arguments in the reference's order
# ---------------------------------------------------------------------------

def test_train_svq_signature_matches_reference():
    ref = inspect.signature(j_train.train_svq).parameters
    port = inspect.signature(t_train.train_svq).parameters
    positional = [n for n, p in port.items()
                  if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == list(ref)
    for name in ref:
        assert port[name].default == ref[name].default, name
    assert {n for n, p in port.items() if p.kind == p.KEYWORD_ONLY} == \
        {"device", "loop"}


def test_train_svq_checkpoint_dir_names_a7_and_log_every_prints(capsys):
    cfg = t_svq.smoke()
    stream = RecsysStream(_stream_cfg(cfg, StreamConfig))
    with pytest.raises(NotImplementedError, match="A7"):
        t_train.train_svq(cfg, stream, 1, 16, "ckpt", device="cpu")
    _, _, res = t_train.train_svq(cfg, stream, 2, 16, None, 1, 0,
                                  device="cpu",
                                  loop=LoopConfig(sync_every=1))
    out = capsys.readouterr().out
    assert "[loop] step 0:" in out and "[loop] step 1:" in out
    assert res.steps_run == 2
