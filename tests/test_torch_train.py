"""PyTorch port vs the JAX reference: the streaming train step and the
trainer.

Inputs are made with numpy from a seed (or come from the reference's
stream) and fed to both packages; the reference's params and state come
through the numpy bridge.  The port runs on the CPU, where its kernel
wrappers run their plain versions; the reference runs its train step
with its Pallas kernels in interpret mode (``use_kernel=True``) and
without (``use_kernel=False``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import freq_estimator as j_freq
from repro.core import retriever as j_retriever
from repro.core import vq as j_vq
from repro.data import RecsysStream as JStream
from repro.data import StreamConfig as JStreamConfig
from repro.launch import train as j_train
from repro.optim import adagrad as j_adagrad
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import multi_optimizer as j_multi
from repro.train import LoopConfig as JLoopConfig
from repro.train import run_loop as j_run_loop

from repro_torch import bridge
from repro_torch.configs import svq as t_svq
from repro_torch.core import freq_estimator as t_freq
from repro_torch.core import retriever as t_retriever
from repro_torch.core import vq as t_vq
from repro_torch.data.streaming import RecsysStream, StreamConfig
from repro_torch.launch import train as t_train
from repro_torch.optim import adagrad, adamw, clip_by_global_norm, \
    multi_optimizer
from repro_torch.train import LoopConfig, run_loop
from repro_torch.utils import tree

BATCH = 64
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # fp32 sums in other orders
EMA_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _stream_cfg(cfg, cls):
    return cls(n_items=cfg.n_items, n_users=cfg.n_users,
               hist_len=cfg.user_hist_len)


def _leaves_by_path(jtree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]]


def _assert_tree_close(ttree, jtree, **tol):
    """Leaf by leaf, in the reference's leaf order (sorted dict keys)."""
    jl = _leaves_by_path(jtree)
    tl = tree.flatten_with_path(ttree)
    assert len(jl) == len(tl)
    for (jpath, a), (tpath, b) in zip(jl, tl):
        assert jpath == "".join(f"[{k!r}]" for k in tpath), (jpath, tpath)
        assert a.shape == tuple(b.shape), jpath
        np.testing.assert_allclose(b.detach().numpy(), a, err_msg=jpath,
                                   **tol)


# ---------------------------------------------------------------------------
# the stream, the frequency estimator and the EMA weights
# ---------------------------------------------------------------------------

def test_stream_copy_is_bitwise_the_reference():
    cfg = get_smoke("svq")
    js = JStream(_stream_cfg(cfg, JStreamConfig))
    ts = RecsysStream(_stream_cfg(cfg, StreamConfig))
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    for _ in range(3):
        for name in ("impression_batch", "candidate_batch"):
            a, b = getattr(js, name)(BATCH), getattr(ts, name)(BATCH)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(js.user_hist, ts.user_hist)


@pytest.mark.parametrize("with_valid", [False, True])
def test_freq_update_bitwise_and_log_q_close(rng, with_valid):
    cap = 50
    ids = rng.integers(0, 200, size=300).astype(np.int32)   # duplicates
    state = j_freq.init_freq(cap)
    tstate = t_freq.init_freq(cap)
    for step in (1, 2, 5):
        valid = rng.random(300) > 0.3 if with_valid else None
        state, delta = j_freq.update(
            state, jnp.asarray(ids), step,
            valid=None if valid is None else jnp.asarray(valid))
        tstate, tdelta = t_freq.update(
            tstate, _t(ids), torch.tensor(step, dtype=torch.int32),
            valid=None if valid is None else _t(valid))
        for f in state._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(state, f)).view(np.uint32),
                getattr(tstate, f).numpy().view(np.uint32), err_msg=f)
        np.testing.assert_array_equal(np.asarray(delta).view(np.uint32),
                                      tdelta.numpy().view(np.uint32))
        np.testing.assert_array_max_ulp(
            t_freq.log_q(tdelta).numpy(), np.asarray(j_freq.log_q(delta)),
            maxulp=1)
    np.testing.assert_array_equal(
        np.asarray(j_freq.lookup_delta(state, jnp.asarray(ids))),
        t_freq.lookup_delta(tstate, _t(ids)).numpy())


@pytest.mark.parametrize("multi", [False, True])
def test_popularity_weight_close(rng, multi):
    delta = rng.uniform(0.0, 2000.0, size=100).astype(np.float32)
    rewards = rng.uniform(0, 3, size=(100, 3)).astype(np.float32)
    valid = rng.random(100) > 0.2
    eta = (1.0, 0.5, 0.5)
    kw = dict(rewards=rewards, eta=eta) if multi else {}
    want = j_vq.popularity_weight(
        jnp.asarray(delta), 0.6, valid=jnp.asarray(valid),
        **{k: jnp.asarray(v) if k == "rewards" else v for k, v in kw.items()})
    got = t_vq.popularity_weight(
        _t(delta), 0.6, valid=_t(valid),
        **{k: _t(v) if k == "rewards" else v for k, v in kw.items()})
    # float32 pow of both libraries lies within 3 ulp of the exact value
    # (measured against float64), so they differ by up to 3 ulp a power
    if multi:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    else:
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=3)
        exact = np.power(np.maximum(delta, 1e-6).astype(np.float64), 0.6)
        np.testing.assert_array_max_ulp(
            got.numpy()[valid], exact[valid].astype(np.float32), maxulp=3)


def test_cluster_usage_stats_match_reference(rng):
    a = rng.integers(0, 20, size=200).astype(np.int32)
    jstate = j_vq.init_vq(jax.random.PRNGKey(0), 32, 4)
    tstate = t_vq.VQState(w=_t(jstate.w), c=_t(jstate.c))
    want = j_vq.cluster_usage_stats(jstate, jnp.asarray(a))
    got = t_vq.cluster_usage_stats(tstate, _t(a))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_case(rng):
    params = {"tables": {"t": rng.normal(size=(6, 3)).astype(np.float32)},
              "net": [{"w": rng.normal(size=(3, 2)).astype(np.float32),
                       "b": rng.normal(size=(2,)).astype(np.float32)}]}
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 5, params)
    return params, grads


def _route_j(path):
    return "adagrad" if "tables" in jax.tree_util.keystr(path) else "adamw"


@pytest.mark.parametrize("name", ["adamw", "adagrad", "multi"])
def test_optimizer_updates_match_reference(rng, name):
    params, grads = _opt_case(rng)
    jopt, topt = {
        "adamw": (j_adamw(1e-2, weight_decay=0.1), adamw(1e-2,
                                                          weight_decay=0.1)),
        "adagrad": (j_adagrad(0.05), adagrad(0.05)),
        "multi": (j_multi(_route_j, {"adagrad": j_adagrad(0.05),
                                     "adamw": j_adamw(1e-3)}),
                  t_train._svq_opt()),
    }[name]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.params_to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(2):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp, jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(bridge.params_to_torch(grads), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-6)
    _assert_tree_close(ts, js, rtol=1e-6, atol=1e-6)


def test_clip_by_global_norm_matches_reference(rng):
    _, grads = _opt_case(rng)
    for max_norm in (1.0, 1e3):
        jg, jn = j_clip(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        tg, tn = clip_by_global_norm(bridge.params_to_torch(grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tg, jg, rtol=1e-6, atol=1e-6)


def test_svq_route_sends_tables_to_adagrad():
    assert t_train._route(("tables", "item_id")) == "adagrad"
    assert t_train._route(("user_towers", "layers", 0, "w")) == "adamw"


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_step():
    cfg = get_smoke("svq")
    tcfg = t_svq.smoke()
    params, state = j_retriever.init(jax.random.PRNGKey(0), cfg)
    stream = JStream(_stream_cfg(cfg, JStreamConfig))
    imp, cand = stream.impression_batch(BATCH), stream.candidate_batch(BATCH)
    jimp = {k: jnp.asarray(v) for k, v in imp.items()}
    jcand = {k: jnp.asarray(v) for k, v in cand.items()}
    ref = {uk: jax.jit(lambda p, s, b, c, uk=uk: j_retriever.train_step(
        p, s, cfg, b, c, use_kernel=uk))(params, state, jimp, jcand)
        for uk in (True, False)}
    tparams = bridge.params_to_torch(jax.device_get(params))
    tstate = bridge.index_state_to_torch(jax.device_get(state))
    got = t_retriever.train_step(tparams, tstate, tcfg, imp, cand,
                                 device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, state=state, imp=imp,
                tparams=tparams, tstate=tstate, ref=ref, got=got)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_train_step_loss_and_grads_match_reference(one_step, use_kernel):
    jg, _, jm = one_step["ref"][use_kernel]
    tg, _, tm = one_step["got"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("l_aux_0", "l_ind_0", "l_rank_0", "usage_entropy",
              "perplexity", "used_clusters", "max_cluster"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_tree_close(tg, jg, **GRAD_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_train_step_new_state_matches_reference(one_step, use_kernel):
    _, js, _ = one_step["ref"][use_kernel]
    _, ts, _ = one_step["got"]
    assert int(ts.step) == int(js.step) == 1
    for f in ts.freq._fields:          # bitwise
        np.testing.assert_array_equal(
            np.asarray(getattr(js.freq, f)).view(np.uint32),
            getattr(ts.freq, f).numpy().view(np.uint32), err_msg=f)
    np.testing.assert_allclose(ts.vq.w.numpy(), np.asarray(js.vq.w),
                               **EMA_TOL)
    np.testing.assert_allclose(ts.vq.c.numpy(), np.asarray(js.vq.c),
                               **EMA_TOL)
    np.testing.assert_array_equal(ts.store.cluster.numpy(),
                                  np.asarray(js.store.cluster))
    np.testing.assert_array_equal(ts.store.item_id.numpy(),
                                  np.asarray(js.store.item_id))
    np.testing.assert_allclose(ts.store.item_emb.numpy(),
                               np.asarray(js.store.item_emb), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.store.item_bias.numpy(),
                               np.asarray(js.store.item_bias), rtol=1e-5,
                               atol=1e-6)


def test_train_step_assignment_matches_reference(one_step):
    """Eq. 10 on the batch's item embeddings: the port's assignment of
    its own v_emb equals the reference's Pallas and lax assignments of
    the reference's v_emb, except inside near ties."""
    s = one_step
    imp = s["imp"]
    jfeat = j_retriever.item_features(s["params"], jnp.asarray(imp["item_id"]),
                                      jnp.asarray(imp["item_cate"]))
    tfeat = t_retriever.item_features(s["tparams"], _t(imp["item_id"]),
                                      _t(imp["item_cate"]))
    uf, _ = j_retriever.user_features(s["params"], jnp.asarray(imp["user_id"]),
                                      jnp.asarray(imp["hist"]))
    _, jv, _ = j_retriever.index_forward(s["params"], s["cfg"], uf, jfeat)
    tuf, _ = t_retriever.user_features(s["tparams"], _t(imp["user_id"]),
                                       _t(imp["hist"]))
    _, tv, _ = t_retriever.index_forward(s["tparams"], s["tcfg"], tuf, tfeat)
    got = t_vq.assign(s["tstate"].vq, tv.detach(), s["cfg"].disturbance_s)
    e = np.asarray(s["state"].vq.embeddings(), np.float64)
    r = np.asarray(j_vq.disturbance(s["state"].vq.c, s["cfg"].disturbance_s))
    v = np.asarray(jv, np.float64)
    scores = np.maximum((v * v).sum(-1)[:, None] - 2 * v @ e.T
                        + (e * e).sum(-1)[None], 0) * r[None]
    for uk in (True, False):
        want = np.asarray(j_vq.assign(s["state"].vq, jv,
                                      s["cfg"].disturbance_s, use_kernel=uk))
        rows = np.nonzero(got.numpy() != want)[0]
        a = scores[rows, got.numpy()[rows]]
        b = scores[rows, want[rows]]
        assert np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1.0))


def test_train_step_grads_keep_the_params_layout(one_step):
    tg, _, _ = one_step["got"]
    shapes = lambda t: [(p, tuple(x.shape))
                        for p, x in tree.flatten_with_path(t)]
    assert shapes(tg) == shapes(one_step["tparams"])
    assert all(not x.requires_grad for x in tree.leaves(tg))


def test_train_step_needs_a_device_or_a_card(one_step):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    s = one_step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_retriever.train_step(s["tparams"], s["tstate"], s["tcfg"],
                               s["imp"])


# ---------------------------------------------------------------------------
# the trainer: 5 steps of the port against train_svq(seed=0)
# ---------------------------------------------------------------------------

N_STEPS = 5


def _pinned(step_fn, bias):
    """``step_fn`` with the item tower's last bias put back to ``bias``
    after every update (see test_trajectory_store_matches_reference)."""
    def pinned(state, batch):
        state, metrics = step_fn(state, batch)
        state["params"]["item_tower"]["layers"][-1]["b"] = bias
        return state, metrics
    return pinned


def _trajectories(pin: bool):
    """The reference side is train_svq(seed=0)'s own body (init from
    PRNGKey(0), _svq_opt, _svq_step_fn, run_loop), run with a metrics sync
    every step so each step's loss is recorded; the port's side runs its
    _svq_step_fn and run_loop from the bridged init on its own copy of the
    stream."""
    cfg = get_smoke("svq")
    params, index = j_retriever.init(jax.random.PRNGKey(0), cfg)
    jopt = j_train._svq_opt()
    jstep = j_train._svq_step_fn(cfg, jopt)
    js = JStream(_stream_cfg(cfg, JStreamConfig))
    tparams = bridge.params_to_torch(jax.device_get(params))
    topt = t_train._svq_opt()
    tstep = t_train._svq_step_fn(t_svq.smoke(), topt, "cpu")
    ts = RecsysStream(_stream_cfg(cfg, StreamConfig))
    if pin:
        jstep = _pinned(jstep, params["item_tower"]["layers"][-1]["b"])
        tstep = _pinned(tstep, tparams["item_tower"]["layers"][-1]["b"])
    jres = j_run_loop(
        jstep,
        {"params": params, "index": index, "opt": jopt.init(params),
         "step": jnp.zeros((), jnp.int32)},
        lambda s: {"imp": js.impression_batch(BATCH),
                   "cand": js.candidate_batch(BATCH)},
        JLoopConfig(n_steps=N_STEPS, sync_every=1))
    tres = run_loop(
        tstep,
        {"params": tparams,
         "index": bridge.index_state_to_torch(jax.device_get(index)),
         "opt": topt.init(tparams),
         "step": torch.zeros((), dtype=torch.int32)},
        lambda s: {"imp": ts.impression_batch(BATCH),
                   "cand": ts.candidate_batch(BATCH)},
        LoopConfig(n_steps=N_STEPS, sync_every=1))
    return jres, tres


@pytest.fixture(scope="module")
def trajectory():
    return _trajectories(pin=False)


@pytest.fixture(scope="module")
def pinned_trajectory():
    return _trajectories(pin=True)


def test_trajectory_losses_match_reference(trajectory):
    jres, tres = trajectory
    assert [m["step"] for m in tres.metrics] == list(range(N_STEPS))
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics], rtol=1e-4)
    # the gradient norm feels the params' drift (see below) from the
    # second update on; the first step starts from the same params
    np.testing.assert_allclose(tres.metrics[0]["grad_norm"],
                               jres.metrics[0]["grad_norm"], rtol=1e-5)


def test_trajectory_store_matches_reference(pinned_trajectory):
    """At least 99% of the written store clusters agree after 5 steps
    (near ties of vq_assign may flip an item), with the item tower's last
    bias held at its init in both runs.  That bias shifts every item
    embedding by one vector, which the in-batch softmax ignores, so its
    gradient is zero in exact arithmetic; Adam's normalised step turns
    each library's rounding noise there into steps of up to lr, which
    move the items against the codebook and flip assignments.  Left free,
    the two packages' written clusters agree on 100%, 99.3%, 97.0%, 96.9%
    and 95.9% of the slots after steps 1 to 5; held, on all of them."""
    jres, tres = pinned_trajectory
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics], rtol=1e-4)
    jc = np.asarray(jres.state["index"].store.cluster)
    tc = tres.state["index"].store.cluster.numpy()
    written = jc >= 0
    np.testing.assert_array_equal(tc >= 0, written)
    assert np.mean(jc[written] == tc[written]) >= 0.99


def test_train_svq_entry_point_on_cpu():
    cfg = t_svq.smoke()
    stream = RecsysStream(_stream_cfg(cfg, StreamConfig))
    params, index, res = t_train.train_svq(cfg, stream, n_steps=2,
                                           batch=32, device="cpu",
                                           loop=LoopConfig(sync_every=1))
    assert res.steps_run == 2 and len(res.metrics) == 2
    assert all(np.isfinite(m["loss"]) for m in res.metrics)
    assert int(index.step) == 2
    assert int((index.store.cluster >= 0).sum()) > 0


def test_loop_parts_not_ported_raise():
    with pytest.raises(NotImplementedError, match="A7"):
        run_loop(None, None, None, LoopConfig(n_steps=1, ckpt_dir="x"))
    with pytest.raises(NotImplementedError, match="A8"):
        run_loop(None, None, None, LoopConfig(n_steps=1, stats=object()))
