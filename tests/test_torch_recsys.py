"""PyTorch port vs the JAX reference: the recsys families (DLRM-RM2,
two-tower, DIN, BST), their embedding lookups, the dense blocks, the
config registry and the smoke trainer.

Inputs are made with numpy from a seed and fed to both packages; the
reference's params come through the numpy bridge.  The port runs on the
CPU, where ``ops.embedding_bag`` runs its plain version; the plain
version is held to the reference's Pallas ``embedding_bag`` kernel in
interpret mode.

Tolerances: forward, serve and retrieval rtol 1e-5 / atol 1e-6 (fp32
sums and GEMMs in another order); losses and gradients rtol 1e-4 /
atol 1e-5 (a backward sums more terms, in another order again).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import losses as j_losses
from repro.kernels import ops as j_ops
from repro.launch import train as j_train
from repro.launch.bindings import _RECSYS_MODS as J_MODS
from repro.models import dense as j_dense
from repro.models.recsys import embedding as j_emb
from repro.optim import adagrad as j_adagrad
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import multi_optimizer as j_multi

from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.core import losses as t_losses
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import train as t_train
from repro_torch.models import dense as t_dense
from repro_torch.models.recsys import _RECSYS_MODS as T_MODS
from repro_torch.models.recsys import embedding as t_emb
from repro_torch.optim import clip_by_global_norm as t_clip
from repro_torch.utils import tree

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, C = 12, 24
N_STEPS = 5
ARCHS = ["dlrm-rm2", "two-tower-retrieval", "din", "bst"]
# leaves whose every shift a softmax ignores, so their gradient is zero in
# exact arithmetic and Adam turns each library's rounding noise into
# steps of up to lr (ROADMAP.md C9): the two-tower item tower's last bias
# (in-batch softmax over items), DIN's attention-score bias and BST's key
# bias (softmax over the history)
SHIFT_FREE = {"two-tower-retrieval": [("item_tower", "layers", 1, "b")],
              "din": [("attn", "layers", 2, "b")],
              "bst": [("blocks", 0, "wk", "b")],
              "dlrm-rm2": []}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bf16_pair(x):
    """The same bf16 table in both packages (both round to nearest even)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# embedding_bag: the plain version vs the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,bag,d,bb", [
    (100, 4, 16, 4), (333, 7, 32, 8), (50, 1, 8, 2),
])
def test_embedding_bag_matches_pallas_kernel(rng, v, bag, d, bb, combiner,
                                             dtype):
    """ops.embedding_bag on the CPU (the plain version) vs the reference's
    Pallas kernel in interpret mode, the reference's sweep; bf16 at the
    reference's own bf16 tolerance (test_kernels.py)."""
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (13, bag)).astype(np.int32)
    if dtype == "bfloat16":
        jt, tt = _bf16_pair(table)
        tol = dict(rtol=3e-2, atol=3e-2)
    else:
        jt, tt = jnp.asarray(table), _t(table)
        tol = dict(rtol=1e-5, atol=1e-5)
    want = j_ops.embedding_bag(jt, jnp.asarray(ids), combiner, block_b=bb)
    got = t_ops.embedding_bag(tt, _t(ids), combiner)
    assert got.dtype == torch.float32 and got.shape == (13, d)
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def test_embedding_bag_wrapper_on_cpu_is_plain_and_counts_nothing(rng):
    t_ops.reset_launches()
    table = _t(rng.normal(size=(40, 12)).astype(np.float32))
    ids = _t(rng.integers(0, 40, (9, 5)))               # int64 ids
    for combiner in ("sum", "mean"):
        got = t_ops.embedding_bag(table, ids, combiner)
        assert torch.equal(got, t_ref.embedding_bag_ref(table, ids,
                                                        combiner))
    assert t_ops.LAUNCHES["embedding_bag"] == 0
    with pytest.raises(ValueError, match="combiner"):
        t_ops.embedding_bag(table, ids, "max")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_gradient_matches_reference(rng, combiner):
    """The wrapper's backward (index_add_ of the row cotangents) vs
    jax.grad of the reference's plain embedding_bag, with repeated ids."""
    table = rng.normal(size=(30, 8)).astype(np.float32)
    ids = rng.integers(0, 10, (11, 6)).astype(np.int32)
    g = rng.normal(size=(11, 8)).astype(np.float32)
    from repro.kernels import ref as j_ref
    want = jax.grad(lambda t: jnp.sum(
        j_ref.embedding_bag_ref(t, jnp.asarray(ids), combiner) * g))(
        jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    (t_ops.embedding_bag(tt, _t(ids), combiner) * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tt.grad), np.asarray(want), **GRAD_TOL)


# ---------------------------------------------------------------------------
# models/recsys/embedding.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hashed", [True, False])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("extra", ["none", "weights", "valid", "both"])
def test_embedding_bag_options_match_reference(rng, hashed, combiner, extra):
    table = rng.normal(size=(100, 8)).astype(np.float32)
    # ids past the table: hashed, or clamped with hashed=False
    ids = rng.integers(-20, 140, (2, 5, 3)).astype(np.int32)
    w = rng.normal(size=ids.shape).astype(np.float32)
    valid = rng.random(ids.shape) > 0.4
    valid[0, 0] = False                   # a bag with no valid id: mean 0
    kw = dict(weights=w if extra in ("weights", "both") else None,
              valid=valid if extra in ("valid", "both") else None)
    want = j_emb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), combiner, hashed=hashed,
        **{k: None if x is None else jnp.asarray(x) for k, x in kw.items()})
    got = t_emb.embedding_bag(
        _t(table), _t(ids), combiner, hashed=hashed,
        **{k: None if x is None else _t(x) for k, x in kw.items()})
    assert got.shape == (2, 5, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("extra", ["none", "valid"])
def test_embedding_bag_bf16_table_matches_reference(rng, combiner, extra):
    """A bf16 table: the kernel's branch and the masked one both give
    the reference's bf16 bag vectors, at the reference's bf16 tolerance
    (the kernel sums in fp32 and rounds once)."""
    table = rng.normal(size=(100, 8)).astype(np.float32)
    ids = rng.integers(0, 1000, (6, 5)).astype(np.int32)
    valid = rng.random(ids.shape) > 0.4 if extra == "valid" else None
    jt, tt = _bf16_pair(table)
    want = j_emb.embedding_bag(
        jt, jnp.asarray(ids), combiner,
        valid=None if valid is None else jnp.asarray(valid))
    got = t_emb.embedding_bag(tt, _t(ids), combiner,
                              valid=None if valid is None else _t(valid))
    assert got.dtype == torch.bfloat16 and got.shape == (6, 8)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_ragged_matches_reference(rng, combiner, weighted):
    table = rng.normal(size=(64, 8)).astype(np.float32)
    flat = rng.integers(0, 1000, 30).astype(np.int32)
    # segment 3 is empty; ids of segment 7 lie outside [0, 7) and drop
    seg = np.sort(rng.choice([0, 1, 2, 4, 5, 6, 7], 30)).astype(np.int32)
    w = rng.normal(size=30).astype(np.float32) if weighted else None
    want = j_emb.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 7,
        combiner, None if w is None else jnp.asarray(w))
    got = t_emb.embedding_bag_ragged(
        _t(table), _t(flat), _t(seg), 7, combiner,
        None if w is None else _t(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)


def test_init_tables_shapes_dtype_and_scale():
    specs = t_configs.get_smoke("dlrm-rm2").tables
    gen = torch.Generator().manual_seed(0)
    tabs = t_emb.init_tables(gen, specs, dtype=torch.bfloat16)
    assert list(tabs) == [s.name for s in specs]
    for s in specs:
        assert tabs[s.name].shape == (s.vocab, s.dim)
        assert tabs[s.name].dtype == torch.bfloat16
    std = float(torch.cat([t.float().ravel() for t in tabs.values()]).std())
    assert abs(std - 8 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# dense blocks, losses, registry
# ---------------------------------------------------------------------------

def test_layernorm_rmsnorm_count_params_match_reference(rng):
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    jp, tp = dict(g=jnp.asarray(g), b=jnp.asarray(b)), dict(g=_t(g), b=_t(b))
    np.testing.assert_allclose(
        _np(t_dense.layernorm(tp, _t(x))),
        np.asarray(j_dense.layernorm(jp, jnp.asarray(x))), **FWD_TOL)
    np.testing.assert_allclose(
        _np(t_dense.rmsnorm(dict(g=_t(g)), _t(x))),
        np.asarray(j_dense.rmsnorm(dict(g=jnp.asarray(g)), jnp.asarray(x))),
        **FWD_TOL)
    assert torch.equal(t_dense.init_layernorm(16)["g"], torch.ones(16))
    assert torch.equal(t_dense.init_rmsnorm(16)["g"], torch.ones(16))
    for arch in ARCHS:
        cfg = j_configs.get_smoke(arch)
        p = J_MODS[cfg.kind].init(jax.random.PRNGKey(0), cfg)
        tp = bridge.params_to_torch(jax.device_get(p))
        assert t_dense.count_params(tp) == j_dense.count_params(p)


def test_mlp_act_and_final_act_match_reference(rng):
    jp = j_dense.init_mlp(jax.random.PRNGKey(1), 6, (5, 4, 3))
    tp = bridge.params_to_torch(jax.device_get(jp))
    x = rng.normal(size=(7, 6)).astype(np.float32)
    for jact, tact in ((jax.nn.relu, torch.relu),
                       (jax.nn.sigmoid, torch.sigmoid)):
        for final in (False, True):
            np.testing.assert_allclose(
                _np(t_dense.mlp(tp, _t(x), act=tact, final_act=final)),
                np.asarray(j_dense.mlp(jp, jnp.asarray(x), act=jact,
                                       final_act=final)), **FWD_TOL)


@pytest.mark.parametrize("with_logq", [False, True])
def test_build_logits_matches_reference(rng, with_logq):
    u, v = (rng.normal(size=(9, 4)).astype(np.float32) for _ in range(2))
    bias, lq = (rng.normal(size=9).astype(np.float32) for _ in range(2))
    lq = lq if with_logq else None
    want = j_losses.build_logits(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(bias),
                                 None if lq is None else jnp.asarray(lq))
    got = t_losses.build_logits(_t(u), _t(v), _t(bias),
                                None if lq is None else _t(lq))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)
    with pytest.raises(NotImplementedError, match="A15"):
        t_losses.build_logits(_t(u), _t(v), _t(bias), temperature=0.5)


def test_registry_matches_reference():
    assert t_configs.ALL_ARCHS == j_configs.ALL_ARCHS
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    for name in ("LM_ARCHS", "GNN_ARCHS", "RECSYS_ARCHS"):
        assert getattr(t_configs, name) == getattr(j_configs, name)
    for arch in j_configs.ALL_ARCHS:
        assert t_configs.family(arch) == j_configs.family(arch)
    for arch in ARCHS + ["smollm-360m", "yi-9b", "qwen3-0.6b"]:
        for get in ("get_config", "get_smoke"):
            assert (dataclasses.asdict(getattr(t_configs, get)(arch))
                    == dataclasses.asdict(getattr(j_configs, get)(arch)))
        assert ([dataclasses.asdict(s) for s in t_configs.get_shapes(arch)]
                == [dataclasses.asdict(s) for s in
                    j_configs.get_shapes(arch)])
        assert (t_configs.get_config(arch).n_params()
                == j_configs.get_config(arch).n_params())
    assert t_configs.get_config("svq") == t_configs.base.SVQConfig()


@pytest.mark.parametrize("arch,item", [("granite-moe-1b-a400m", "A21"),
                                       ("llama4-maverick-400b-a17b", "A21"),
                                       ("mace", "A20")])
def test_registry_raises_for_unported_families(arch, item):
    for get in (t_configs.get_config, t_configs.get_smoke,
                t_configs.get_shapes):
        with pytest.raises(NotImplementedError, match=item):
            get(arch)
    with pytest.raises(NotImplementedError, match=item):
        t_train.train_arch_smoke(arch, device="cpu")
    with pytest.raises(KeyError):
        t_configs.get_config("resnet-50")


# ---------------------------------------------------------------------------
# the four families at their smoke configs
# ---------------------------------------------------------------------------

def _batch(cfg, seed, b=B):
    """A numpy smoke batch of ``cfg``'s family (the reference's draws)."""
    rng = np.random.default_rng(seed)
    out = {k: _np(v) for k, v in
           t_train._smoke_recsys_batch(cfg, rng, b, "cpu").items()}
    if cfg.kind == "two_tower":
        out["label"] = np.zeros(b, np.float32)          # unused
    return out


def _retrieval_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.kind == "dlrm":
        rb = {t.name: rng.integers(
            0, t.vocab, (C, t.bag_size) if t.bag_size > 1 else (C,))
            .astype(np.int32) for t in cfg.tables}
        rb["dense"] = rng.normal(size=(1, cfg.n_dense)).astype(np.float32)
        return rb
    if cfg.kind == "two_tower":
        bag = cfg.tables[1].bag_size
        # repeated candidates: exact ties for the top-k order
        items = rng.integers(0, 1000, C).astype(np.int32)
        cates = rng.integers(0, 50, C).astype(np.int32)
        items[5::6], cates[5::6] = items[0], cates[0]
        return dict(user_id=np.asarray([3], np.int32),
                    user_hist=rng.integers(0, 1000, (1, bag))
                    .astype(np.int32),
                    cand_items=items, cand_cates=cates)
    rb = {k: v for k, v in _batch(cfg, seed, 1).items() if k != "label"}
    rb["cand_items"] = rng.integers(0, 1000, C).astype(np.int32)
    rb["cand_cates"] = rng.integers(0, 50, C).astype(np.int32)
    return rb


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, cfg, reference module, port module, reference params,
    bridged params)."""
    arch = request.param
    cfg = j_configs.get_smoke(arch)
    jp = J_MODS[cfg.kind].init(jax.random.PRNGKey(0), cfg)
    return (arch, cfg, J_MODS[cfg.kind], T_MODS[cfg.kind], jp,
            bridge.params_to_torch(jax.device_get(jp)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_on_cuda_unless_a_device_is_named(arch, monkeypatch):
    """With no card and no device named, init raises rather than build
    on the CPU; a generator on another device than the one named
    raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_configs.get_smoke(arch)
    mod = T_MODS[cfg.kind]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="generator on cpu"):
        mod.init(torch.Generator().manual_seed(0), cfg, "cuda")


def test_init_has_the_reference_layout(family):
    arch, cfg, _, tmod, jp, tp = family
    mine = tmod.init(torch.Generator().manual_seed(0),
                     t_configs.get_smoke(arch), "cpu")
    want = [(tuple(np.asarray(x).shape)) for x in jax.tree_util.tree_leaves(
        jp)]
    assert [tuple(x.shape) for x in tree.leaves(mine)] == want
    assert [tuple(x.shape) for x in tree.leaves(tp)] == want


def test_forward_and_serve_match_reference(family):
    arch, cfg, jmod, tmod, jp, tp = family
    nb = _batch(cfg, 1)
    if cfg.kind == "din":
        nb["hist_mask"] = np.random.default_rng(2).random(
            nb["hist_items"].shape) > 0.3
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    tcfg = t_configs.get_smoke(arch)
    if cfg.kind != "two_tower":
        np.testing.assert_allclose(_np(tmod.forward(tp, tcfg, tb)),
                                   np.asarray(jmod.forward(jp, cfg, jb)),
                                   **FWD_TOL)
    got = tmod.serve(tp, tcfg, tb)
    assert got.shape == (B,)
    np.testing.assert_allclose(_np(got), np.asarray(jmod.serve(jp, cfg, jb)),
                               **FWD_TOL)


def test_retrieval_matches_reference(family):
    arch, cfg, jmod, tmod, jp, tp = family
    nb = _retrieval_batch(cfg, 3)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    tcfg = t_configs.get_smoke(arch)
    if cfg.kind != "two_tower":
        got = tmod.retrieval(tp, tcfg, tb)
        assert got.shape == (C,)
        np.testing.assert_allclose(_np(got),
                                   np.asarray(jmod.retrieval(jp, cfg, jb)),
                                   **FWD_TOL)
        return
    want = jmod.retrieval(jp, cfg, jb, top_k=8)
    got = tmod.retrieval(tp, tcfg, tb, top_k=8)
    scores = _np(got["scores"])
    np.testing.assert_allclose(scores, np.asarray(want["scores"]),
                               **FWD_TOL)
    # ties to the lower index, as lax.top_k: a stable descending order
    assert np.array_equal(scores[5::6], np.full(4, scores[0]))
    np.testing.assert_array_equal(
        _np(got["top_idx"]), np.argsort(-scores, kind="stable")[:8])
    assert got["top_idx"].dtype == torch.int32
    np.testing.assert_allclose(_np(got["top_scores"]),
                               np.asarray(want["top_scores"]), **FWD_TOL)
    assert "top_idx" not in tmod.retrieval(tp, tcfg, tb)


def test_loss_and_grads_match_reference(family):
    arch, cfg, jmod, tmod, jp, tp = family
    nb = _batch(cfg, 4)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jmod.loss(p, cfg, jb), has_aux=True)(jp)
    paths = tree.flatten_with_path(tp)
    leaves = [x.detach().requires_grad_(True) for _, x in paths]
    tl, taux = tmod.loss(tree.unflatten(tp, leaves),
                         t_configs.get_smoke(arch), tb)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(_np(taux[k]), np.asarray(jaux[k]),
                                   **GRAD_TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for (path, _), g, want in zip(paths, tg, jleaves):
        assert g is not None, path
        np.testing.assert_allclose(_np(g), np.asarray(want), **GRAD_TOL,
                                   err_msg=str(path))


def test_dlrm_forward_calls_embedding_bag_once_per_multi_hot_table(
        monkeypatch):
    cfg = t_configs.get_smoke("dlrm-rm2")
    p = T_MODS["dlrm"].init(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    real = t_ops.embedding_bag

    def counting(table, ids, combiner="sum"):
        calls.append(tuple(ids.shape))
        return real(table, ids, combiner)

    monkeypatch.setattr(t_ops, "embedding_bag", counting)
    tb = {k: _t(v) for k, v in _batch(cfg, 5).items()}
    T_MODS["dlrm"].serve(p, cfg, tb)
    multi = [t for t in cfg.tables if t.bag_size > 1]
    assert calls == [(B, t.bag_size) for t in multi]


# ---------------------------------------------------------------------------
# the smoke trainer
# ---------------------------------------------------------------------------

def _reference_steps(arch, params, pin):
    """train_arch_smoke's body in the reference, from ``params``, with the
    leaves at ``pin`` put back to their init after every update."""
    cfg = j_configs.get_smoke(arch)
    mod = J_MODS[cfg.kind]
    rng = np.random.default_rng(0)
    opt = j_multi(j_train._route, {"adagrad": j_adagrad(0.05),
                                   "adamw": j_adamw(1e-3)})
    state = opt.init(params)
    init = {path: _get(params, path) for path in pin}
    losses = []
    for step in range(N_STEPS):
        b = j_train._smoke_recsys_batch(cfg, rng, 8)
        (loss, _), grads = jax.value_and_grad(
            lambda p: mod.loss(p, cfg, b), has_aux=True)(params)
        grads, _ = j_clip(grads, 10.0)
        params, state = opt.update(grads, state, params, jnp.asarray(step))
        for path, leaf in init.items():
            params = _set(params, path, leaf)
        losses.append(float(loss))
    return params, losses


def _port_steps(arch, params, pin):
    """train_arch_smoke's step loop in the port, from ``params``, with the
    leaves at ``pin`` put back to their init after every update."""
    cfg = t_configs.get_smoke(arch)
    mod = T_MODS[cfg.kind]
    rng = np.random.default_rng(0)
    opt = t_train._svq_opt()
    state = opt.init(params)
    held = {path: _get(params, path).clone() for path in pin}
    losses = []
    for step in range(N_STEPS):
        b = t_train._smoke_recsys_batch(cfg, rng, 8, "cpu")
        paths = tree.flatten_with_path(params)
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in paths]
        loss, _ = mod.loss(tree.unflatten(params, leaves), cfg, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree.unflatten(params, [
            torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, grads)])
        grads, _ = t_clip(grads, 10.0)
        params, state = opt.update(grads, state, params,
                                   torch.tensor(step, dtype=torch.int32))
        for path, leaf in held.items():
            _get(params, path[:-1])[path[-1]] = leaf
        losses.append(float(loss.detach()))
    return params, losses


def _get(tree_, path):
    for k in path:
        tree_ = tree_[k]
    return tree_


def _set(tree_, path, leaf):
    """A copy of ``tree_`` (dicts and lists) with ``leaf`` at ``path``."""
    if not path:
        return leaf
    if isinstance(tree_, dict):
        return {**tree_, path[0]: _set(tree_[path[0]], path[1:], leaf)}
    out = list(tree_)
    out[path[0]] = _set(out[path[0]], path[1:], leaf)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_arch_smoke_trajectory_matches_reference(arch):
    """5 steps from the reference's init (PRNGKey(0), bridged) on the same
    numpy batches: the losses of train_arch_smoke itself agree; with the
    shift-free leaves (SHIFT_FREE, ROADMAP.md C9) held at their init in
    both packages, every param leaf agrees too."""
    cfg = j_configs.get_smoke(arch)
    jp = J_MODS[cfg.kind].init(jax.random.PRNGKey(0), cfg)
    tcfg = t_configs.get_smoke(arch)
    want = j_train.train_arch_smoke(arch, N_STEPS, 8, 0)
    _, losses = t_train._train_recsys(
        tcfg, bridge.params_to_torch(jax.device_get(jp)),
        np.random.default_rng(0), N_STEPS, 8, "cpu")
    np.testing.assert_allclose([losses[0], losses[-1]],
                               [want["first_loss"], want["last_loss"]],
                               **GRAD_TOL)

    pin = SHIFT_FREE[arch]
    tp, tl = _port_steps(arch, bridge.params_to_torch(jax.device_get(jp)),
                         pin)
    jp5, jl = _reference_steps(arch, jp, pin)
    np.testing.assert_allclose(tl, jl, **GRAD_TOL)
    for (path, got), want_leaf in zip(tree.flatten_with_path(tp),
                                      jax.tree_util.tree_leaves(jp5)):
        np.testing.assert_allclose(_np(got), np.asarray(want_leaf),
                                   **GRAD_TOL, err_msg=str(path))


def test_train_arch_smoke_entry_point_on_cpu():
    out = t_train.train_arch_smoke("dlrm-rm2", n_steps=2, batch=4,
                                   device="cpu")
    assert set(out) == {"first_loss", "last_loss"}
    assert all(np.isfinite(v) for v in out.values())
    with pytest.raises(ValueError, match="train_svq"):
        t_train.train_arch_smoke("svq", device="cpu")
