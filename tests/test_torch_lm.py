"""PyTorch port vs the JAX reference: the dense LM family (attention
pieces, the transformer's prefill / decode / generate / loss, the token
stream and the smoke trainer) and the plain version of
``flash_attention``.

Inputs are made with numpy from a seed and fed to both packages; the
reference's params and caches come through the numpy bridge.  The port
runs on the CPU, where ``attention_flash_scan`` is the reference's
blockwise recurrence and ``ops.flash_attention`` runs its plain version;
the plain version is held to the reference's Pallas kernel in interpret
mode.

Tolerances: the attention pieces rtol 1e-5 / atol 1e-5 (fp32 sums in
another order); the plain ``flash_attention`` rtol 1e-4 / atol 1e-5 in
fp32 and 2e-2 in bf16 (the reference's own kernel tests); fp32 smoke
logits, loss and the prefill cache rtol 1e-5 / atol 1e-5; decode vs
forward < 2e-4 (the reference's bound, ``tests/test_lm.py``); the bf16
smoke forward 2e-2 (the reference's bf16 bound); the 5-step trajectory
rtol 1e-4 / atol 1e-5 (a backward sums more terms).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.data import streaming as j_stream
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import lm as j_lm
from repro.models.lm import attention as j_attn
from repro.models.lm import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip

from repro_torch import bridge
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.data import streaming as t_stream
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.models.lm import attention as t_attn
from repro_torch.models.lm import transformer as t_tfm
from repro_torch.utils import tree

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["smollm-360m", "yi-9b", "qwen3-0.6b"]
N_STEPS = 5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _normal(g, *shape):
    return g.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,theta", [(32, 10000.0), (128, 1000000.0)])
def test_rope_matches_reference(rng, hd, theta):
    np.testing.assert_allclose(_np(t_attn.rope_freqs(hd, theta)),
                               np.asarray(j_attn.rope_freqs(hd, theta)),
                               **ATTN_TOL)
    x = _normal(rng, 2, 40, 3, hd)
    pos = np.arange(40, dtype=np.int32)[None, :] + 31_000   # large angles
    jx, tx = _pair(x)
    jp, tp = _pair(pos)
    np.testing.assert_allclose(_np(t_attn.apply_rope(tx, tp, theta)),
                               np.asarray(j_attn.apply_rope(jx, jp, theta)),
                               **ATTN_TOL)


def test_rmsnorm_headwise_and_repeat_kv_match_reference(rng):
    x, g = _normal(rng, 2, 5, 4, 16), _normal(rng, 16)
    np.testing.assert_allclose(
        _np(t_attn.rmsnorm_headwise(torch.from_numpy(x),
                                    torch.from_numpy(g))),
        np.asarray(j_attn.rmsnorm_headwise(jnp.asarray(x), jnp.asarray(g))),
        **ATTN_TOL)
    kv = _normal(rng, 2, 5, 3, 8)
    for rep in (1, 2, 4):
        np.testing.assert_array_equal(
            _np(t_attn.repeat_kv(torch.from_numpy(kv), rep)),
            np.asarray(j_attn.repeat_kv(jnp.asarray(kv), rep)))


@pytest.fixture
def qkv(rng):
    """GQA 4:2 (B=2, S=T=96, hd=16), as the reference's flash test."""
    return _normal(rng, 2, 96, 4, 16), _normal(rng, 2, 96, 2, 16), \
        _normal(rng, 2, 96, 2, 16)


def test_attention_full_matches_reference(qkv):
    j, t = zip(*map(_pair, qkv))
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(t_attn.attention_full(*t, causal=causal)),
            np.asarray(j_attn.attention_full(*j, causal=causal)), **ATTN_TOL)


@pytest.mark.parametrize("block", [32, 48, 40])   # 40 does not divide 96
def test_attention_flash_scan_matches_reference(qkv, block):
    j, t = zip(*map(_pair, qkv))
    before = dict(t_ops.LAUNCHES)
    got = t_attn.attention_flash_scan(*t, block_kv=block)
    assert t_ops.LAUNCHES == before           # the CPU runs no kernel
    np.testing.assert_allclose(
        _np(got), np.asarray(j_attn.attention_flash_scan(*j, block_kv=block)),
        **ATTN_TOL)
    np.testing.assert_allclose(_np(got),
                               _np(t_attn.attention_full(*t)), **ATTN_TOL)


def test_attention_decode_matches_reference_and_writes_in_place(rng):
    b, s_max, h, hk, hd, pos = 2, 20, 4, 2, 16, 11
    q = _normal(rng, b, 1, h, hd)
    kc, vc = _normal(rng, b, s_max, hk, hd), _normal(rng, b, s_max, hk, hd)
    kn, vn = _normal(rng, b, 1, hk, hd), _normal(rng, b, 1, hk, hd)
    jo, jk, jv = j_attn.attention_decode(
        *map(jnp.asarray, (q, kc, vc, kn, vn)), jnp.asarray(pos, jnp.int32))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = t_attn.attention_decode(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
        torch.from_numpy(vn), pos)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **ATTN_TOL)
    assert tk2 is tk and tv2 is tv
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


# ---------------------------------------------------------------------------
# flash_attention: the plain version vs the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,hd,bq,bkv,causal", [
    (128, 64, 32, 32, True), (256, 32, 64, 32, False),
    (128, 128, 128, 64, True), (64, 16, 16, 16, True),
])
def test_flash_attention_plain_matches_pallas_kernel(rng, s, hd, bq, bkv,
                                                     causal):
    """The cases of the reference's ``test_flash_attention_sweep``."""
    x = [_normal(rng, s, hd) for _ in range(3)]
    want = j_ops.flash_attention(*map(jnp.asarray, x), causal, bq, bkv)
    got = t_ops.flash_attention(*map(torch.from_numpy, x), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(
        _np(t_ref.flash_attention_ref(*map(torch.from_numpy, x), causal)),
        np.asarray(j_ref.flash_attention_ref(*map(jnp.asarray, x), causal)),
        **KERNEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_dtypes_match_pallas_kernel(rng, dtype):
    """The reference's ``test_flash_attention_dtypes`` case (48, 20)."""
    x = [_normal(rng, 48, 20) for _ in range(3)]
    jx = [jnp.asarray(a).astype(dtype) for a in x]
    tx = [bridge.tensor(np.asarray(a)) for a in jx]
    want = j_ops.flash_attention(*jx, True, 16, 16)
    got = t_ops.flash_attention(*tx, True)
    assert got.dtype == getattr(torch, dtype)
    tol = KERNEL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want).astype(np.float32), **tol)


def test_flash_attention_plain_gqa_is_per_head_reference(rng):
    """The (B, S, H, hd) form reads kv head h // (H // Hk) and offsets the
    diagonal by T - S: head by head the reference's single-head plain
    version (T = S) and its flash scan (T > S)."""
    b, s, h, hk, hd = 2, 33, 6, 2, 8
    q, k, v = _normal(rng, b, s, h, hd), _normal(rng, b, s, hk, hd), \
        _normal(rng, b, s, hk, hd)
    got = _np(t_ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v))))
    for bi in range(b):
        for hi in range(h):
            want = j_ref.flash_attention_ref(
                jnp.asarray(q[bi, :, hi]), jnp.asarray(k[bi, :, hi // 3]),
                jnp.asarray(v[bi, :, hi // 3]))
            np.testing.assert_allclose(got[bi, :, hi], np.asarray(want),
                                       **KERNEL_TOL)
    kt, vt = _normal(rng, b, s + 9, hk, hd), _normal(rng, b, s + 9, hk, hd)
    np.testing.assert_allclose(
        _np(t_ref.flash_attention_ref(*map(torch.from_numpy, (q, kt, vt)))),
        np.asarray(j_attn.attention_flash_scan(*map(jnp.asarray,
                                                    (q, kt, vt)),
                                               block_kv=16)), **KERNEL_TOL)


# ---------------------------------------------------------------------------
# the transformer at the dense smoke configs, on bridged params
# ---------------------------------------------------------------------------

_REF_PARAMS = {}


def _ref_params(arch, dtype=None):
    """The reference's init of ``arch``'s smoke config (``dtype`` replaces
    its dtype), as numpy, cached per module."""
    key = (arch, dtype)
    if key not in _REF_PARAMS:
        cfg = j_smoke(arch)
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        _REF_PARAMS[key] = (cfg, jax.device_get(
            j_tfm.init_lm(jax.random.PRNGKey(0), cfg)))
    return _REF_PARAMS[key]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("block_kv", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, block_kv):
    """Default block_kv (attention_full at 24 tokens) and block_kv=8 (the
    flash route, with a ragged last block)."""
    cfg, jp = _ref_params(arch)
    toks = _tokens(cfg, 2, 23, 1)
    want, _, _ = j_tfm.forward(jp, cfg, jnp.asarray(toks), block_kv=block_kv)
    got, cache, aux = t_tfm.forward(bridge.params_to_torch(jp),
                                    t_smoke(arch), torch.from_numpy(toks),
                                    block_kv=block_kv)
    assert cache is None and float(aux) == 0.0
    assert got.shape == (2, 23, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    cfg, jp = _ref_params(arch)
    toks = _tokens(cfg, 3, 16, 2)
    labels = _tokens(cfg, 3, 16, 3)
    labels[0, :5] = -1                              # masked labels
    labels[2, -3:] = -7
    jl, jm = j_tfm.lm_loss(jp, cfg, dict(tokens=jnp.asarray(toks),
                                         labels=jnp.asarray(labels)))
    tl, tm = t_tfm.lm_loss(bridge.params_to_torch(jp), t_smoke(arch),
                           dict(tokens=torch.from_numpy(toks),
                                labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tl), float(jl), **FWD_TOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **FWD_TOL)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"]) == 48 - 8


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_reference(arch):
    """Prefill's cache and logits, then decode steps: against the
    reference's, and against the port's own forward (< 2e-4)."""
    cfg, jp = _ref_params(arch)
    tcfg, tp = t_smoke(arch), bridge.params_to_torch(jp)
    toks = _tokens(cfg, 2, 12, 4)
    full, _, _ = t_tfm.forward(tp, tcfg, torch.from_numpy(toks))
    jl, jc = j_tfm.prefill(jp, cfg, jnp.asarray(toks[:, :8]))
    tl, tc = t_tfm.prefill(tp, tcfg, torch.from_numpy(toks[:, :8]))
    assert tc.pos == int(jc.pos) == 8
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD_TOL)
    np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **FWD_TOL)
    np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **FWD_TOL)
    errs = [float((tl - full[:, :8]).abs().max())]
    jc = j_lm.KVCache(
        k=jnp.pad(jc.k, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        v=jnp.pad(jc.v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        pos=jc.pos)
    tc = t_tfm.grow_cache(tc, 4)
    for i in range(8, 12):
        jd, jc = j_tfm.decode_step(jp, cfg, jnp.asarray(toks[:, i:i + 1]), jc)
        td, tc = t_tfm.decode_step(tp, tcfg,
                                   torch.from_numpy(toks[:, i:i + 1]), tc)
        np.testing.assert_allclose(_np(td), np.asarray(jd), **FWD_TOL)
        errs.append(float((td[:, 0] - full[:, i]).abs().max()))
    assert tc.pos == 12
    np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **FWD_TOL)
    assert max(errs) < 2e-4, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    cfg, jp = _ref_params(arch)
    prompt = _tokens(cfg, 2, 8, 5)
    want = j_tfm.greedy_generate(jp, cfg, jnp.asarray(prompt), n_steps=5)
    got = t_tfm.greedy_generate(bridge.params_to_torch(jp), t_smoke(arch),
                                torch.from_numpy(prompt), n_steps=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_kv_cache_bridge_decodes_like_the_reference():
    """A reference prefill cache, bridged, decodes as the reference's."""
    cfg, jp = _ref_params("qwen3-0.6b")
    toks = _tokens(cfg, 2, 9, 6)
    _, jc = j_tfm.prefill(jp, cfg, jnp.asarray(toks[:, :8]))
    jc = j_lm.KVCache(
        k=jnp.pad(jc.k, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))),
        v=jnp.pad(jc.v, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))),
        pos=jc.pos)
    tc = bridge.kv_cache_to_torch(jax.device_get(jc))
    assert isinstance(tc, t_lm.KVCache) and tc.pos == 8 and tc.s_max == 10
    np.testing.assert_array_equal(_np(tc.k), np.asarray(jc.k))
    jd, _ = j_tfm.decode_step(jp, cfg, jnp.asarray(toks[:, 8:]), jc)
    td, _ = t_tfm.decode_step(bridge.params_to_torch(jp),
                              t_smoke("qwen3-0.6b"),
                              torch.from_numpy(toks[:, 8:]), tc)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **FWD_TOL)


def test_vocab_padding_masked():
    cfg = dataclasses.replace(j_smoke("smollm-360m"), vocab=250)
    jp = jax.device_get(j_tfm.init_lm(jax.random.PRNGKey(7), cfg))
    tcfg = dataclasses.replace(t_smoke("smollm-360m"), vocab=250)
    assert tcfg.padded_vocab == 256
    toks = _tokens(cfg, 1, 8, 8)
    want, _, _ = j_tfm.forward(jp, cfg, jnp.asarray(toks))
    got, _, _ = t_tfm.forward(bridge.params_to_torch(jp), tcfg,
                              torch.from_numpy(toks))
    assert bool((got[..., 250:] <= -1e29).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD_TOL)
    out = t_tfm.greedy_generate(bridge.params_to_torch(jp), tcfg,
                                torch.from_numpy(toks), n_steps=3)
    assert bool((out < 250).all())


def test_bf16_smoke_forward_matches_reference():
    """qwen3's smoke config in bf16 (the dtype of every LM CONFIG), with
    the bf16 params bridged bit for bit, on both routes: the logits within
    the reference's bf16 bound, 2e-2, of the logits' largest magnitude.
    Each op rounds to bf16 relative to its activation's scale, and a
    1-ulp difference upstream (a sum in another order) moves the logits
    near 0 by a few ulps of that scale."""
    cfg, jp = _ref_params("qwen3-0.6b", "bfloat16")
    tcfg = dataclasses.replace(t_smoke("qwen3-0.6b"), dtype="bfloat16")
    tp = bridge.params_to_torch(jp)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 24, 9)
    for block_kv in (0, 8):
        want, _, _ = j_tfm.forward(jp, cfg, jnp.asarray(toks),
                                   block_kv=block_kv)
        got, _, _ = t_tfm.forward(tp, tcfg, torch.from_numpy(toks),
                                  block_kv=block_kv)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want).astype(np.float32)
        err = np.abs(_np(got.float()) - want)
        assert err.max() <= 2e-2 * np.abs(want).max(), err.max()


def test_moe_config_raises_naming_a21():
    from repro_torch.configs.base import MoEConfig
    cfg = dataclasses.replace(t_smoke("qwen3-0.6b"), moe=MoEConfig(4, 2))
    with pytest.raises(NotImplementedError, match="A21"):
        t_tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


def test_init_lm_builds_on_cuda_unless_a_device_is_named():
    cfg = t_smoke("yi-9b")
    p = t_tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = jax.device_get(j_tfm.init_lm(jax.random.PRNGKey(0),
                                       j_smoke("yi-9b")))
    assert [(path, tuple(x.shape), x.dtype) for path, x in
            tree.flatten_with_path(p)] == [
        (path, tuple(x.shape), getattr(torch, str(x.dtype)))
        for path, x in tree.flatten_with_path(ref)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tfm.init_lm(torch.Generator().manual_seed(0), cfg)


# ---------------------------------------------------------------------------
# the token stream and the smoke trainer
# ---------------------------------------------------------------------------

def test_lm_batch_bitwise():
    for seed, (b, s, vocab) in enumerate([(4, 32, 256), (3, 17, 1000)]):
        want = j_stream.lm_batch(np.random.default_rng(seed), b, s, vocab)
        got = t_stream.lm_batch(np.random.default_rng(seed), b, s, vocab)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# Adam's eps: where an element's root-mean-square gradient is below 100
# eps, its step g / (sqrt(v) + eps) follows the gradient's rounding noise
# (ROADMAP.md C10)
ADAM_EPS = 1e-8
EPS_CONDITIONED = 100 * ADAM_EPS


def _reference_steps(arch, params):
    """train_arch_smoke's LM body in the reference, from ``params`` ->
    (params, losses, per leaf the elements whose bias-corrected second
    moment was nonzero and below EPS_CONDITIONED**2 after some step)."""
    cfg = j_smoke(arch)
    rng = np.random.default_rng(0)
    opt = j_adamw(1e-3)
    state = opt.init(params)
    losses = []
    noisy = jax.tree_util.tree_map(lambda p: np.zeros(p.shape, bool), params)
    for step in range(N_STEPS):
        b = {k: jnp.asarray(v) for k, v in
             j_stream.lm_batch(rng, 8, 32, cfg.vocab).items()}
        (loss, _), grads = jax.value_and_grad(
            lambda p: j_tfm.lm_loss(p, cfg, b), has_aux=True)(params)
        grads, _ = j_clip(grads, 1.0)
        params, state = opt.update(grads, state, params, jnp.asarray(step))
        losses.append(float(loss))
        v_hat = jax.tree_util.tree_map(
            lambda v: np.asarray(v) / (1 - 0.999 ** (step + 1)), state["v"])
        noisy = jax.tree_util.tree_map(
            lambda n, v: n | ((v > 0) & (v < EPS_CONDITIONED ** 2)),
            noisy, v_hat)
    return params, losses, noisy


@pytest.mark.parametrize("arch", ARCHS)
def test_train_arch_smoke_trajectory_matches_reference(arch):
    """5 steps of the smoke trainer from the bridged init: every loss, and
    every param element at GRAD_TOL but the few whose Adam steps are
    conditioned by eps (C10), held within 2 * steps * lr."""
    _, jp = _ref_params(arch)
    tp, tl = t_train._train_lm(t_smoke(arch), bridge.params_to_torch(jp),
                               np.random.default_rng(0), N_STEPS, 8, "cpu")
    jp5, jl, noisy = _reference_steps(arch, jp)
    np.testing.assert_allclose(tl, jl, **GRAD_TOL)
    n_noisy = n_all = 0
    for (path, got), want, mask in zip(tree.flatten_with_path(tp),
                                       jax.tree_util.tree_leaves(jp5),
                                       jax.tree_util.tree_leaves(noisy)):
        got, want = _np(got), np.asarray(want)
        np.testing.assert_allclose(got[~mask], want[~mask], **GRAD_TOL,
                                   err_msg=str(path))
        assert np.all(np.abs(got[mask] - want[mask]) <= 2 * N_STEPS * 1e-3)
        n_noisy += int(mask.sum())
        n_all += mask.size
    assert n_noisy <= 0.01 * n_all, n_noisy


def test_train_arch_smoke_lm_entry_point_on_cpu():
    out = t_train.train_arch_smoke("qwen3-0.6b", n_steps=2, batch=4,
                                   device="cpu")
    assert set(out) == {"first_loss", "last_loss"}
    assert all(np.isfinite(v) for v in out.values())
