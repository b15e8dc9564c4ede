"""PyTorch port vs the JAX reference: the four train-step kernels.

On the CPU the port's wrappers run their plain versions (kernels/ref.py),
held here to the JAX package's Pallas kernels (interpret mode, through
repro.kernels.ops), its jnp references and jax.vjp of the dense
reference.  tests/test_torch_cuda.py holds each hand-written kernel to
its plain version on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as j_losses
from repro.core import vq as j_vq
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.core import losses as t_losses
from repro_torch.core import vq as t_vq
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

FWD_BWD_TOL = dict(rtol=1e-4, atol=1e-5)   # blocked sums vs dense autodiff
EMA_TOL = dict(rtol=1e-5, atol=1e-6)       # summation order differs


def _t(x):
    return torch.from_numpy(np.array(x))


def _vq_scores(v, e, r):
    v, e, r = (np.asarray(x, np.float64) for x in (v, e, r))
    d2 = (v * v).sum(-1)[:, None] - 2.0 * v @ e.T + (e * e).sum(-1)[None]
    return np.maximum(d2, 0.0) * r[None]


def _assert_ids_up_to_near_ties(got, want, scores, rel=1e-5):
    """ids equal, except where the two ids' scores lie within ``rel`` of
    each other (relative to max(|score|, 1)): the GEMMs of the two
    libraries sum in other orders."""
    got, want = np.asarray(got), np.asarray(want)
    rows = np.nonzero(got != want)[0]
    a = scores[rows, got[rows]]
    b = scores[rows, want[rows]]
    assert np.all(np.abs(a - b) <= rel * np.maximum(np.abs(b), 1.0)), rows


# ---------------------------------------------------------------------------
# vq_assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,d,bb,bk", [
    (64, 128, 32, 32, 64),
    (100, 300, 48, 32, 64),      # non-divisible -> the Pallas padding path
    (17, 1000, 64, 8, 256),
    (256, 512, 128, 128, 128),
])
def test_vq_assign_plain_matches_reference(rng, b, k, d, bb, bk):
    v = rng.normal(size=(b, d)).astype(np.float32)
    e = rng.normal(size=(k, d)).astype(np.float32)
    r = rng.uniform(0.2, 1.0, k).astype(np.float32)
    got = t_ops.vq_assign(_t(v), _t(e), _t(r))
    assert got.dtype == torch.int32 and got.shape == (b,)
    scores = _vq_scores(v, e, r)
    for want in (j_ops.vq_assign(jnp.asarray(v), jnp.asarray(e),
                                 jnp.asarray(r), block_b=bb, block_k=bk),
                 j_ref.vq_assign_ref(jnp.asarray(v), jnp.asarray(e),
                                     jnp.asarray(r))):
        _assert_ids_up_to_near_ties(got.numpy(), want, scores)


@pytest.mark.parametrize("b,k,d", [(32, 200, 8), (9, 70, 5)])
def test_vq_assign_plain_ties_bitwise(rng, b, k, d):
    """Integer inputs, r in {0.5, 1}, planted duplicate clusters: exact
    sums, ties to the lower cluster id (jnp.argmin's first minimum)."""
    v = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    e = rng.integers(-1, 2, size=(k, d)).astype(np.float32)
    e[k // 2:k // 2 + 3] = e[1]
    r = np.where(rng.random(k) < 0.5, 0.5, 1.0).astype(np.float32)
    got = t_ops.vq_assign(_t(v), _t(e), _t(r)).numpy()
    for want in (j_ops.vq_assign(jnp.asarray(v), jnp.asarray(e),
                                 jnp.asarray(r), block_b=8, block_k=64),
                 j_ref.vq_assign_ref(jnp.asarray(v), jnp.asarray(e),
                                     jnp.asarray(r))):
        np.testing.assert_array_equal(np.asarray(want), got)


def test_vq_assign_through_codebook_matches_reference(rng):
    """vq.assign: e = w / c and the Eq. 10 disturbance r from c."""
    w = rng.normal(size=(40, 12)).astype(np.float32)
    c = rng.uniform(0.01, 3.0, 40).astype(np.float32)
    v = rng.normal(size=(50, 12)).astype(np.float32)
    jstate = j_vq.VQState(w=jnp.asarray(w), c=jnp.asarray(c))
    tstate = t_vq.VQState(w=_t(w), c=_t(c))
    np.testing.assert_allclose(
        t_vq.disturbance(tstate.c, 5.0).numpy(),
        np.asarray(j_vq.disturbance(jstate.c, 5.0)), rtol=1e-6)
    got = t_vq.assign(tstate, _t(v), 5.0).numpy()
    e = np.asarray(jstate.embeddings())
    r = np.asarray(j_vq.disturbance(jstate.c, 5.0))
    for use_kernel in (False, True):
        want = j_vq.assign(jstate, jnp.asarray(v), 5.0,
                           use_kernel=use_kernel)
        _assert_ids_up_to_near_ties(got, want, _vq_scores(v, e, r))


# ---------------------------------------------------------------------------
# in-batch softmax forward and backward
# ---------------------------------------------------------------------------

_SOFTMAX_SHAPES = [(64, 16, 32, 32), (45, 20, 16, 16),   # ragged tiles
                   (96, 24, 256, 256), (7, 8, 4, 4)]


def _softmax_case(rng, b, d):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, d), (b, d), (b,), (b,), (b,))]


@pytest.mark.parametrize("b,d,bb,bc", _SOFTMAX_SHAPES)
def test_inbatch_softmax_forward_matches_reference(rng, b, d, bb, bc):
    u, v, bias, lq, _ = _softmax_case(rng, b, d)
    loss, m, l = t_ops.inbatch_softmax_stats(_t(u), _t(v), _t(bias), _t(lq))
    jl, jm, jll = j_ops.inbatch_softmax_stats(
        *map(jnp.asarray, (u, v, bias, lq)), block_b=bb, block_c=bc)
    for got, want, name in ((loss, jl, "loss"), (m, jm, "m"), (l, jll, "l")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **FWD_BWD_TOL)
    np.testing.assert_allclose(
        loss.numpy(), np.asarray(j_ref.inbatch_softmax_ref(
            *map(jnp.asarray, (u, v, bias, lq)))), **FWD_BWD_TOL)


@pytest.mark.parametrize("b,d,bb,bc", _SOFTMAX_SHAPES)
def test_inbatch_softmax_backward_matches_reference(rng, b, d, bb, bc):
    u, v, bias, lq, g = _softmax_case(rng, b, d)
    ju, jv, jb, jq, jg = map(jnp.asarray, (u, v, bias, lq, g))
    _, m, l = t_ops.inbatch_softmax_stats(_t(u), _t(v), _t(bias), _t(lq))
    lse = m + torch.log(l)
    got = t_ops.inbatch_softmax_bwd(_t(u), _t(v), _t(bias), _t(lq), lse,
                                    _t(g))
    _, vjp = jax.vjp(lambda *a: j_ref.inbatch_softmax_ref(*a), ju, jv, jb, jq)
    _, jm, jl = j_ops.inbatch_softmax_stats(ju, jv, jb, jq, block_b=bb,
                                            block_c=bc)
    pallas = j_ops.inbatch_softmax_bwd(ju, jv, jb, jq, jm + jnp.log(jl), jg,
                                       block_b=bb, block_c=bc)
    for want in (vjp(jg), pallas):
        for a, w, name in zip(got, want, ("du", "dv", "dbias", "dlogq")):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=name, **FWD_BWD_TOL)


@pytest.mark.parametrize("with_log_q", [True, False])
@pytest.mark.parametrize("b,d,bb,bc", _SOFTMAX_SHAPES[:2])
def test_inbatch_softmax_losses_match_reference(rng, b, d, bb, bc,
                                                with_log_q):
    """ops.inbatch_softmax and ref.inbatch_softmax_ref take the reference's
    arguments, log_q optional (None: no logQ term), and give its losses."""
    u, v, bias, lq, _ = _softmax_case(rng, b, d)
    jargs = [jnp.asarray(x) for x in (u, v, bias)]
    targs = [_t(x) for x in (u, v, bias)]
    if with_log_q:
        jargs.append(jnp.asarray(lq))
        targs.append(_t(lq))
    want_pallas = np.asarray(j_ops.inbatch_softmax(*jargs, block_b=bb,
                                                   block_c=bc))
    want_ref = np.asarray(j_ref.inbatch_softmax_ref(*jargs))
    got = t_ops.inbatch_softmax(*targs)
    got_ref, m, l = t_ref.inbatch_softmax_ref(*targs)
    assert got.shape == (b,)
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got.numpy(), want, **FWD_BWD_TOL)
        np.testing.assert_allclose(got_ref.numpy(), want, **FWD_BWD_TOL)
    np.testing.assert_allclose(
        (m + torch.log(l)).numpy(),
        np.asarray(jax.nn.logsumexp(
            jargs[0] @ jargs[1].T + jargs[2][None, :]
            - (jargs[3][None, :] if with_log_q else 0.0), axis=-1)),
        **FWD_BWD_TOL)
    if not with_log_q:
        zeros = torch.zeros(b)
        for x, y in zip(t_ops.inbatch_softmax_stats(*targs),
                        t_ops.inbatch_softmax_stats(*targs, zeros)):
            assert torch.equal(x, y)


def test_ce_rows_gradcheck_float64():
    """The autograd Function's backward is the VJP of its forward."""
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=g,
                        requires_grad=True)
            for s in ((9, 4), (9, 4), (9,), (9,))]
    assert torch.autograd.gradcheck(t_losses._ce_rows, args)


@pytest.mark.parametrize("with_valid", [False, True])
def test_l_aux_value_and_grads_match_reference(rng, with_valid):
    b, d = 52, 12
    u, v, bias, lq, _ = _softmax_case(rng, b, d)
    valid = rng.random(b) > 0.3 if with_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else _t(valid)
    f = lambda *a: j_losses.l_aux(*a, jnp.asarray(lq), valid=jvalid,
                                  use_kernel=True)
    jval, jgrads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        *map(jnp.asarray, (u, v, bias)))
    tu, tv, tb = (_t(x).requires_grad_(True) for x in (u, v, bias))
    tval = t_losses.l_aux(tu, tv, tb, _t(lq), valid=tvalid)
    tgrads = torch.autograd.grad(tval, (tu, tv, tb))
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for a, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FWD_BWD_TOL)


def test_dense_logits_path_is_not_ported():
    x = torch.zeros((4, 3))
    b = torch.zeros(4)
    with pytest.raises(NotImplementedError, match="A15"):
        t_losses.l_aux(x, x, b, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A15"):
        t_losses.l_ind(x, x, x, b, temperature=0.5)


# ---------------------------------------------------------------------------
# ema_segment_sum and the EMA update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,d,bb", [
    (64, 16, 8, 32), (100, 37, 24, 32), (17, 5, 16, 8), (256, 64, 32, 256),
])
def test_ema_segment_sum_plain_matches_reference(rng, b, k, d, bb):
    v = rng.normal(size=(b, d)).astype(np.float32)
    a = rng.integers(0, k + 1, b).astype(np.int32)   # k: outside [0, K)
    a[::9] = -1
    w = rng.uniform(0.0, 2.0, b).astype(np.float32)
    got = t_ops.ema_segment_sum(_t(v), _t(a), _t(w), k)
    ja, jv, jw = jnp.asarray(a), jnp.asarray(v), jnp.asarray(w)
    for want in (j_ops.ema_segment_sum(jv, ja, jw, k, block_b=bb),
                 j_ref.ema_segment_sum_ref(jv, ja, jw, k)):
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **EMA_TOL)


def test_ema_segment_sum_all_outside_is_zero(rng):
    v = _t(rng.normal(size=(24, 4)).astype(np.float32))
    w_k, c_k = t_ops.ema_segment_sum(v, torch.full((24,), 8, dtype=torch.int32),
                                     torch.ones(24), 8)
    assert float(w_k.abs().max()) == 0.0 and float(c_k.abs().max()) == 0.0


def _skewed_segment_case(rng, b=300, k=12, d=16):
    v = rng.normal(size=(b, d)).astype(np.float32)
    a = np.where(rng.random(b) < 0.7, 3, rng.integers(0, k, b))
    a[::13] = k                                      # outside [0, K)
    a[5::17] = -1
    w = rng.uniform(0.0, 2.0, b).astype(np.float32)
    return v, a.astype(np.int32), w, k


@pytest.mark.parametrize("slices", [1, 3, 16])
def test_ema_segment_sum_sliced_order_matches_reference(rng, slices):
    """The card kernel's summation order, done in plain PyTorch (the
    card tests hold the kernel bitwise to it), sums what the reference's
    segment_sum sums, on skewed assignments."""
    v, a, w, k = _skewed_segment_case(rng)
    got = t_ref.ema_segment_sum_sliced_ref(_t(v), _t(a), _t(w), k, slices)
    want = j_ref.ema_segment_sum_ref(jnp.asarray(v), jnp.asarray(a),
                                     jnp.asarray(w), k)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **EMA_TOL)


def test_ema_segment_sum_float64_is_the_exact_sum(rng):
    """The float64 plain version, the yardstick of the kernel's error on
    the card, against numpy's float64 sums."""
    v, a, w, k = _skewed_segment_case(rng)
    gw, gc = t_ref.ema_segment_sum_ref(_t(v), _t(a), _t(w), k,
                                       torch.float64)
    keep = (a >= 0) & (a < k)
    ww, wc = np.zeros((k, v.shape[1])), np.zeros(k)
    np.add.at(ww, a[keep], w[keep, None].astype(np.float64) * v[keep])
    np.add.at(wc, a[keep], w[keep].astype(np.float64))
    assert gw.dtype == torch.float64
    np.testing.assert_allclose(gw.numpy(), ww, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ema_update_matches_reference(rng, use_kernel):
    state = j_vq.init_vq(jax.random.PRNGKey(0), 32, 8)
    b = 40
    v = rng.normal(size=(b, 8)).astype(np.float32)
    a = rng.integers(0, 33, b).astype(np.int32)
    w = rng.uniform(0.0, 1.0, b).astype(np.float32)
    want = j_vq.ema_update(state, jnp.asarray(v), jnp.asarray(a),
                           jnp.asarray(w), 0.9, use_kernel=use_kernel)
    tstate = t_vq.VQState(w=_t(state.w), c=_t(state.c))
    got = t_vq.ema_update(tstate, _t(v), _t(a), _t(w), 0.9)
    for x, y, name in zip(got, want, want._fields):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=name,
                                   **EMA_TOL)


# ---------------------------------------------------------------------------
# wrappers: the device decides
# ---------------------------------------------------------------------------

def test_train_wrappers_on_cpu_run_plain_and_count_no_launch(rng):
    t_ops.reset_launches()
    v = _t(rng.normal(size=(6, 4)).astype(np.float32))
    r = torch.ones(6)
    assert torch.equal(t_ops.vq_assign(v, v, r), t_ref.vq_assign_ref(v, v, r))
    t_ops.inbatch_softmax_bwd(v, v, r, r, r, r)
    t_ops.inbatch_softmax_stats(v, v, r, r)
    t_ops.inbatch_softmax(v, v, r)
    t_ops.ema_segment_sum(v, torch.zeros(6, dtype=torch.int32), r, 3)
    assert t_ops.LAUNCHES == dict.fromkeys(t_ops.LAUNCHES, 0)


def test_train_wrappers_raise_off_cpu_and_cuda():
    m = torch.empty((4, 8), device="meta")
    mv = torch.empty((4,), device="meta")
    with pytest.raises(ValueError):
        t_ops.vq_assign(m, m, mv)
    with pytest.raises(ValueError):
        t_ops.inbatch_softmax_stats(m, m, mv, mv)
    with pytest.raises(ValueError):
        t_ops.inbatch_softmax_bwd(m, m, mv, mv, mv, mv)
    with pytest.raises(ValueError):
        t_ops.ema_segment_sum(m, torch.empty((4,), dtype=torch.int32,
                                             device="meta"), mv, 3)
