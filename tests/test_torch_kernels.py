"""PyTorch port vs the JAX reference: the two serve-path kernels.

On the CPU the port's wrappers run their plain versions, which are held
to the JAX package's Pallas kernels (interpret mode), its lax references
and the heap oracle.  tests/test_torch_cuda.py holds each hand-written
kernel to its plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro.core import merge_sort as j_merge_sort
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.core import merge_sort as t_merge_sort
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


# ---------------------------------------------------------------------------
# cluster_rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,d,n,bb,bk", [
    (8, 64, 16, 8, 4, 32),
    (33, 500, 24, 16, 16, 128),       # non-divisible B and K
    (5, 100, 8, 100, 4, 32),          # n == K
    (128, 256, 32, 32, 128, 256),     # single K block
])
def test_cluster_rank_plain_matches_reference(rng, b, k, d, n, bb, bk):
    u = rng.normal(size=(b, d)).astype(np.float32)
    e = rng.normal(size=(k, d)).astype(np.float32)
    vals, idx = t_ops.cluster_rank(_t(u), _t(e), n)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    for name, (rv, ri) in (
            ("pallas", j_ops.cluster_rank(jnp.asarray(u), jnp.asarray(e), n,
                                          block_b=bb, block_k=bk)),
            ("lax", j_ref.cluster_rank_ref(jnp.asarray(u), jnp.asarray(e),
                                           n))):
        # CPU GEMMs of the two libraries round differently
        np.testing.assert_array_equal(np.asarray(ri), idx.numpy(),
                                      err_msg=name)
        np.testing.assert_allclose(np.asarray(rv), vals.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("b,k,d,n", [(16, 300, 8, 40), (4, 64, 4, 64)])
def test_cluster_rank_plain_ties_bitwise(rng, b, k, d, n):
    """Integer-valued inputs: every sum is exact, scores tie heavily, and
    ties go to the lower cluster id as in lax.top_k."""
    u = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    e = rng.integers(-1, 2, size=(k, d)).astype(np.float32)
    vals, idx = t_ops.cluster_rank(_t(u), _t(e), n)
    for rv, ri in (j_ops.cluster_rank(jnp.asarray(u), jnp.asarray(e), n,
                                      block_b=8, block_k=128),
                   j_ref.cluster_rank_ref(jnp.asarray(u), jnp.asarray(e), n)):
        np.testing.assert_array_equal(np.asarray(ri), idx.numpy())
        np.testing.assert_array_equal(_bits(rv), _bits(vals.numpy()))


def test_cluster_rank_rejects_n_above_k():
    with pytest.raises(ValueError):
        t_ops.cluster_rank(torch.zeros(2, 4), torch.zeros(8, 4), 9)


# ---------------------------------------------------------------------------
# merge_serve
# ---------------------------------------------------------------------------

def _random_case(rng, c, l, tied=False, b=None):
    shape = (c,) if b is None else (b, c)
    if tied:
        # few distinct values -> heavy score ties across and within
        # clusters; exercises the argmax-vs-heap tie-break equivalence
        cs = rng.integers(0, 2, size=shape).astype(np.float32)
        bl = rng.integers(0, 3, size=shape + (l,)).astype(np.float32)
    else:
        cs = rng.normal(size=shape).astype(np.float32)
        bl = rng.normal(size=shape + (l,)).astype(np.float32)
    bl = -np.sort(-bl, axis=-1)
    ln = rng.integers(0, l + 1, size=shape).astype(np.int32)
    return cs, bl, ln


def _assert_matches_reference(cs, bl, ln, chunk, target, exact=True,
                              heap=True):
    """Port plain (batched) == Pallas kernel == lax.scan, bitwise incl.
    padding; with ``exact`` and ``heap`` also == both heap oracles on the
    valid prefix."""
    pos, sc = t_ops.merge_serve(_t(cs), _t(bl), _t(ln), chunk, target,
                                exact=exact)
    assert pos.dtype == torch.int32 and sc.dtype == torch.float32
    pos, sc = pos.numpy(), sc.numpy()
    jcs, jbl, jln = map(jnp.asarray, (cs, bl, ln))
    pos_p, sc_p = j_ops.merge_serve(jcs, jbl, jln, chunk, target,
                                    exact=exact)
    pos_r, sc_r = j_ref.merge_serve_ref(jcs, jbl, jln, chunk, target,
                                        exact=exact)
    for name, rp, rs in (("pallas", pos_p, sc_p), ("lax", pos_r, sc_r)):
        np.testing.assert_array_equal(np.asarray(rp), pos, err_msg=name)
        np.testing.assert_array_equal(_bits(rs), _bits(sc), err_msg=name)
    if not (exact and heap):
        return
    for q in range(cs.shape[0]):
        for oracle in (j_merge_sort.merge_sort_serve_np,
                       t_merge_sort.merge_sort_serve_np):
            op, osc = oracle(cs[q], bl[q], ln[q], chunk, target)
            m = len(op)
            np.testing.assert_array_equal(op, pos[q, :m])
            assert np.all(pos[q, m:] == -1)
            np.testing.assert_array_equal(
                _bits(osc.astype(np.float32)), _bits(sc[q, :m]))
            assert np.all(sc[q, m:] == np.float32(t_merge_sort.NEG))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 12), st.integers(1, 24), st.integers(1, 8),
       st.integers(1, 48), st.integers(0, 10 ** 6))
def test_merge_serve_property_grid(c, l, chunk, target, seed):
    rng = np.random.default_rng(seed)
    cs, bl, ln = _random_case(rng, c, l, tied=bool(seed % 3 == 0), b=3)
    _assert_matches_reference(cs, bl, ln, chunk, target)


@pytest.mark.parametrize("c,l,chunk,target", [
    (1, 1, 1, 1),                     # degenerate single item
    (5, 7, 3, 10 ** 4),               # target >> total items
    (6, 3, 8, 12),                    # ALL clusters shorter than chunk
    (9, 11, 5, 9 * 11),               # target == total capacity
    (13, 17, 4, 40),                  # non-power-of-two everything
])
@pytest.mark.parametrize("exact", [True, False])
def test_merge_serve_edge_shapes(rng, c, l, chunk, target, exact):
    cs, bl, ln = _random_case(rng, c, l, b=4)
    _assert_matches_reference(cs, bl, ln, chunk, target, exact=exact)


@pytest.mark.parametrize("seed", range(4))
def test_merge_serve_ties_bitwise(seed):
    """Heap tie-break (-score, cluster) == first-max argmax: same pops."""
    cs, bl, ln = _random_case(np.random.default_rng(seed), 10, 12,
                              tied=True, b=4)
    _assert_matches_reference(cs, bl, ln, 4, 50)


def test_merge_serve_empty_clusters(rng):
    cs, bl, ln = _random_case(rng, 8, 16, b=3)
    ln[:, ::2] = 0                     # half the clusters empty
    ln[2] = 0                          # one query with ALL clusters empty
    _assert_matches_reference(cs, bl, ln, 4, 40)
    _assert_matches_reference(cs, bl, ln, 4, 40, exact=False)


def test_merge_serve_inexact_underfills_short_clusters(rng):
    """exact=False pops fewer times; with short clusters it under-fills,
    and its valid output is a prefix of the exact pop order."""
    cs, bl, ln = _random_case(rng, 10, 6, b=2)
    _assert_matches_reference(cs, bl, ln, 4, 30, exact=False)
    pos_e, _ = t_ops.merge_serve(_t(cs), _t(bl), _t(ln), 4, 30)
    pos_i, _ = t_ops.merge_serve(_t(cs), _t(bl), _t(ln), 4, 30, exact=False)
    for q in range(2):
        n_i = int((pos_i[q] >= 0).sum())
        np.testing.assert_array_equal(pos_i[q, :n_i].numpy(),
                                      pos_e[q, :n_i].numpy())
        assert n_i <= int((pos_e[q] >= 0).sum())


def test_merge_serve_nan_head_matches_reference(rng):
    """A NaN head wins the argmax (as argmax does) and emits nothing."""
    cs, bl, ln = _random_case(rng, 6, 9, b=2)
    bl[0, 2, :3] = np.nan
    ln[0, 2] = 9
    _assert_matches_reference(cs, bl, ln, 3, 20, heap=False)


# ---------------------------------------------------------------------------
# wrappers: the device decides
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_run_plain_and_count_no_launch(rng):
    t_ops.reset_launches()
    u = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    vals, idx = t_ops.cluster_rank(u, e, 5)
    rv, ri = t_ref.cluster_rank_ref(u, e, 5)
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    cs, bl, ln = _random_case(rng, 4, 6, b=2)
    t_ops.merge_serve(_t(cs), _t(bl), _t(ln), 2, 8)
    assert t_ops.LAUNCHES == {name: 0 for name in (
        "cluster_rank", "merge_serve", "vq_assign", "inbatch_softmax",
        "inbatch_softmax_bwd", "ema_segment_sum")}


def test_wrappers_raise_off_cpu_and_cuda():
    u = torch.empty((4, 8), device="meta")
    e = torch.empty((32, 8), device="meta")
    with pytest.raises(ValueError):
        t_ops.cluster_rank(u, e, 5)
    with pytest.raises(ValueError):
        t_ops.merge_serve(torch.empty((2, 4), device="meta"),
                          torch.empty((2, 4, 6), device="meta"),
                          torch.empty((2, 4), dtype=torch.int32,
                                      device="meta"), 2, 8)
