"""The hand-written CUDA kernels vs their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports only the port, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _merge_case(g, b, c, l, tied):
    if tied:
        cs = g.integers(0, 2, size=(b, c)).astype(np.float32)
        bl = g.integers(0, 3, size=(b, c, l)).astype(np.float32)
    else:
        cs = g.normal(size=(b, c)).astype(np.float32)
        bl = g.normal(size=(b, c, l)).astype(np.float32)
    bl = -np.sort(-bl, axis=-1)
    ln = g.integers(0, l + 1, size=(b, c)).astype(np.int32)
    return cs, bl, ln


@pytest.mark.parametrize("b,k,d,n", [(16, 300, 8, 40), (64, 4096, 64, 128),
                                     (3, 100, 6, 100)])
def test_cluster_rank_kernel_ties_bitwise(cuda, b, k, d, n):
    """Integer-valued inputs: exact sums, heavy ties, ties to lower ids."""
    g = np.random.default_rng(b + k)
    u = torch.from_numpy(g.integers(-2, 3, size=(b, d)).astype(np.float32))
    e = torch.from_numpy(g.integers(-1, 2, size=(k, d)).astype(np.float32))
    u, e = u.to(cuda), e.to(cuda)
    before = ops.LAUNCHES["cluster_rank"]
    vals, idx = ops.cluster_rank(u, e, n)
    rv, ri = ref.cluster_rank_ref(u, e, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cluster_rank"] == before + 1
    assert torch.equal(idx, ri)
    assert torch.equal(vals.view(torch.int32), rv.view(torch.int32))


def test_cluster_rank_kernel_random_close(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn((32, 64), generator=g, device=cuda)
    e = torch.randn((2048, 64), generator=g, device=cuda)
    vals, idx = ops.cluster_rank(u, e, 64)
    rv, ri = ref.cluster_rank_ref(u, e, 64)
    torch.testing.assert_close(vals, rv, rtol=1e-5, atol=1e-6)
    # ids differ only inside near-ties of the plain scores
    scores = u @ e.T
    diff = idx != ri
    got = torch.gather(scores, 1, idx.long())[diff]
    want = torch.gather(scores, 1, ri.long())[diff]
    assert torch.all((got - want).abs() <= 1e-5 * want.abs().clamp(min=1))


@pytest.mark.parametrize("c,l,chunk,target", [(128, 256, 8, 512),
                                              (13, 17, 4, 40), (1, 1, 1, 1),
                                              (300, 5, 3, 100)])
@pytest.mark.parametrize("exact", [True, False])
def test_merge_serve_kernel_bitwise(cuda, c, l, chunk, target, exact):
    g = np.random.default_rng(c * l)
    for tied in (False, True):
        args = [torch.from_numpy(x).to(cuda)
                for x in _merge_case(g, 16, c, l, tied)]
        pos, sc = ops.merge_serve(*args, chunk, target, exact=exact)
        rp, rs = ref.merge_serve_ref(*args, chunk, target, exact=exact)
        torch.cuda.synchronize()
        assert torch.equal(pos, rp)
        assert torch.equal(sc.view(torch.int32), rs.view(torch.int32))


def test_wrappers_reject_bad_inputs_on_card(cuda):
    u = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.cluster_rank(u.double(), u.double(), 2)
    with pytest.raises(ValueError):
        ops.cluster_rank(u, torch.zeros((16, 8), device=cuda).T, 2)
    with pytest.raises(ValueError):
        ops.cluster_rank(u, torch.zeros((16, 8)), 2)      # mixed devices
    cs = torch.zeros((2, 4), device=cuda)
    bl = torch.zeros((2, 4, 6), device=cuda)
    with pytest.raises(TypeError):
        ops.merge_serve(cs, bl, torch.zeros((2, 4), device=cuda), 2, 8)


# ---------------------------------------------------------------------------
# train-step kernels
# ---------------------------------------------------------------------------

def _near_tie_ok(scores, got, want, rel=1e-5):
    """ids may differ only where the plain scores of the two ids lie
    within ``rel`` of each other (relative to max(|score|, 1)): the
    kernel's fp32 sums run in another order than the plain GEMM's."""
    diff = got != want
    a = torch.gather(scores, 1, got.long()[:, None])[:, 0]
    b = torch.gather(scores, 1, want.long()[:, None])[:, 0]
    near = (a - b).abs() <= rel * b.abs().clamp(min=1.0)
    return bool(torch.all(near[diff]))


def _vq_scores(v, e, r):
    d2 = ((v * v).sum(-1, keepdim=True) - 2.0 * (v @ e.T)
          + (e * e).sum(-1)[None, :])
    return d2.clamp(min=0.0) * r[None, :]


@pytest.mark.parametrize("b,k,d", [(64, 128, 32), (100, 300, 48),
                                   (17, 1000, 64), (256, 512, 128),
                                   (1000, 16384, 64)])
def test_vq_assign_kernel_random_near_ties(cuda, b, k, d):
    g = torch.Generator(device=cuda).manual_seed(b + k)
    v = torch.randn((b, d), generator=g, device=cuda)
    e = torch.randn((k, d), generator=g, device=cuda)
    r = torch.rand((k,), generator=g, device=cuda) * 0.8 + 0.2
    before = ops.LAUNCHES["vq_assign"]
    got = ops.vq_assign(v, e, r)
    want = ref.vq_assign_ref(v, e, r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["vq_assign"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert _near_tie_ok(_vq_scores(v, e, r), got, want)


@pytest.mark.parametrize("b,k,d", [(64, 300, 8), (200, 4096, 64),
                                   (5, 129, 3)])
def test_vq_assign_kernel_ties_bitwise(cuda, b, k, d):
    """Integer-valued inputs, r in {0.5, 1}, planted duplicate clusters:
    exact sums, and ties go to the lower cluster id."""
    g = np.random.default_rng(b * k)
    v = g.integers(-2, 3, size=(b, d)).astype(np.float32)
    e = g.integers(-1, 2, size=(k, d)).astype(np.float32)
    e[k // 2:k // 2 + 3] = e[1]                     # planted ties
    r = np.where(g.random(k) < 0.5, 0.5, 1.0).astype(np.float32)
    v, e, r = (torch.from_numpy(x).to(cuda) for x in (v, e, r))
    got = ops.vq_assign(v, e, r)
    want = ref.vq_assign_ref(v, e, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_SOFTMAX_SHAPES = [(64, 16), (45, 20), (96, 24), (7, 8), (1000, 64),
                   (300, 128)]


def _softmax_inputs(cuda, b, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda)
            for s in ((b, d), (b, d), (b,), (b,), (b,))]


@pytest.mark.parametrize("b,d", _SOFTMAX_SHAPES)
def test_inbatch_softmax_kernels_match_plain(cuda, b, d):
    u, v, bias, lq, g = _softmax_inputs(cuda, b, d, b * d)
    before = dict(ops.LAUNCHES)
    loss, m, l = ops.inbatch_softmax_stats(u, v, bias, lq)
    rl, rm, rll = ref.inbatch_softmax_ref(u, v, bias, lq)
    lse = rm + torch.log(rll)
    got = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    want = ref.inbatch_softmax_bwd_ref(u, v, bias, lq, lse, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["inbatch_softmax"] == before["inbatch_softmax"] + 1
    assert (ops.LAUNCHES["inbatch_softmax_bwd"]
            == before["inbatch_softmax_bwd"] + 1)
    for a, w in zip((loss, m, l), (rl, rm, rll)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


def test_inbatch_softmax_bwd_kernel_is_deterministic(cuda):
    u, v, bias, lq, g = _softmax_inputs(cuda, 777, 64, 3)
    _, m, l = ops.inbatch_softmax_stats(u, v, bias, lq)
    lse = m + torch.log(l)
    a = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    b = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("b,k,d", [(40, 32, 8), (1000, 64, 16),
                                   (4096, 512, 64), (300, 1000, 128)])
def test_ema_segment_sum_kernel_matches_plain(cuda, b, k, d):
    g = np.random.default_rng(b + k)
    v = torch.from_numpy(g.normal(size=(b, d)).astype(np.float32)).to(cuda)
    a = g.integers(0, k, size=b).astype(np.int32)
    a[::7] = k                                       # outside [0, K)
    a[3::11] = -1
    a = torch.from_numpy(a).to(cuda)
    w = torch.from_numpy(g.uniform(0, 2, size=b).astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["ema_segment_sum"]
    w1, c1 = ops.ema_segment_sum(v, a, w, k)
    w2, c2 = ops.ema_segment_sum(v, a, w, k)
    rw, rc = ref.ema_segment_sum_ref(v, a, w, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ema_segment_sum"] == before + 2
    torch.testing.assert_close(w1, rw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c1, rc, rtol=1e-5, atol=1e-6)
    assert torch.equal(w1.view(torch.int32), w2.view(torch.int32))
    assert torch.equal(c1.view(torch.int32), c2.view(torch.int32))


def _errors_to_float64(v, a, w, k, *results):
    """Each (w_add, c_add) result's largest error against the float64 sum,
    asserted under n_k * eps * (sum of |w_j v_j| over the cluster's n_k
    rows), eps = 2^-23: float32 sums of n terms, in any order and each
    product rounded, err by at most about n * eps / 2 times that."""
    ew, ec = ref.ema_segment_sum_ref(v, a, w, k, torch.float64)
    aw, ac = ref.ema_segment_sum_ref(v.abs(), a, w.abs(), k, torch.float64)
    keep = (a >= 0) & (a < k)
    n = torch.bincount(a[keep].long(), minlength=k).double() * 2.0 ** -23
    out = []
    for rw, rc in results:
        dw, dc = (rw.double() - ew).abs(), (rc.double() - ec).abs()
        assert bool((dw <= n[:, None] * aw).all())
        assert bool((dc <= n * ac).all())
        out.append((float(dw.max()), float(dc.max())))
    return out


def test_ema_segment_sum_kernel_skewed_assignments(cuda):
    """Most rows in a few clusters (an early train step's assignments).
    The kernel is bitwise its own summation order done in plain PyTorch,
    and so the same across launches.  Against the float64 sum, it and the
    one-call plain version both lie within n * eps, and the kernel's
    w_add errs no more than the plain version's, whose sum of 14,000
    rows in one order (atomics on a card) is a longer chain than the
    kernel's row slices.  c_add is not compared: some orders of adding
    positive weights beat the slices."""
    g = np.random.default_rng(7)
    b, k, d = 20000, 1000, 64
    v = torch.from_numpy(g.normal(size=(b, d)).astype(np.float32)).to(cuda)
    a = np.where(g.random(b) < 0.7, 3, g.integers(0, 12, size=b))
    a[::50] = k
    a = torch.from_numpy(a.astype(np.int32)).to(cuda)
    w = torch.from_numpy(g.uniform(0, 2, size=b).astype(np.float32)).to(cuda)
    w1, c1 = ops.ema_segment_sum(v, a, w, k)
    pw, pc = ref.ema_segment_sum_ref(v, a, w, k)
    torch.cuda.synchronize()
    sw, sc = ref.ema_segment_sum_sliced_ref(v, a, w, k,
                                            ops.ema_segment_sum_slices())
    assert torch.equal(w1.cpu().view(torch.int32), sw.view(torch.int32))
    assert torch.equal(c1.cpu().view(torch.int32), sc.view(torch.int32))
    (kw, _), (plain_w, _) = _errors_to_float64(v, a, w, k, (w1, c1),
                                               (pw, pc))
    assert kw <= plain_w


def test_train_wrappers_reject_bad_inputs_on_card(cuda):
    v = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.vq_assign(v.double(), v.double(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        ops.vq_assign(v, v, torch.ones(3, device=cuda))
    b = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        ops.inbatch_softmax_stats(v, torch.zeros((5, 8), device=cuda), b, b)
    with pytest.raises(ValueError):
        ops.inbatch_softmax_stats(torch.zeros((4, 200), device=cuda),
                                  torch.zeros((4, 200), device=cuda), b, b)
    with pytest.raises(TypeError):
        ops.ema_segment_sum(v, torch.zeros(4, device=cuda), b, 3)


def test_train_step_on_card_matches_cpu(cuda):
    """One smoke-size step on the card and on the CPU from the same init
    and batch: losses and grads close, store clusters equal up to the
    near ties of vq_assign."""
    from repro_torch.configs.svq import smoke
    from repro_torch.core import retriever
    from repro_torch.data.streaming import RecsysStream, StreamConfig
    from repro_torch.utils import tree
    cfg = smoke()
    stream = RecsysStream(StreamConfig(n_items=cfg.n_items,
                                       n_users=cfg.n_users,
                                       hist_len=cfg.user_hist_len))
    imp, cand = stream.impression_batch(256), stream.candidate_batch(256)
    params, state = retriever.init(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    gc, sc, mc = retriever.train_step(params, state, cfg, imp, cand,
                                      device="cpu")
    before = dict(ops.LAUNCHES)
    gg, sg, mg = retriever.train_step(tree.to_device(params, cuda),
                                      tree.to_device(state, cuda), cfg, imp,
                                      cand, device=cuda)
    torch.cuda.synchronize()
    for name, n in (("vq_assign", 2), ("inbatch_softmax", 2),
                    ("inbatch_softmax_bwd", 2), ("ema_segment_sum", 1)):
        assert ops.LAUNCHES[name] == before[name] + n, name
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tree.leaves(gg), tree.leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    same = (sg.store.cluster.cpu() == sc.store.cluster).float().mean()
    assert float(same) >= 0.99
