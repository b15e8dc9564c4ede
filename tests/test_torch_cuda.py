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


@pytest.mark.parametrize("b,k,n", [(512, 16384, 128), (512, 4096, 128),
                                   (1, 16384, 128), (37, 4096, 4096),
                                   (300, 16384, 16384), (5, 1000, 999),
                                   (70, 4096, 1)])
def test_cluster_rank_kernel_serve_and_shard_shapes(cuda, b, k, n):
    """The serve shape, the 4-shard shape (K/4 clusters), B = 1, ragged B
    and n up to K: tied integer inputs bitwise, random inputs within
    near-ties of the plain scores and bitwise across two launches."""
    g = np.random.default_rng(b + k + n)
    d = 64
    ut = torch.from_numpy(g.integers(-2, 3, size=(b, d)).astype(np.float32))
    et = torch.from_numpy(g.integers(-1, 2, size=(k, d)).astype(np.float32))
    ut, et = ut.to(cuda), et.to(cuda)
    tv, ti = ops.cluster_rank(ut, et, n)
    trv, tri = ref.cluster_rank_ref(ut, et, n)
    torch.cuda.synchronize()
    assert torch.equal(ti, tri)
    assert torch.equal(tv.view(torch.int32), trv.view(torch.int32))
    gen = torch.Generator(device=cuda).manual_seed(b * k + n)
    u = torch.randn((b, d), generator=gen, device=cuda)
    e = torch.randn((k, d), generator=gen, device=cuda) * 0.1
    vals, idx = ops.cluster_rank(u, e, n)
    vals2, idx2 = ops.cluster_rank(u, e, n)
    rv, ri = ref.cluster_rank_ref(u, e, n)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx2)
    assert torch.equal(vals.view(torch.int32), vals2.view(torch.int32))
    torch.testing.assert_close(vals, rv, rtol=1e-5, atol=1e-6)
    assert torch.all(vals[:, 1:] <= vals[:, :-1])
    scores = u @ e.T
    diff = idx != ri
    got = torch.gather(scores, 1, idx.long())[diff]
    want = torch.gather(scores, 1, ri.long())[diff]
    assert torch.all((got - want).abs() <= 1e-5 * want.abs().clamp(min=1))
    assert torch.all(torch.sort(idx, 1).values[:, 1:]
                     != torch.sort(idx, 1).values[:, :-1])


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


@pytest.mark.parametrize("b,d", [(1000, 1), (1000, 8), (777, 20),
                                 (4096, 64), (300, 128), (129, 64), (1, 64),
                                 (5000, 33), (65, 96)])
def test_inbatch_softmax_bwd_tensor_core_widths(cuda, b, d):
    """The tensor-core backward (3xTF32) at every padded width and ragged
    B, against plain at rtol 1e-4 / atol 1e-5.  u and v are drawn at
    scale 0.5, as chip_smoke.py draws them (logits of sd 2 at d=64);
    at unit scale the plain version's own fp32 logits move du by more
    than the tolerance, and the fp64 test below holds that case."""
    u, v, bias, lq, g = _softmax_inputs(cuda, b, d, 7 * b + d)
    u, v = u * 0.5, v * 0.5
    _, m, l = ref.inbatch_softmax_ref(u, v, bias, lq)
    lse = m + torch.log(l)
    before = ops.LAUNCHES["inbatch_softmax_bwd"]
    got = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    want = ref.inbatch_softmax_bwd_ref(u, v, bias, lq, lse, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["inbatch_softmax_bwd"] == before + 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,d,scale", [(2048, 64, 2.0), (129, 64, 1.0),
                                       (300, 128, 1.0), (5000, 33, 1.0)])
def test_inbatch_softmax_bwd_wide_logits_near_fp64(cuda, b, d, scale):
    """Wide logits (u, v of scale 2 at d=64: sd 16; unit scale at ragged
    B): the kernel and plain are each held to an fp64 backward, the
    kernel within plain's own largest error plus rtol 1e-4 / atol 1e-5."""
    u, v, bias, lq, g = _softmax_inputs(cuda, b, d, 5 + b)
    u, v = u * scale, v * scale
    _, m, l = ref.inbatch_softmax_ref(u, v, bias, lq)
    lse = m + torch.log(l)
    got = ops.inbatch_softmax_bwd(u, v, bias, lq, lse, g)
    plain = ref.inbatch_softmax_bwd_ref(u, v, bias, lq, lse, g)
    exact = ref.inbatch_softmax_bwd_ref(
        *(x.double() for x in (u, v, bias, lq, lse, g)))
    torch.cuda.synchronize()
    for k, p, x in zip(got, plain, exact):
        plain_err = float((p.double() - x).abs().max())
        assert torch.all((k.double() - x).abs()
                         <= plain_err + 1e-5 + 1e-4 * x.abs())


def test_inbatch_softmax_losses_on_card(cuda):
    """ops.inbatch_softmax is one forward launch, bitwise the stats' loss;
    log_q=None is bitwise log_q of zeros."""
    u, v, bias, lq, _ = _softmax_inputs(cuda, 1000, 64, 11)
    before = ops.LAUNCHES["inbatch_softmax"]
    loss = ops.inbatch_softmax(u, v, bias, lq)
    assert ops.LAUNCHES["inbatch_softmax"] == before + 1
    stats = ops.inbatch_softmax_stats(u, v, bias, lq)
    torch.cuda.synchronize()
    assert loss.shape == (1000,)
    assert torch.equal(loss.view(torch.int32), stats[0].view(torch.int32))
    zeros = torch.zeros_like(bias)
    assert torch.equal(ops.inbatch_softmax(u, v, bias).view(torch.int32),
                       ops.inbatch_softmax(u, v, bias, zeros)
                       .view(torch.int32))
    for a, z in zip(ops.inbatch_softmax_stats(u, v, bias),
                    ops.inbatch_softmax_stats(u, v, bias, zeros)):
        assert torch.equal(a.view(torch.int32), z.view(torch.int32))


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


# ---------------------------------------------------------------------------
# fused serve path and logical-shard serving
# ---------------------------------------------------------------------------

def _slab_case(g, b, c, l, d, tail=3, integer=False, nan_tail=False):
    """Flat index laid out as C slabs of L items (cluster c at c*L) plus a
    tail; with ``nan_tail`` every lane past a cluster's length holds NaN
    (lengths shared by all queries), and the clean bias is returned too."""
    n = c * l + tail
    if integer:
        cs = g.integers(-2, 3, size=(b, c)).astype(np.float32)
        slab = -np.sort(-g.integers(-2, 3, size=(c, l)), axis=1)
        emb = g.integers(-2, 3, size=(n, d)).astype(np.float32)
        u = g.integers(-2, 3, size=(b, d)).astype(np.float32)
    else:
        cs = g.normal(size=(b, c)).astype(np.float32)
        slab = -np.sort(-g.normal(size=(c, l)), axis=1)
        emb = g.normal(size=(n, d)).astype(np.float32)
        u = g.normal(size=(b, d)).astype(np.float32)
    slab = slab.astype(np.float32)
    starts = np.broadcast_to(np.arange(c, dtype=np.int32) * l, (b, c))
    lengths = np.broadcast_to(g.integers(0, l + 1, size=c).astype(np.int32),
                              (b, c))
    bias = np.concatenate([slab.reshape(-1),
                           g.normal(size=tail).astype(np.float32)])
    clean = bias.copy()
    if nan_tail:
        for ci in range(c):
            bias[ci * l + lengths[0, ci]:(ci + 1) * l] = np.nan
    limits = np.full((b, c), n - 1, np.int32)
    ids = g.permutation(n).astype(np.int32)
    arrays = (u, cs, starts.copy(), lengths.copy(), limits, bias, ids, emb)
    return arrays, clean


def _sharded_case(g, b, c, l, d, shards, cap):
    """Flat (shards * cap) layout whose lanes clamp at their shard's last
    slot; many lists run past the end of their shard."""
    n = shards * cap
    owner = g.integers(0, shards, size=(b, c))
    local = g.integers(cap // 2, cap + 1, size=(b, c))
    starts = (owner * cap + local).astype(np.int32)
    limits = (owner * cap + cap - 1).astype(np.int32)
    lengths = g.integers(0, l + 1, size=(b, c)).astype(np.int32)
    cs = g.normal(size=(b, c)).astype(np.float32)
    bias = g.normal(size=n).astype(np.float32)
    ids = g.permutation(n).astype(np.int32)
    emb = g.normal(size=(n, d)).astype(np.float32)
    u = g.normal(size=(b, d)).astype(np.float32)
    return u, cs, starts, lengths, limits, bias, ids, emb


def _serve_case(g, b, k, c, l, d, n):
    """A flat index of K clusters over N items (each cluster's biases
    sorted descending), and C clusters drawn per query."""
    offs = np.concatenate([[0], np.sort(g.integers(0, n + 1, k - 1)), [n]])
    seg = np.repeat(np.arange(k), np.diff(offs))
    bias = g.normal(size=n).astype(np.float32)
    bias = bias[np.lexsort((-bias, seg))]
    cl = g.integers(0, k, size=(b, c))
    starts = offs[cl].astype(np.int32)
    lengths = np.minimum(np.diff(offs)[cl], l).astype(np.int32)
    limits = np.full((b, c), n - 1, np.int32)
    cs = -np.sort(-g.normal(size=(b, c)).astype(np.float32), axis=1)
    ids = g.permutation(n).astype(np.int32)
    emb = (g.normal(size=(n, d)) * 0.1).astype(np.float32)
    u = g.normal(size=(b, d)).astype(np.float32)
    return u, cs, starts, lengths, limits, bias, ids, emb


def _check_fused(cuda, arrays, chunk, target, l, bitwise_rank=False,
                 want_arrays=None):
    """Kernel on ``arrays`` vs plain on ``want_arrays`` (default the
    same): pos, merge_scores, cand_ids bitwise, exact_scores close."""
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in arrays]
    wargs = args if want_arrays is None else [
        torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        for x in want_arrays]
    before = ops.LAUNCHES["fused_gather_rank"]
    got = ops.fused_gather_rank(*args, chunk, target, l)
    want = ref.fused_gather_rank_ref(*wargs, chunk, target, l)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_gather_rank"] == before + 1
    for name, a, w in zip(("pos", "merge_scores", "cand_ids", "exact"),
                          got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        if name == "exact" and not bitwise_rank:
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
        elif a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name
        else:
            assert torch.equal(a, w), name
    return got


@pytest.mark.parametrize("b,c,l,d,chunk,target", [
    (2, 6, 10, 8, 4, 25), (3, 13, 17, 12, 3, 70), (1, 5, 3, 4, 8, 9),
    (16, 128, 40, 64, 8, 512), (4, 300, 7, 5, 2, 100)])
def test_fused_gather_rank_kernel_matches_plain(cuda, b, c, l, d, chunk,
                                                target):
    g = np.random.default_rng(b * c + l)
    arrays, _ = _slab_case(g, b, c, l, d)
    _check_fused(cuda, arrays, chunk, target, l)
    ints, _ = _slab_case(g, b, c, l, d, integer=True)
    _check_fused(cuda, ints, chunk, target, l, bitwise_rank=True)


def test_fused_gather_rank_kernel_at_serve_shape(cuda):
    """B=512, C=128, L=256, chunk 8, S=512, d=64 over 2**21 items."""
    g = np.random.default_rng(0)
    arrays = _serve_case(g, 512, 16384, 128, 256, 64, 1 << 21)
    pos = _check_fused(cuda, arrays, 8, 512, 256)[0]
    assert bool((pos >= 0).all())


@pytest.mark.parametrize("shards,cap", [(4, 64), (3, 17)])
def test_fused_gather_rank_kernel_sharded_limits(cuda, shards, cap):
    """Per-lane clamps at each shard's last slot, with lists that run past
    the end of their shard."""
    g = np.random.default_rng(shards * cap)
    arrays = _sharded_case(g, 8, 24, 40, 16, shards, cap)
    _check_fused(cuda, arrays, 4, 150, 40)


def test_fused_gather_rank_kernel_nan_dead_tail(cuda):
    """NaN in every lane past a cluster's length changes nothing."""
    g = np.random.default_rng(3)
    arrays, clean = _slab_case(g, 4, 9, 12, 8, nan_tail=True)
    want = list(arrays)
    want[5] = clean
    _check_fused(cuda, arrays, 4, 40, 12, want_arrays=want)


def test_fused_gather_rank_kernel_n_below_chunk(cuda):
    """N < chunk: the kernel needs no padding."""
    g = np.random.default_rng(4)
    b, c, d, n = 3, 2, 4, 3
    arrays = (g.normal(size=(b, d)).astype(np.float32),
              g.normal(size=(b, c)).astype(np.float32),
              np.zeros((b, c), np.int32), np.full((b, c), n, np.int32),
              np.full((b, c), n - 1, np.int32),
              -np.sort(-g.normal(size=n)).astype(np.float32),
              np.arange(n, dtype=np.int32),
              g.normal(size=(n, d)).astype(np.float32))
    _check_fused(cuda, arrays, 8, 10, 5)


@pytest.mark.parametrize("c,l,chunk,target", [(128, 256, 8, 512),
                                              (13, 17, 4, 40), (6, 3, 8, 9),
                                              (7, 32, 16, 100)])
def test_merge_serve_ds_kernel_bitwise(cuda, c, l, chunk, target):
    """The ds launch: bitwise its plain version and the merge_serve
    kernel, also for L < chunk."""
    g = np.random.default_rng(c + l)
    for tied in (False, True):
        args = [torch.from_numpy(x).to(cuda)
                for x in _merge_case(g, 16, c, l, tied)]
        before = dict(ops.LAUNCHES)
        pos, sc = ops.merge_serve_ds(*args, chunk, target)
        kp, ks = ops.merge_serve(*args, chunk, target)
        rp, rs = ref.merge_serve_ds_ref(*args, chunk, target)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["merge_serve_ds"] == before["merge_serve_ds"] + 1
        for p, s in ((rp, rs), (kp, ks)):
            assert torch.equal(pos, p)
            assert torch.equal(sc.view(torch.int32), s.view(torch.int32))


def test_fused_kernels_do_not_fall_back_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel or the wrapper raises: with the
    kernel library unloadable, no plain result comes back."""
    from repro_torch.kernels import build

    def fail(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", fail)
    g = np.random.default_rng(5)
    arrays, _ = _slab_case(g, 2, 4, 6, 8)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in arrays]
    with pytest.raises(RuntimeError, match="cannot load"):
        ops.fused_gather_rank(*args, 2, 8, 6)
    ms = [torch.from_numpy(x).to(cuda) for x in _merge_case(g, 2, 4, 6,
                                                            False)]
    with pytest.raises(RuntimeError, match="cannot load"):
        ops.merge_serve_ds(*ms, 2, 8)
    with pytest.raises(TypeError):
        ops.fused_gather_rank(args[0], args[1], args[2].long(), *args[3:],
                              2, 8, 6)


def _smoke_service_inputs():
    from repro_torch.configs.svq import smoke
    from repro_torch.core import assignment_store as astore
    from repro_torch.core import retriever
    cfg = smoke()
    gen = torch.Generator().manual_seed(0)
    params, state = retriever.init(gen, cfg, device="cpu")
    ids = torch.arange(cfg.n_items)
    cate = torch.randint(0, 4096, (cfg.n_items,), generator=gen)
    _, v_emb, v_bias = retriever.index_forward(
        params, cfg, torch.zeros(1, 2 * cfg.item_embed_dim),
        retriever.item_features(params, ids, cate))
    clusters = torch.randint(0, cfg.n_clusters, (cfg.n_items,),
                             generator=gen)
    state = state._replace(store=astore.write(state.store, ids, clusters,
                                              v_emb, v_bias))
    g = np.random.default_rng(0)
    batch = dict(user_id=g.integers(0, cfg.n_users, 32).astype(np.int32),
                 hist=g.integers(0, cfg.n_items, (32, cfg.user_hist_len))
                 .astype(np.int32))
    return cfg, params, state, batch


@pytest.mark.parametrize("fused,n_shards", [(True, None), (False, 4),
                                            (True, 4), (True, 8)])
def test_fused_and_sharded_service_on_card_match_single_device(
        cuda, fused, n_shards):
    """On the card the fused and the sharded services give the
    single-device unfused service's candidates and scores bit for bit
    (the cluster_rank kernel scores each cluster alone, so a shard's
    slice of the codebook scores the same), exact_scores up to summation
    order; and each kernel of the path runs once per batch (cluster_rank
    once per shard)."""
    from repro_torch.serving.service import RetrievalService
    cfg, params, state, batch = _smoke_service_inputs()
    want = RetrievalService(cfg, params, state, device=cuda).serve_batch(
        batch)
    svc = RetrievalService(cfg, params, state, fused=fused,
                           n_shards=n_shards, device=cuda)
    ops.reset_launches()
    got = svc.serve_batch(batch)
    assert ops.LAUNCHES["cluster_rank"] == (n_shards or 1)
    assert ops.LAUNCHES["fused_gather_rank"] == int(fused)
    assert ops.LAUNCHES["merge_serve"] == int(not fused)
    assert set(got) == set(want)
    for k in want:
        if k == "exact_scores":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["valid"].any()


# ---------------------------------------------------------------------------
# topk_dot and the exact MIPS oracle
# ---------------------------------------------------------------------------

NEG = -1e30


def _topk_case(g, b, n, d, integer=False, dup=0, masked=0):
    """u (B, d), items (N, d), bias (N,) as numpy fp32.  ``dup`` items
    repeat item 0 at spread slots (ties across blocks); ``masked`` slots
    get zero rows and bias NEG (the oracle's empty slots)."""
    if integer:
        u = g.integers(-2, 3, size=(b, d)).astype(np.float32)
        items = g.integers(-1, 2, size=(n, d)).astype(np.float32)
        bias = g.integers(-2, 3, size=n).astype(np.float32)
    else:
        u = g.normal(size=(b, d)).astype(np.float32)
        items = g.normal(size=(n, d)).astype(np.float32)
        bias = g.normal(size=n).astype(np.float32)
    if dup:
        at = g.choice(n, size=dup, replace=False)
        items[at], bias[at] = items[0], bias[0]
    if masked:
        at = g.choice(n, size=masked, replace=False)
        items[at], bias[at] = 0.0, NEG
    return u, items, bias


def _check_topk(cuda, u, items, bias, k, bitwise, block_n=None):
    u, items, bias = (torch.from_numpy(x).to(cuda) for x in (u, items, bias))
    before = ops.LAUNCHES["topk_dot"]
    vals, idx = ops.topk_dot(u, items, bias, k, block_n=block_n)
    rv, ri = ref.topk_dot_ref(u, items, bias, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_dot"] == before + 1
    assert vals.shape == rv.shape and idx.dtype == torch.int32
    if bitwise:
        assert torch.equal(idx, ri)
        assert torch.equal(vals.view(torch.int32), rv.view(torch.int32))
        return vals, idx
    torch.testing.assert_close(vals, rv, rtol=1e-5, atol=1e-6)
    u2 = u.reshape(-1, u.shape[-1]).float()
    scores = u2 @ items.float().T + bias.float()
    assert _near_tie_ok_rows(scores, idx.reshape(u2.shape[0], -1),
                             ri.reshape(u2.shape[0], -1))
    return vals, idx


def _near_tie_ok_rows(scores, got, want, rel=1e-5):
    a = torch.gather(scores, 1, got.long())
    b = torch.gather(scores, 1, want.long())
    near = (a - b).abs() <= rel * b.abs().clamp(min=1.0)
    return bool(torch.all(near[got != want]))


@pytest.mark.parametrize("b,n,d,k,block_n,dup,masked", [
    (1, 1000, 32, 8, 256, 0, 0), (1, 5000, 64, 50, 512, 40, 0),
    (1, 777, 16, 16, 128, 0, 0),           # N not a multiple of the block
    (3, 300, 8, 300, 4096, 0, 0),          # k == N
    (1, 3000, 64, 512, 1024, 100, 2600),   # fewer live slots than k
    (70, 20000, 64, 20, None, 300, 500), (17, 4099, 24, 11, 128, 10, 0)])
def test_topk_dot_kernel_ties_bitwise(cuda, b, n, d, k, block_n, dup,
                                      masked):
    """Integer-valued inputs with planted ties within and across blocks:
    values and ids bitwise the plain version, ties to the lower index."""
    g = np.random.default_rng(n + k)
    u, items, bias = _topk_case(g, b, n, d, integer=True, dup=dup,
                                masked=masked)
    _check_topk(cuda, u[0] if b == 1 else u, items, bias, k, True, block_n)


@pytest.mark.parametrize("b,n,d,k", [(1, 100_000, 64, 512),
                                     (1, 100_000, 64, 50),
                                     (512, 50_000, 64, 20), (33, 999, 7, 9)])
def test_topk_dot_kernel_random_near_ties(cuda, b, n, d, k):
    g = np.random.default_rng(b + n)
    u, items, bias = _topk_case(g, b, n, d)
    _check_topk(cuda, u, items, bias, k, False)


def test_topk_dot_kernel_bf16_and_block_n(cuda):
    """bf16 inputs are upcast (exact), so bf16 is the fp32 result on the
    upcast inputs; the result does not depend on block_n."""
    g = np.random.default_rng(7)
    u, items, bias = (torch.from_numpy(x).to(cuda).to(torch.bfloat16)
                      for x in _topk_case(g, 5, 3000, 24))
    want = ops.topk_dot(u.float(), items.float(), bias.float(), 11)
    for block_n in (128, 300, 4096, None):
        got = ops.topk_dot(u, items, bias, 11, block_n=block_n)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def test_topk_dot_rejects_bad_inputs_on_card(cuda):
    items = torch.zeros((10, 4), device=cuda)
    bias = torch.zeros((10,), device=cuda)
    with pytest.raises(ValueError):
        ops.topk_dot(torch.zeros(4, device=cuda), items, bias, 11)   # k > N
    with pytest.raises(ValueError):
        ops.topk_dot(torch.zeros(5, device=cuda), items, bias, 3)    # width
    with pytest.raises(TypeError):
        ops.topk_dot(torch.zeros(4, device=cuda, dtype=torch.int32), items,
                     bias, 3)


def test_mips_topk_on_card_launches_the_kernel(cuda, monkeypatch):
    """mips_topk on CUDA tensors is one topk_dot launch, bitwise the plain
    version on integer inputs (bias None = zero); with the kernel library
    unloadable it raises instead of falling back."""
    from repro_torch.baselines import brute_force
    from repro_torch.kernels import build
    g = np.random.default_rng(11)
    u, items, _ = _topk_case(g, 40, 5000, 16, integer=True, dup=50)
    u, items = torch.from_numpy(u).to(cuda), torch.from_numpy(items).to(cuda)
    before = ops.LAUNCHES["topk_dot"]
    vals, idx = brute_force.mips_topk(u, items, None, 30)
    rv, ri = ref.topk_dot_ref(u, items, torch.zeros(5000, device=cuda), 30)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_dot"] == before + 1
    assert torch.equal(idx, ri) and torch.equal(vals, rv)

    def fail(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", fail)
    with pytest.raises(RuntimeError, match="cannot load"):
        brute_force.mips_topk(u, items, None, 30)


# ---------------------------------------------------------------------------
# embedding_bag (the recsys families' bag lookup)
# ---------------------------------------------------------------------------

def _embag_case(g, v, d, b, bag, integer, dtype=torch.float32, id64=True,
                scale=None):
    """Integer-valued or N(0, scale^2) tables (the models' 1/sqrt(d) unless
    ``scale`` is given) and ids that hit the first and last rows and
    repeat an id inside a bag."""
    if integer:
        table = g.integers(-8, 9, size=(v, d)).astype(np.float32)
    else:
        table = (g.normal(size=(v, d))
                 * (d ** -0.5 if scale is None else scale)).astype(np.float32)
    ids = g.integers(0, v, size=(b, bag))
    ids[0, :] = 0                          # the first row, repeated
    ids[-1, 0] = v - 1                     # the last row
    if bag > 1:
        ids[1, 1] = ids[1, 0]              # a repeated id inside a bag
    return (torch.from_numpy(table).to(dtype),
            torch.from_numpy(ids.astype(np.int64 if id64 else np.int32)))


def _bits(t):
    return t.view(torch.int32)


def _order_bound(table, ids, combiner):
    """Per element, what two fp32 sums of the same bag in different orders
    may differ by: bag * eps * sum|x| (each order is within
    (bag-1) * eps/2 * sum|x| of the exact sum); for the mean, that over
    bag plus the quotient's own rounding."""
    bag = ids.shape[-1]
    eps = torch.finfo(torch.float32).eps
    mag = table[ids.long()].float().abs().sum(-2)     # gathered, not V x d
    if combiner == "mean":
        return eps * mag + eps * ref.embedding_bag_ref(table, ids,
                                                       "mean").abs()
    return bag * eps * mag


def _within_order_bound(got, table, ids, combiner):
    err = (got - ref.embedding_bag_ref(table, ids, combiner)).abs()
    assert bool((err <= _order_bound(table, ids, combiner)).all()), \
        float(err.max())


@pytest.mark.parametrize("v,d,b,bag", [
    (1000, 64, 513, 20),     # DLRM's width and bag, B odd
    (5000, 256, 64, 50),     # two-tower's width and bag
    (300, 12, 37, 5),        # d = 12: 3 slots of 4
    (300, 6, 9, 3),          # d % 4 != 0: one element a load
    (200, 8, 5, 130),        # bag > 64: ids staged in chunks
    (50, 4, 301, 1)])        # one slot a row, 64 rows a block
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("id64", [True, False])
def test_embedding_bag_kernel_integer_tables_bitwise(cuda, v, d, b, bag,
                                                     combiner, id64):
    """Integer-valued tables: every sum is exact, so the kernel is bitwise
    the plain version (the mean too: both divide by bag)."""
    g = np.random.default_rng(v + d + bag)
    table, ids = _embag_case(g, v, d, b, bag, True, id64=id64)
    table, ids = table.to(cuda), ids.to(cuda)
    before = ops.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(table, ids, combiner)
    want = ref.embedding_bag_ref(table, ids, combiner)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["embedding_bag"] == before + 1
    assert got.shape == (b, d) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_kernel_random_and_bf16(cuda, combiner):
    """Random fp32 tables at the models' N(0, 1/d) scale within rtol 1e-6
    / atol 1e-6 of the plain version (sums in another order: the error
    scales with the summed terms, not the result), bitwise across
    launches; a bf16 table is read in place and equals the fp32 result on
    the widened table."""
    g = np.random.default_rng(3)
    table, ids = _embag_case(g, 4000, 64, 777, 20, False)
    table, ids = table.to(cuda), ids.to(cuda)
    got = ops.embedding_bag(table, ids, combiner)
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, ids,
                                                          combiner),
                               rtol=1e-6, atol=1e-6)
    _within_order_bound(got, table, ids, combiner)
    assert torch.equal(_bits(got), _bits(ops.embedding_bag(table, ids,
                                                           combiner)))
    t16 = table.to(torch.bfloat16)
    got16 = ops.embedding_bag(t16, ids, combiner)
    assert torch.equal(_bits(got16),
                       _bits(ops.embedding_bag(t16.float(), ids, combiner)))
    torch.testing.assert_close(got16, ref.embedding_bag_ref(t16, ids,
                                                            combiner),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e3])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_kernel_within_summation_order_bound(cuda, scale,
                                                           combiner):
    """Random fp32 tables at any scale: kernel and plain version sum each
    bag in their own orders, so they agree within bag * eps * sum|x|
    per element, a bound that scales with the summed terms."""
    g = np.random.default_rng(4)
    table, ids = _embag_case(g, 4000, 64, 777, 20, False, scale=scale)
    table, ids = table.to(cuda), ids.to(cuda)
    _within_order_bound(ops.embedding_bag(table, ids, combiner), table, ids,
                        combiner)


def test_embedding_bag_kernel_unaligned_table_and_bad_ids(cuda):
    """A table view whose base is not 16-byte aligned takes the
    one-element path with the same bits; an id outside [0, V) makes its
    row NaN and no other; bad dtypes and shapes raise."""
    g = np.random.default_rng(5)
    table, ids = _embag_case(g, 100, 8, 20, 4, True)
    buf = torch.zeros(100 * 8 + 1, device=cuda)
    view = buf[1:].view(100, 8)
    view.copy_(table.to(cuda))
    ids = ids.to(cuda)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(_bits(ops.embedding_bag(view, ids)),
                       _bits(ops.embedding_bag(table.to(cuda), ids)))
    bad = ids.clone()
    bad[3, 2] = 100
    bad[7, 0] = -1
    out = ops.embedding_bag(table.to(cuda), bad)
    nan_rows = torch.isnan(out).all(dim=1)
    assert nan_rows.tolist() == [i in (3, 7) for i in range(20)]
    with pytest.raises(TypeError):
        ops.embedding_bag(table.to(cuda).half(), ids)
    with pytest.raises(TypeError):
        ops.embedding_bag(table.to(cuda), ids.float())
    with pytest.raises(ValueError):
        ops.embedding_bag(table.to(cuda), ids[:, 0])


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_autograd_through_the_kernel(cuda, combiner):
    """The table's gradient through the kernel equals the plain version's
    autograd gradient (index_add_ adds repeated ids with atomics, in no
    fixed order, hence allclose); a table that needs no gradient gets
    none."""
    g = np.random.default_rng(9)
    table, ids = _embag_case(g, 60, 16, 40, 7, False)
    table, ids = table.to(cuda), ids.to(cuda)
    w = torch.from_numpy(g.normal(size=(40, 16)).astype(np.float32)).to(cuda)
    t1 = table.clone().requires_grad_(True)
    (ops.embedding_bag(t1, ids, combiner) * w).sum().backward()
    t2 = table.clone().requires_grad_(True)
    (ref.embedding_bag_ref(t2, ids, combiner) * w).sum().backward()
    assert t1.grad is not None
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-6)
    out = ops.embedding_bag(table, ids, combiner)
    assert not out.requires_grad


def test_recsys_smoke_models_launch_embedding_bag_on_card(cuda):
    """DLRM's forward launches the kernel once per multi-hot table and
    two-tower's encode_user once; both serve as on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import _smoke_recsys_batch
    from repro_torch.models.recsys import _RECSYS_MODS
    from repro_torch.utils import tree
    for arch, want in (("dlrm-rm2", 2), ("two-tower-retrieval", 1)):
        cfg = get_smoke(arch)
        mod = _RECSYS_MODS[cfg.kind]
        p = mod.init(torch.Generator().manual_seed(0), cfg, "cpu")
        batch = _smoke_recsys_batch(cfg, np.random.default_rng(0), 16, "cpu")
        cpu = mod.serve(p, cfg, batch)
        before = ops.LAUNCHES["embedding_bag"]
        got = mod.serve(tree.to_device(p, cuda), cfg,
                        tree.to_device(batch, cuda))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["embedding_bag"] == before + want
        torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# flash_attention (the LM family's attention, ROADMAP B11)
# ---------------------------------------------------------------------------

def _attn_case(g, b, s, t, h, hk, hd, dtype, cuda):
    q, k, v = (torch.from_numpy(g.normal(size=shape).astype(np.float32))
               .to(cuda).to(dtype)
               for shape in ((b, s, h, hd), (b, t, hk, hd), (b, t, hk, hd)))
    return q, k, v


def _attn_tol(dtype):
    # fp32: the reference's own sweep (tests/test_kernels.py); bf16: kernel
    # and plain version both compute in fp32 and round once, so they differ
    # by at most one bf16 ulp (at most 2^-7 of the value)
    return (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


@pytest.mark.parametrize("s,hd,causal,dtype", [
    (128, 64, True, torch.float32), (256, 32, False, torch.float32),
    (128, 128, True, torch.float32), (64, 16, True, torch.float32),
    (48, 20, True, torch.float32), (48, 20, True, torch.bfloat16)])
def test_flash_attention_kernel_single_head_matches_plain(cuda, s, hd, causal,
                                                          dtype):
    """The reference's single-head (S, hd) cases, kernel vs plain."""
    q, k, v = (x[0, :, 0] for x in _attn_case(np.random.default_rng(s + hd),
                                              1, s, s, 1, 1, hd, dtype, cuda))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (s, hd) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("b,s,t,h,hk,hd,causal", [
    (2, 100, 100, 6, 2, 64, True),       # GQA 3:1, ragged S
    (1, 4100, 4100, 2, 1, 128, True),    # ragged past many tiles
    (3, 37, 70, 4, 4, 32, True),         # T > S: causal offset T - S
    (2, 70, 37, 4, 2, 8, False),         # T < S, no mask
    (1, 65, 65, 2, 2, 256, True),        # the largest head dim
    (2, 130, 130, 4, 2, 48, True),       # hd below 16 * NC: the v tile's
    (1, 200, 200, 3, 1, 96, True),       # zeroed columns are read to the
    (1, 129, 129, 2, 1, 160, True),      # tile's last key
    (1, 1, 1, 1, 1, 1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_gqa_ragged_matches_plain(cuda, b, s, t, h, hk,
                                                         hd, causal, dtype):
    q, k, v = _attn_case(np.random.default_rng(s * t + hd), b, s, t, h, hk,
                         hd, dtype, cuda)
    got = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    again = ops.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def _held_to_plain(q, k, v, causal):
    """One launch per call, the plain version's tolerance, and two launches
    bitwise equal."""
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal)
    again = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 2
    assert got.dtype == q.dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(q.dtype))


@pytest.mark.parametrize("b,s,t,h,hk,hd,causal", [
    (1, 129, 129, 2, 1, 128, True),      # ragged tails of the 128-row
    (1, 255, 255, 4, 2, 128, True),      # blocks and the 64-key tiles
    (1, 4100, 4100, 2, 1, 128, True),
    (2, 100, 100, 2, 1, 1, True),        # hd % 8 != 0: element copies,
    (2, 100, 100, 2, 1, 8, True),        # hd below 64 zero-padded in
    (2, 150, 150, 2, 2, 20, True),       # shared memory
    (1, 300, 300, 2, 1, 256, True),      # the widest head, 32-key tiles
    (2, 70, 333, 4, 2, 64, True),        # T > S: the causal offset
    (1, 200, 520, 2, 1, 128, True),
    (2, 90, 70, 2, 1, 128, False)])      # T < S, no mask
def test_flash_attention_bf16_tensor_core_route_edges(cuda, b, s, t, h, hk,
                                                      hd, causal):
    q, k, v = _attn_case(np.random.default_rng(s * t + hd), b, s, t, h, hk,
                         hd, torch.bfloat16, cuda)
    _held_to_plain(q, k, v, causal)


def _attn_fp64(q, k, v, causal):
    """The attention in fp64 (GQA repeated), as the exact yardstick."""
    s, t, rep = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    q, k, v = (x.double() for x in (q, k, v))
    k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = pos[None, :] > pos[:s, None] + (t - s)
        logits = logits.masked_fill(mask, -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_wide_logits(cuda, hd):
    """Logits x 30 (std about 25): p spans many binades, so P's second and
    third bf16 parts carry weight the output needs.  q is +-30 or 0 and k
    lies on a 2^-6 grid, so every q . k is exact in fp32 in any summation
    order and the kernel's logits are the plain version's: the case holds
    the exp and the three-pass P.V to the plain version's tolerance."""
    g = np.random.default_rng(hd)
    q = 30 * g.integers(-1, 2, size=(2, 300, 4, hd))
    k = np.clip(np.round(g.normal(size=(2, 300, 2, hd)) * 64), -255, 255) / 64
    v = g.normal(size=(2, 300, 2, hd))
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda)
               .to(torch.bfloat16) for x in (q, k, v))
    _held_to_plain(q, k, v, True)


def test_flash_attention_bf16_wide_logits_near_fp64(cuda):
    """Normal q x 30 and k: there the fp32 dot's own rounding, in any
    order, moves outputs that come from cancellation by more than 1e-5
    (the plain version against an fp64 attention).  The kernel stays
    within one bf16 rounding (the bf16 tolerance) plus the plain fp32
    version's own largest error of the fp64 attention."""
    q, k, v = _attn_case(np.random.default_rng(128), 2, 300, 300, 4, 2, 128,
                         torch.float32, cuda)
    q, k, v = (q * 30).to(torch.bfloat16), k.to(torch.bfloat16), \
        v.to(torch.bfloat16)
    exact = _attn_fp64(q, k, v, True)
    plain_err = float((ref.flash_attention_ref(q.float(), k.float(),
                                               v.float(), True).double()
                       - exact).abs().max())
    got = ops.flash_attention(q, k, v, True).double()
    tol = _attn_tol(torch.bfloat16)
    assert torch.all((got - exact).abs() <= tol["atol"] + plain_err
                     + tol["rtol"] * exact.abs())


def test_flash_attention_bf16_unaligned_pointers(cuda):
    """Inputs that start 2 bytes past a 16-byte boundary cannot take a
    tensor map: the producer copies element by element instead."""
    q, k, v = _attn_case(np.random.default_rng(7), 1, 200, 200, 2, 1, 128,
                         torch.bfloat16, cuda)
    shifted = []
    for x in (q, k, v):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0 and y.is_contiguous()
        shifted.append(y)
    _held_to_plain(*shifted, True)
    torch.testing.assert_close(ops.flash_attention(*shifted).float(),
                               ops.flash_attention(q, k, v).float(),
                               **_attn_tol(torch.bfloat16))


def test_flash_attention_rejects_grad_and_bad_inputs_on_card(cuda):
    """A grad-requiring input raises naming A22 (no backward kernel yet)
    and never falls back; under no_grad it launches."""
    q, k, v = _attn_case(np.random.default_rng(0), 1, 16, 16, 2, 1, 8,
                         torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="A22"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    q = q.detach()
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :8].contiguous(), k[:, :4].contiguous(),
                            v[:, :4].contiguous())          # T < S, causal
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[..., :4].contiguous(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros((1, 4, 1, 300), device=cuda),
                            torch.zeros((1, 4, 1, 300), device=cuda),
                            torch.zeros((1, 4, 1, 300), device=cuda))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k, v)


@pytest.mark.parametrize("arch", ["smollm-360m", "yi-9b", "qwen3-0.6b"])
def test_lm_smoke_forward_on_card_launches_flash_attention(cuda, arch):
    """The dense LM smoke configs on the card against the CPU: block_kv=8
    sends each of the 2 layers to the kernel; greedy tokens are equal;
    a forward that needs gradients on the flash route raises naming A22
    instead of falling back."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.utils import tree
    cfg = get_smoke(arch)
    p = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    cpu, _, _ = tfm.forward(p, cfg, toks, block_kv=8)
    pc, tc = tree.to_device(p, cuda), toks.to(cuda)
    before = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, _, _ = tfm.forward(pc, cfg, tc, block_kv=8)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-5)
    assert torch.equal(tfm.greedy_generate(pc, cfg, tc, 4).cpu(),
                       tfm.greedy_generate(p, cfg, toks, 4))
    leaves = [x.requires_grad_(True) for x in tree.leaves(pc)]
    with pytest.raises(NotImplementedError, match="A22"):
        tfm.lm_loss(tree.unflatten(pc, leaves), cfg,
                    dict(tokens=tc, labels=tc), block_kv=8)
