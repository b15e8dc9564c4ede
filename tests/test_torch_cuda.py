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
