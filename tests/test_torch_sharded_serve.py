"""PyTorch port vs the JAX reference: serving on logical shards.

The port's ``serving/sharding.py`` partitions the serving index
cluster-major on one device and serves from the shards, unfused and
fused.  Held to the reference: the partition bitwise (through the
bridge); stages 3-4a bitwise on ids, validity and merge scores where the
reference's stage-1 outputs are fed in; ``sharded_serve`` against the
reference's ``sharded_serve(use_kernel=False)`` and against the port's
own single-device serve with ids equal and scores close.  On the CPU the
plain ``u @ e_d.T`` of a shard may round differently from the
full-codebook product (the reference drifts the same way: ROADMAP C2),
so scores are held close, not bitwise; tests/test_torch_cuda.py holds
the card's sharded serve bitwise to its single-device serve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assignment_store as j_astore
from repro.serving import RetrievalService as JRetrievalService
from repro.serving import sharding as j_sharding

from repro_torch import bridge
from repro_torch.core import retriever as t_retriever
from repro_torch.kernels import ops as t_ops
from repro_torch.serving import sharding as t_sharding
from repro_torch.serving.service import RetrievalService
from test_torch_fused_serve import trained_reference

TOL = dict(rtol=1e-5, atol=1e-5)
L = 32          # items_per_cluster at this config


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def trained():
    return trained_reference()


def _indexes(t, spare=0):
    jidx = j_astore.build_serving_index(t["state"].store, t["cfg"].n_clusters,
                                        spare_per_cluster=spare)
    return jidx, bridge.serving_index_to_torch(jax.device_get(jidx))


def _assert_sidx_equal(want, got):
    want = bridge.to_numpy(bridge.sharded_serving_index_to_torch(
        jax.device_get(want)))
    got = bridge.to_numpy(got)
    assert set(want) == set(got)
    for f in want:
        a, b = np.asarray(want[f]), np.asarray(got[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)


@pytest.mark.parametrize("spare", [0, 5])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("cap_quantum", [16, 256])
def test_shard_serving_index_matches_reference(trained, n_shards, spare,
                                               cap_quantum):
    t = trained
    jidx, tidx = _indexes(t, spare)
    want = j_sharding.shard_serving_index(jidx, t["cfg"].n_clusters,
                                          n_shards, cap_quantum=cap_quantum)
    got = t_sharding.shard_serving_index(tidx, t["tcfg"].n_clusters,
                                         n_shards, cap_quantum=cap_quantum)
    assert got.n_shards == n_shards and got.capacity == want.capacity
    _assert_sidx_equal(want, got)


def test_shard_serving_index_rejects_bad_inputs(trained):
    t = trained
    _, tidx = _indexes(t, spare=2)
    with pytest.raises(ValueError, match="not divisible"):
        t_sharding.shard_serving_index(tidx, t["tcfg"].n_clusters, 5)
    # a non-live slot that is not the sentinel payload
    spare_slot = int(tidx.offsets[0] + tidx.counts[0])
    bad = tidx._replace(item_bias=tidx.item_bias.clone())
    bad.item_bias[spare_slot] = 1.0
    with pytest.raises(ValueError, match="non-live slots"):
        t_sharding.shard_serving_index(bad, t["tcfg"].n_clusters, 4)


def _stage1(t, n_shards):
    """The reference's sharded stage 1 and its outputs as tensors."""
    jidx, _ = _indexes(t)
    jsidx = j_sharding.shard_serving_index(jidx, t["cfg"].n_clusters,
                                           n_shards)
    j1 = j_sharding.sharded_stage_rank(
        t["params"], t["state"], t["cfg"], jsidx,
        {k: jnp.asarray(v) for k, v in t["batch"].items()})
    s1 = {k: bridge.tensor(jax.device_get(j1[k]))
          for k in ("u", "top_scores", "top_clusters")}
    return jsidx, j1, s1


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_sharded_stage_merge_bitwise_given_reference_ranking(trained,
                                                             n_shards, fused):
    t = trained
    jsidx, j1, s1 = _stage1(t, n_shards)
    tsidx = bridge.sharded_serving_index_to_torch(jax.device_get(jsidx))
    j2 = j_sharding.sharded_stage_merge(t["cfg"], jsidx, j1,
                                        items_per_cluster=L, fused=fused)
    t2 = t_sharding.sharded_stage_merge(t["tcfg"], tsidx, s1,
                                        items_per_cluster=L, fused=fused)
    assert int(np.asarray(j2["valid"]).sum()) > 0
    for k in ("cand_ids", "valid", "merge_scores"):
        a, b = np.asarray(j2[k]), t2[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    np.testing.assert_allclose(np.asarray(j2["exact_scores"]),
                               t2["exact_scores"].numpy(), **TOL)


def test_sharded_stage_rank_matches_reference(trained):
    t = trained
    jsidx, j1, _ = _stage1(t, 4)
    tsidx = bridge.sharded_serving_index_to_torch(jax.device_get(jsidx))
    t1 = t_sharding.sharded_stage_rank(
        t["tparams"], t["tstate"], t["tcfg"], tsidx,
        {k: torch.from_numpy(v) for k, v in t["batch"].items()})
    np.testing.assert_array_equal(np.asarray(j1["top_clusters"]),
                                  t1["top_clusters"].numpy())
    np.testing.assert_allclose(np.asarray(j1["top_scores"]),
                               t1["top_scores"].numpy(), **TOL)


def _assert_close_outputs(want, got, tag):
    assert set(want) == set(got), tag
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (tag, k)
        if k in ("scores", "merge_scores", "exact_scores"):
            np.testing.assert_allclose(a, b, err_msg=f"{tag}:{k}", **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}:{k}")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_sharded_serve_matches_reference_and_single_device(trained,
                                                           n_shards, fused):
    t = trained
    jidx, tidx = _indexes(t)
    jsidx = j_sharding.shard_serving_index(jidx, t["cfg"].n_clusters,
                                           n_shards)
    want = j_sharding.sharded_serve(
        t["params"], t["state"], t["cfg"], jsidx,
        {k: jnp.asarray(v) for k, v in t["batch"].items()},
        items_per_cluster=L, fused=fused)
    tsidx = t_sharding.shard_serving_index(tidx, t["tcfg"].n_clusters,
                                           n_shards)
    t_ops.reset_launches()
    got = t_sharding.sharded_serve(t["tparams"], t["tstate"], t["tcfg"],
                                   tsidx, t["batch"], items_per_cluster=L,
                                   fused=fused, device="cpu")
    assert all(n == 0 for n in t_ops.LAUNCHES.values())
    assert int(got["valid"].sum()) > 0
    _assert_close_outputs(want, bridge.to_numpy(got), "reference")
    single = t_retriever.serve(t["tparams"], t["tstate"], t["tcfg"], tidx,
                               t["batch"], items_per_cluster=L, device="cpu")
    _assert_close_outputs(bridge.to_numpy(single), bridge.to_numpy(got),
                          "single device")


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_service_matches_reference(trained, fused):
    t = trained
    want = JRetrievalService(t["cfg"], t["params"], t["state"],
                             items_per_cluster=L, fused=fused, n_shards=4
                             ).serve_batch(t["batch"])
    svc = RetrievalService(t["tcfg"], t["tparams"], t["tstate"],
                           items_per_cluster=L, fused=fused, n_shards=4,
                           device="cpu")
    assert isinstance(svc.index, t_sharding.ShardedServingIndex)
    assert svc.index.n_shards == 4
    got = svc.serve_batch(t["batch"])
    _assert_close_outputs(want, got, "service")


def test_mesh_and_rank_parallel_raise_naming_a9(trained):
    t = trained
    _, tidx = _indexes(t)
    tsidx = t_sharding.shard_serving_index(tidx, t["tcfg"].n_clusters, 4)
    with pytest.raises(NotImplementedError, match="A9"):
        t_sharding.sharded_serve(t["tparams"], t["tstate"], t["tcfg"], tsidx,
                                 t["batch"], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        t_sharding.sharded_serve(t["tparams"], t["tstate"], t["tcfg"], tsidx,
                                 t["batch"], rank_parallel=True,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        RetrievalService(t["tcfg"], t["tparams"], t["tstate"], n_shards=4,
                         mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        RetrievalService(t["tcfg"], t["tparams"], t["tstate"], delta_spare=4,
                         device="cpu")
