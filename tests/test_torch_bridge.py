"""PyTorch port vs the JAX reference: bridge, hashing, index build, and
the port's import hygiene.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs as its own tests run it, on the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import assignment_store as j_astore
from repro.core import freq_estimator as j_freq
from repro.core import retriever as j_retriever

from repro_torch import bridge
from repro_torch.core import assignment_store as t_astore
from repro_torch.core import freq_estimator as t_freq

ROOT = pathlib.Path(__file__).resolve().parents[1]


def assert_bitwise(ref, got, msg=""):
    """Same dtype, same shape, same bits (NaN and -0.0 included)."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype, (msg, ref.dtype, got.dtype)
    assert ref.shape == got.shape, (msg, ref.shape, got.shape)
    if ref.dtype.kind == "f":
        ref = ref.view(f"u{ref.itemsize}")
        got = got.view(f"u{got.itemsize}")
    np.testing.assert_array_equal(ref, got, err_msg=msg)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_init():
    cfg = get_smoke("svq")
    params, state = j_retriever.init(jax.random.PRNGKey(3), cfg)
    return cfg, jax.device_get(params), jax.device_get(state)


def test_bridge_params_roundtrip_bitwise(reference_init):
    _, params, _ = reference_init
    back = bridge.to_numpy(bridge.params_to_torch(params))
    ref_leaves, got_leaves = list(_leaves(params)), list(_leaves(back))
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    for (path, a), (_, b) in zip(ref_leaves, got_leaves):
        assert_bitwise(a, b, path)


def test_bridge_index_state_roundtrip_bitwise(reference_init):
    _, _, state = reference_init
    back = bridge.to_numpy(bridge.index_state_to_torch(state))
    assert_bitwise(state.vq.w, back["vq"]["w"])
    assert_bitwise(state.vq.c, back["vq"]["c"])
    for f in state.store._fields:
        assert_bitwise(getattr(state.store, f), back["store"][f], f)
    for f in state.freq._fields:
        assert_bitwise(getattr(state.freq, f), back["freq"][f], f)
    assert_bitwise(state.step, back["step"])


def test_bridge_serving_index_roundtrip_bitwise(reference_init):
    cfg, _, state = reference_init
    rng = np.random.default_rng(0)
    store = _reference_store(rng, 300, cfg.n_clusters, cfg.embed_dim)
    idx = jax.device_get(j_astore.build_serving_index(store, cfg.n_clusters))
    back = bridge.to_numpy(bridge.serving_index_to_torch(idx))
    for f in idx._fields:
        assert_bitwise(getattr(idx, f), back[f], f)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

EDGE_IDS = np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31, 65535, 65536,
                     -65536, 123456789, -987654321], np.int32)


@pytest.mark.parametrize("capacity", [1, 7, 1000, 4096, 2 ** 21])
def test_hash_ids_matches_reference_on_edge_ids(capacity):
    ref = np.asarray(j_freq.hash_ids(jnp.asarray(EDGE_IDS), capacity))
    got = t_freq.hash_ids(torch.from_numpy(EDGE_IDS), capacity).numpy()
    np.testing.assert_array_equal(ref, got)
    # int64 ids of the same value hash the same (their uint32 wrap)
    got64 = t_freq.hash_ids(torch.from_numpy(EDGE_IDS.astype(np.int64)),
                            capacity).numpy()
    np.testing.assert_array_equal(ref, got64)


def test_hash_ids_matches_reference_on_random_ids(rng):
    ids = rng.integers(-2 ** 31, 2 ** 31, size=5000).astype(np.int32)
    for capacity in (2000, 2 ** 20 + 3):
        ref = np.asarray(j_freq.hash_ids(jnp.asarray(ids), capacity))
        got = t_freq.hash_ids(torch.from_numpy(ids), capacity).numpy()
        np.testing.assert_array_equal(ref, got)


# ---------------------------------------------------------------------------
# store write + serving index
# ---------------------------------------------------------------------------

def _write_inputs(rng, n, n_clusters, dim):
    """Ids with duplicates (scatter-last) and hash collisions, clusters
    with empties, biases with ties, +/-0.0 and NaN."""
    ids = rng.integers(0, 3 * n, size=n).astype(np.int32)
    ids[n // 2: n // 2 + 20] = ids[:20]                # duplicate ids
    cluster = rng.integers(0, n_clusters, size=n).astype(np.int32)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    bias = rng.integers(-3, 4, size=n).astype(np.float32)  # heavy ties
    bias[::7] = 0.0
    bias[3::7] = -0.0
    bias[5::11] = np.nan
    bias[::5] += rng.normal(size=bias[::5].shape).astype(np.float32)
    valid = rng.random(n) > 0.1
    return ids, cluster, emb, bias, valid


def _reference_store(rng, n, n_clusters, dim, capacity=None):
    store = j_astore.init_store(capacity or 2 * n, dim)
    ids, cluster, emb, bias, valid = _write_inputs(rng, n, n_clusters, dim)
    store = j_astore.write(store, jnp.asarray(ids), jnp.asarray(cluster),
                           jnp.asarray(emb), jnp.asarray(bias),
                           jnp.asarray(valid))
    return jax.device_get(store)


@pytest.mark.parametrize("use_valid", [False, True])
def test_store_write_bitwise_with_duplicates(rng, use_valid):
    n, k, d, cap = 400, 16, 8, 256                    # collisions too
    ids, cluster, emb, bias, valid = _write_inputs(rng, n, k, d)
    jstore = j_astore.init_store(cap, d)
    tstore = t_astore.init_store(cap, d)
    for part in (slice(0, n // 2), slice(n // 2, n)):  # two writes
        jv = jnp.asarray(valid[part]) if use_valid else None
        tv = torch.from_numpy(valid[part]) if use_valid else None
        jstore = j_astore.write(jstore, jnp.asarray(ids[part]),
                                jnp.asarray(cluster[part]),
                                jnp.asarray(emb[part]),
                                jnp.asarray(bias[part]), jv)
        tstore = t_astore.write(tstore, torch.from_numpy(ids[part]),
                                torch.from_numpy(cluster[part]),
                                torch.from_numpy(emb[part]),
                                torch.from_numpy(bias[part]), tv)
    for f in jstore._fields:
        assert_bitwise(getattr(jstore, f), getattr(tstore, f).numpy(), f)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("spare", [0, 3])
def test_build_serving_index_bitwise(rng, use_kernel, spare):
    n_clusters = 24
    store = _reference_store(rng, 500, n_clusters, 8)
    ref = jax.device_get(j_astore.build_serving_index(
        store, n_clusters, use_kernel=use_kernel, spare_per_cluster=spare))
    tstore = t_astore.AssignmentStore(
        *(bridge.tensor(getattr(store, f)) for f in store._fields))
    got = t_astore.build_serving_index(tstore, n_clusters,
                                       spare_per_cluster=spare)
    for f in ref._fields:
        assert_bitwise(getattr(ref, f), getattr(got, f).numpy(), f)


def test_index_sort_matches_reference_sorts(rng):
    """The composite-key sort == the lexsort oracle == the radix-key sort,
    on a key set of ties, +/-0.0 and NaN."""
    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref
    from repro_torch.kernels import ref as t_ref
    cl = rng.integers(0, 6, size=300).astype(np.int32)
    bias = rng.integers(-2, 3, size=300).astype(np.float32)
    bias[::9] = -0.0
    bias[1::13] = np.nan
    bias[2::17] = np.inf
    bias[4::19] = -np.inf
    got = t_ref.index_sort_ref(torch.from_numpy(cl),
                               torch.from_numpy(bias)).numpy()
    for sort in (j_ref.index_sort_ref, j_ops.index_sort):
        np.testing.assert_array_equal(
            np.asarray(sort(jnp.asarray(cl), jnp.asarray(bias))), got)


# ---------------------------------------------------------------------------
# hygiene: the port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_service_import_leaves_jax_and_reference_unloaded():
    code = ("import sys\n"
            "import repro_torch.serving.service\n"
            "import repro_torch.bridge\n"
            "import repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
