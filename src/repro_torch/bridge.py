"""Numpy bridge between the JAX package's state and the port's tensors.

The reference's params pytree (dicts and lists of arrays), its
``IndexState``, its ``ServingIndex``, its ``ShardedServingIndex`` and its
LM ``KVCache`` are handed over as numpy arrays (``jax.device_get``) and
come out as the port's tensors on ``device``; ``to_numpy`` turns the
port's values back into numpy.  bf16 crosses bit for bit, through a
uint16 view on each side (numpy's bf16 type is ``ml_dtypes``', which
torch does not read).  Reference objects are read by field name only, so
this module imports neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import assignment_store as astore
from repro_torch.core import freq_estimator as freq
from repro_torch.core import vq
from repro_torch.core.retriever import IndexState
from repro_torch.models.lm.attention import KVCache
from repro_torch.serving.sharding import ShardedServingIndex


def tensor(x, device="cpu") -> torch.Tensor:
    """A numpy array (or scalar) -> a tensor of the same dtype and bits."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_to_torch(params: Any, device="cpu") -> Any:
    """Params pytree of dicts / lists / tuples of arrays -> same of tensors."""
    if isinstance(params, dict):
        return {k: params_to_torch(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_torch(v, device) for v in params]
    return tensor(params, device)


def index_state_to_torch(state: Any, device="cpu") -> IndexState:
    """Reference ``IndexState`` (fields vq, store, freq, step) -> port's."""
    return IndexState(
        vq=vq.VQState(w=tensor(state.vq.w, device),
                      c=tensor(state.vq.c, device)),
        store=astore.AssignmentStore(
            *(tensor(getattr(state.store, f), device)
              for f in astore.AssignmentStore._fields)),
        freq=freq.FreqState(
            *(tensor(getattr(state.freq, f), device)
              for f in freq.FreqState._fields)),
        step=tensor(state.step, device))


def serving_index_to_torch(index: Any, device="cpu") -> astore.ServingIndex:
    """Reference ``ServingIndex`` -> port's, field by field."""
    return astore.ServingIndex(
        *(tensor(getattr(index, f), device)
          for f in astore.ServingIndex._fields))


def sharded_serving_index_to_torch(sidx: Any, device="cpu"
                                   ) -> ShardedServingIndex:
    """Reference ``ShardedServingIndex`` -> port's, field by field (its
    0-d ``n_real`` and ``n_items`` stay 0-d int32 tensors)."""
    return ShardedServingIndex(
        *(tensor(getattr(sidx, f), device)
          for f in ShardedServingIndex._fields))


def kv_cache_to_torch(cache: Any, device="cpu") -> KVCache:
    """Reference ``KVCache`` (fields k, v, pos) -> port's: k and v as
    tensors, pos as a Python int."""
    return KVCache(k=tensor(cache.k, device), v=tensor(cache.v, device),
                   pos=int(np.asarray(cache.pos)))


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes       # numpy's bf16 type; only a bf16 tensor needs it
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts, lists and NamedTuples) -> numpy arrays; a
    NamedTuple becomes a dict of its fields."""
    if isinstance(tree, torch.Tensor):
        return _tensor_to_numpy(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_numpy(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree
