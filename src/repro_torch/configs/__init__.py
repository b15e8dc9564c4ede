"""Architecture config registry (the reference's arch ids).

``arch_module(arch_id)`` -> the module with CONFIG / SHAPES / smoke().
The port holds the dense LM family, the recsys families and the paper's
own model; a MoE LM or a GNN arch id raises ``NotImplementedError``
naming its ROADMAP.md item.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (EmbeddingSpec, LMConfig,  # noqa: F401
                                     SVQConfig)

LM_ARCHS = ["smollm-360m", "yi-9b", "qwen3-0.6b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
GNN_ARCHS = ["mace"]
RECSYS_ARCHS = ["din", "two-tower-retrieval", "bst", "dlrm-rm2"]

_ARCH_MODULES: Dict[str, str] = {
    # LM family (dense)
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    # recsys
    "din": "repro_torch.configs.din",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "bst": "repro_torch.configs.bst",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    # the paper's own model
    "svq": "repro_torch.configs.svq",
}
_NOT_PORTED = {
    **{a: "the MoE FFN of the LM family is not ported yet: ROADMAP.md "
          "item A21"
       for a in ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")},
    **{a: "the GNN family is not ported yet: ROADMAP.md item A20"
       for a in GNN_ARCHS},
}

ALL_ARCHS: List[str] = LM_ARCHS + GNN_ARCHS + RECSYS_ARCHS + ["svq"]
ASSIGNED_ARCHS: List[str] = [a for a in ALL_ARCHS if a != "svq"]


def arch_module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch}: {_NOT_PORTED[arch]}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALL_ARCHS)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str):
    return arch_module(arch).CONFIG


def get_shapes(arch: str):
    return arch_module(arch).SHAPES


def get_smoke(arch: str):
    return arch_module(arch).smoke()


def family(arch: str) -> str:
    if arch in LM_ARCHS:
        return "lm"
    if arch in GNN_ARCHS:
        return "gnn"
    if arch in RECSYS_ARCHS or arch == "svq":
        return "recsys"
    raise KeyError(arch)
