"""PyTorch/CUDA port of the streaming VQ retriever (``src/repro`` is the
JAX reference it is held to).

The layout mirrors the JAX package module for module.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; on a CUDA tensor a
kernel wrapper launches its hand-written kernel, on a CPU tensor it runs
the kernel's plain PyTorch version (``kernels/ref.py``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Never falls back to the CPU on its own: with no card present and no
    device named it raises.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")
