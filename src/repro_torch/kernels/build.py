"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own with ``nvcc`` into ``build/repro_torch_kernels/<name>-<hash>.so`` at
the repo root, at first use, from the sources in the checkout.  The file
name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the flags, so an edited source is rebuilt.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("cluster_rank", "merge_serve", "vq_assign", "inbatch_softmax",
           "ema_segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the launch functions: (argtypes, restype)
_SIGNATURES = {
    "cluster_rank": {
        "cluster_rank_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "cluster_rank_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "merge_serve": {
        "merge_serve_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P], _I),
        "merge_serve_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "vq_assign": {
        "vq_assign_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "vq_assign_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "inbatch_softmax": {
        "inbatch_softmax_fwd_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _P], _I),
        "inbatch_softmax_bwd_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _P], _I),
        "inbatch_softmax_smem_bytes": ([_I], ctypes.c_size_t),
        "inbatch_softmax_max_d": ([], _I),
    },
    "ema_segment_sum": {
        "ema_segment_sum_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _P], _I),
        "ema_segment_sum_slices": ([], _I),
        "ema_segment_sum_smem_bytes": ([_I], ctypes.c_size_t),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile the named kernels, one ``nvcc`` each, all at once."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(_compile, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
