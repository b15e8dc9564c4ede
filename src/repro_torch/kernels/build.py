"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own with ``nvcc`` into ``build/repro_torch_kernels/<name>-<hash>.so`` at
the repo root, at first use, from the sources in the checkout.  The file
name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of ``NVCC_FLAGS``, so an edited source or flag is
rebuilt.  A failed build raises.  What ``nvcc`` prints for a build that
succeeds (with ``-Xptxas -v``: each kernel's registers and spills) is
kept beside the library as ``<name>-<hash>.log``.
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
KERNELS = ("cluster_rank", "merge_serve", "fused_gather_rank", "vq_assign",
           "inbatch_softmax", "ema_segment_sum", "topk_dot", "embedding_bag",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the launch functions: (argtypes, restype)
_SIGNATURES = {
    "cluster_rank": {
        "cluster_rank_launch": ([_P] * 6 + [_I, _I, _I, _I, _P], _I),
        "cluster_rank_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "cluster_rank_segments": ([_I], _I),
    },
    "merge_serve": {
        "merge_serve_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P], _I),
        "merge_serve_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "merge_serve_ds_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _P], _I),
        "merge_serve_ds_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "fused_gather_rank": {
        "fused_gather_rank_launch": ([_P] * 12 + [_I, _I, _I, _I, _L, _I, _I,
                                                  _I, _P], _I),
        "fused_gather_rank_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    },
    "vq_assign": {
        "vq_assign_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "vq_assign_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "inbatch_softmax": {
        "inbatch_softmax_fwd_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _P], _I),
        "inbatch_softmax_bwd_launch": ([_P] * 10 + [_I, _I, _P], _I),
        "inbatch_softmax_smem_bytes": ([_I], ctypes.c_size_t),
        "inbatch_softmax_bwd_scratch_floats": ([_I, _I], ctypes.c_size_t),
        "inbatch_softmax_max_d": ([], _I),
    },
    "ema_segment_sum": {
        "ema_segment_sum_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _P], _I),
        "ema_segment_sum_slices": ([], _I),
        "ema_segment_sum_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "topk_dot": {
        "topk_dot_launch": ([_P] * 5 + [_I, _L, _I, _I, _L, _I, _I, _P], _I),
        "topk_dot_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
    },
    "embedding_bag": {
        "embedding_bag_launch": ([_P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I,
                                  _P], _I),
        "embedding_bag_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "flash_attention": {
        "flash_attention_launch": ([_P] * 4 + [_I] * 7 + [_F, _I, _P], _I),
        "flash_attention_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "flash_attention_max_hd": ([], _I),
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


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built kernel ``name`` ("" if nothing
    was kept)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


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
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
