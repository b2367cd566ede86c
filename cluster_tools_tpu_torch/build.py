"""Build and load the hand-written CUDA kernels at first use.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers are compiled, so a cold build takes seconds, not minutes.
All sources compile concurrently (one ``nvcc`` each).  Libraries land in
``.torch_ext/`` at the repository root (git-ignored), named by a hash of
the sources and flags, so an unchanged tree reuses its build.

Importing this module needs no ``nvcc``; :func:`build_all` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".torch_ext"

# kernel library -> source file
SOURCES = {
    "tile_ccl": "tile_ccl.cu",
    "tile_ccl_doubling": "tile_ccl_doubling.cu",
    "tile_ws_propagate": "tile_ws.cu",
    "edt_cascade": "edt_cascade.cu",
    "apply_remap": "apply_remap.cu",
}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update((CSRC / SOURCES[name]).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing kernel library concurrently; load them all.

    Returns seconds per library (0.0 when a cached build was reused).
    Raises with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        if name in _LIBS:
            continue
        path = _lib_path(name)
        if path.exists():
            BUILD_SECONDS[name] = 0.0
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            path,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return dict(BUILD_SECONDS)


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "tile_ccl": ("ct_tile_ccl", [P, P, I, I, I, I, I, I, P]),
        "tile_ccl_doubling": ("ct_tile_ccl_doubling", [P, P, P, I, I, I, I, I, I, P]),
        "tile_ws_propagate": ("ct_tile_ws_propagate", [P, P, P, I, I, I, I, I, I, P]),
        "edt_cascade": ("ct_edt_cascade", [P, P, I, I, I, I, I, F, F, P]),
        "apply_remap": ("ct_apply_remap", [P, P, P, P, I, I, I, I, I, I, I, P]),
    }
    fn_name, argtypes = sigs[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.ct_error_string.argtypes = [ctypes.c_int]
    lib.ct_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building everything at first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]
