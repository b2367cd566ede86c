"""Build and load the hand-written CUDA kernels at first use.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers are compiled, so a cold build takes seconds, not minutes.
All sources compile concurrently (one ``nvcc`` each).  Libraries land in
``.torch_ext/`` at the repository root (git-ignored), named by a hash of
the sources and flags, so an unchanged tree reuses its build.

The host C++ rung (``csrc/ct_native.cpp``, bound by :mod:`.native`) is
built the same way by ``g++`` with the JAX package's own flags
(:func:`host_library`): it needs no ``nvcc``, so it builds at first use on
any machine with a C++ compiler, and :func:`build_all` builds it beside the
kernels.

The thread-state helper (``csrc/ct_thread_state.cpp``, bound by
:mod:`.runtime.trace`) is the one source compiled against PyTorch's own
headers and libraries (:func:`thread_state_library`): it carries a
thread's profiler state to the executor's worker threads.  Only a traced
run asks for it, and a machine without a compiler or the headers goes
without it (the tracer says why); it is not part of :func:`build_all`.

Importing this module needs no ``nvcc``; :func:`build_all` does.  The
shards of a mesh launch kernels from threads of one process, so building
and loading happen under one lock: the first caller builds, the others wait
for its libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    "row_scan": "row_scan.cu",
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

# the host library: ISO C++17 without fast-math keeps floating-point
# contraction off, so its float64 sums are the JAX package's library's bits
HOST_NAME = "ct_native"
HOST_SOURCE = "ct_native.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

# the thread-state helper: PyTorch's headers, its C++ ABI and its libraries
THREAD_STATE_NAME = "ct_thread_state"
THREAD_STATE_SOURCE = "ct_thread_state.cpp"
THREAD_STATE_FLAGS = ["-O2", "-fPIC", "-std=c++20", "-shared", "-w"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
_BUILD_LOCK = threading.RLock()


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


def host_library_path() -> Path:
    """Where the host library of the current source and flags lives."""
    h = hashlib.sha1()
    h.update((CSRC / HOST_SOURCE).read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"lib{HOST_NAME}_{h.hexdigest()[:12]}.so"


def _spawn(name: str, cmd, path: Path) -> tuple:
    """Start one compiler writing a process-unique temp file (renamed into
    ``path`` once it succeeds, so no reader sees a partial library)."""
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{name} build failed: cannot run {cmd[0]!r}: {e}") from e
    return proc, tmp, path, time.perf_counter()


def _finish(procs: Dict[str, tuple], what: str) -> None:
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))


def _host_cmd() -> list:
    return [CXX, *CXX_FLAGS, str(CSRC / HOST_SOURCE)]


def host_library() -> Path:
    """The host library's path, compiling it with ``g++`` at first use.
    Raises with the compiler's output when the build fails."""
    with _BUILD_LOCK:
        path = host_library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish({HOST_NAME: _spawn(HOST_NAME, _host_cmd(), path)}, "host library")
        return path


def _thread_state_cmd() -> list:
    import torch
    from torch.utils.cpp_extension import include_paths

    lib_dir = os.path.join(os.path.dirname(torch.__file__), "lib")
    return [CXX, *THREAD_STATE_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in include_paths()), str(CSRC / THREAD_STATE_SOURCE),
            f"-L{lib_dir}", "-ltorch_cpu", "-lc10", f"-Wl,-rpath,{lib_dir}"]


def thread_state_library() -> Path:
    """The thread-state helper's path, compiling it with ``g++`` against
    the running PyTorch at first use (named by a hash of the source, the
    command and PyTorch's version, so another PyTorch builds its own).
    Raises with the compiler's output when the build fails."""
    import torch

    cmd = _thread_state_cmd()
    h = hashlib.sha1()
    h.update((CSRC / THREAD_STATE_SOURCE).read_bytes())
    h.update(" ".join([*cmd, torch.__version__]).encode())
    path = BUILD_DIR / f"lib{THREAD_STATE_NAME}_{h.hexdigest()[:12]}.so"
    with _BUILD_LOCK:
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish({THREAD_STATE_NAME: _spawn(THREAD_STATE_NAME, cmd, path)}, "thread-state helper")
        return path


def build_all() -> Dict[str, float]:
    """Compile every missing kernel library and the host library
    concurrently; load the kernels.

    Returns seconds per library (0.0 when a cached build was reused).
    Raises with the compiler's output when any build fails.
    """
    with _BUILD_LOCK:
        return _build_all()


def _build_all() -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [name for name in SOURCES if name not in _LIBS and not _lib_path(name).exists()]
    for name in SOURCES:
        if name not in _LIBS and name not in missing:
            BUILD_SECONDS[name] = 0.0
    nvcc = nvcc_path() if missing else None
    procs = {}
    host = host_library_path()
    if host.exists():
        BUILD_SECONDS[HOST_NAME] = 0.0
    else:
        procs[HOST_NAME] = _spawn(HOST_NAME, _host_cmd(), host)
    for name in missing:
        procs[name] = _spawn(name, [nvcc, *NVCC_FLAGS, str(CSRC / SOURCES[name])], _lib_path(name))
    _finish(procs, "CUDA kernel and host library")
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return dict(BUILD_SECONDS)


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    sigs = {
        "tile_ccl": ("ct_tile_ccl", [P, P, I, I, I, I, I, I, P]),
        "tile_ccl_doubling": ("ct_tile_ccl_doubling", [P, P, P, I, I, I, I, I, I, P]),
        "tile_ws_propagate": ("ct_tile_ws_propagate", [P, P, P, I, I, I, I, I, I, P]),
        "edt_cascade": ("ct_edt_cascade", [P, P, I, I, I, I, I, F, F, P]),
        "apply_remap": ("ct_apply_remap", [P, P, P, P, I, I, I, I, I, I, I, P]),
        "row_scan": ("ct_row_scan", [P, P, P, I, L, I, I, P]),
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
        with _BUILD_LOCK:
            if name not in _LIBS:
                _build_all()
    return _LIBS[name]
