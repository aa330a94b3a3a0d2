"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes). The library is built at
first use, keyed by a hash of the sources and flags, under ``build/`` at the
repository root (listed in ``.gitignore``). ``--use_fast_math`` is
deliberately absent: the positional encoding needs full-precision
``sinf``/``cosf`` at arguments up to 2^9 * |x|.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("mlp_composite.cu", "chamfer_band.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_state = {"lib": None}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_DIR, f"libnnt_kernels_{_source_hash()}.so")


def build(verbose=False):
    """Compile the sources unless a library for this exact source hash
    exists; returns its path. Writes atomically (temp file + rename)."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp] + [os.path.join(CSRC_DIR, s) for s in SOURCES]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose and proc.stderr:
            print(proc.stderr, file=sys.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library(verbose=False):
    """The loaded kernel library (built on first call in this process)."""
    with _lock:
        if _state["lib"] is None:
            _state["lib"] = ctypes.CDLL(build(verbose=verbose))
        return _state["lib"]


_P = ctypes.c_void_p
_I = ctypes.c_int


_functions = {}


def c_function(name, signature):
    """C entry ``name`` with argtypes from ``signature`` (a string of 'p'
    pointer / 'i' int codes; the stream is the trailing 'p'). Every entry
    returns its ``cudaGetLastError()`` as an int."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = [_P if c == "p" else _I for c in signature]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err, name):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
