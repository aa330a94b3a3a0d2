"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object file,
all at once in parallel, and the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so
a build takes seconds, not minutes). The library is built at first use,
keyed by a hash of the sources and flags, under ``build/`` at the
repository root (listed in ``.gitignore``). Processes that start together
(the ranks of a ``torch.distributed.run`` launch) build it once: a file lock
in ``build/`` makes the others wait for the first build and load its
result. ``--use_fast_math`` is deliberately absent: the positional encoding needs full-precision
``sinf``/``cosf`` at arguments up to 2^9 * |x|.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("mlp_fused_fwd.cu", "mlp_fused_bwd.cu", "mlp_input_bwd.cu",
           "mlp_composite.cu", "chamfer_band.cu", "chamfer_exact.cu",
           "ref_pair.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
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
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in (*SOURCES, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_DIR, f"libnnt_kernels_{_source_hash()}.so")


def _run_all(cmds, verbose):
    """Run the commands in parallel; raise with the first failure's
    output once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if verbose and err:
            print(err, file=sys.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc={proc.returncode}):\n"
                          f"{err[-8000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + failed[0])


def build(verbose=False):
    """Compile the sources unless a library for this exact source hash
    exists; returns its path. Writes atomically (temp dir + rename), under
    an exclusive lock on ``build/torch_kernels/.lock`` held across
    processes (the OS releases it if a holder dies)."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(path):
            _compile(path, verbose)
    return path


def _compile(path, verbose):
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", o,
                   os.path.join(CSRC_DIR, s)]
                  for s, o in zip(SOURCES, objs)], verbose)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], verbose)
        os.replace(lib, path)


def load_library(verbose=False):
    """The loaded kernel library (built on first call in this process)."""
    with _lock:
        if _state["lib"] is None:
            _state["lib"] = ctypes.CDLL(build(verbose=verbose))
        return _state["lib"]


_CODES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


_functions = {}


def c_function(name, signature):
    """C entry ``name`` with argtypes from ``signature`` (a string of 'p'
    pointer / 'i' int / 'f' float codes; the stream is the trailing 'p').
    Every entry returns its ``cudaGetLastError()`` as an int."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = [_CODES[c] for c in signature]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err, name):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
