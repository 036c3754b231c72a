"""Build the package's CUDA sources into one shared library and load it.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a)
into ``_build/libkernels-<hash>.so`` inside the package (a directory that
``.gitignore`` lists) and the library is loaded with ``ctypes``.  The file
name carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library.  The C entry points take plain pointers,
so no PyTorch header is compiled and a build takes seconds.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu if the library for these sources is missing; return
    its path.  The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``build.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + f"\n# {seconds:.2f} s, exit {proc.returncode}\n")
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.repnerv_fused_conv_ps_act
            # dtype, x, w, b, head_w, head_b, out, B, H, W, Cin, C, s, act,
            # c_final, sigmoid_squash, stream
            fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            fn.restype = i
            _LIB = lib
        return _LIB
