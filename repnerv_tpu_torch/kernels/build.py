"""Build the package's CUDA sources into one shared library and load it.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a),
one compiler process per source, all started together, and links the
objects into ``_build/libkernels-<hash>.so`` inside the package (a directory
that ``.gitignore`` lists); the library is loaded with ``ctypes``.  The file
name carries a hash of the sources, headers and flags, so an edit rebuilds
and an unchanged tree reuses the library.  The C entry points take plain
pointers, so no PyTorch header is compiled.  A failed build raises with the
compiler's output.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):  # .cu and .cuh
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu if the library for these sources is missing; return
    its path.  The compilers' output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``build.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    objs = [obj for _, obj, _ in jobs]
    tmp = f"{so}.{tag}"
    log, failed = [], []
    try:
        for cmd, _, proc in jobs:
            out, _ = proc.communicate(timeout=600)
            log.append(" ".join(cmd) + f"\n# exit {proc.returncode}\n{out}")
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            log.append(" ".join(cmd) + f"\n# exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(proc.stdout + proc.stderr)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(f"# {seconds:.2f} s, {len(jobs)} sources compiled in parallel\n")
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # route, x, w, wt, b, head_w, head_b, out, B, H, W, Cin, C, s, act,
            # c_final, sigmoid_squash, stream
            lib.repnerv_fused_conv_ps_act.argtypes = [i, *[p] * 7, *[i] * 9, p]
            # ... the same with z after out
            lib.repnerv_train_stage_fwd.argtypes = [i, *[p] * 8, *[i] * 9, p]
            # route, x_q, w_q, wt_q, scale, bias, inv_out, head_w, head_b, out,
            # B, H, W, Cin, C, s, act, c_final, sigmoid_squash, stream
            lib.repnerv_fused_conv_ps_act_int8.argtypes = [i, *[p] * 9, *[i] * 9, p]
            # dtype, z, ct, ct_head, out, hw, d_conv, d_b, d_hw, d_hb, work,
            # ticket, B, H, W, C, s, act, c_final, sigmoid_squash, stream
            lib.repnerv_train_stage_bwd.argtypes = [i, *[p] * 11, *[i] * 8, p]
            # dtype, B, H, W, C, s, c_final -> f32 values of workspace
            lib.repnerv_train_stage_bwd_workspace.argtypes = [i] * 7
            lib.repnerv_train_stage_bwd_workspace.restype = ctypes.c_longlong
            # x, out, N, H, W, window (host f32[size]), size, full, stream
            lib.repnerv_gauss_blur_valid.argtypes = [p, p, i, i, i, p, i, i, p]
            # x, y, moments (or null), partial, N, H, W, C, tiles, window, size,
            # c1, c2, stream
            lib.repnerv_ssim_stats.argtypes = [*[p] * 4, *[i] * 5, p, i, f, f, p]
            # mu_a, mu_b, e_aa, e_bb, e_ab, g_ssim, g_cs, a, b, d, N, H, W, C,
            # window, size, c1, c2, stream
            lib.repnerv_ssim_stats_vjp.argtypes = [*[p] * 10, i, i, i, i, p, i, f, f, p]
            # gemm records, n, copy records, n, fold record, zero, n_zero, tile,
            # stream
            lib.repnerv_erb_fold.argtypes = [p, i, p, i, p, p, ctypes.c_longlong, i, p]
            # stream -> kernel, memset and memcpy nodes of the graph it is
            # capturing into; -1 when it captures none, -2 on an error
            lib.repnerv_capture_nodes.argtypes = [p]
            lib.repnerv_capture_nodes.restype = ctypes.c_longlong
            for fn in (
                lib.repnerv_fused_conv_ps_act,
                lib.repnerv_train_stage_fwd,
                lib.repnerv_fused_conv_ps_act_int8,
                lib.repnerv_train_stage_bwd,
                lib.repnerv_gauss_blur_valid,
                lib.repnerv_ssim_stats,
                lib.repnerv_ssim_stats_vjp,
                lib.repnerv_erb_fold,
            ):
                fn.restype = i
            _LIB = lib
        return _LIB
