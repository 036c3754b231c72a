"""ctypes loader for the native Huffman and rANS backends (native/huffman.cpp,
native/rans.cpp at the root of the repository).  The port's own copy of
``repnerv_tpu/compress/native.py``: it compiles the same C++ sources, but
into the port's own ``_build/`` directory (which ``.gitignore`` lists), never
over the libraries beside the sources.

Compiles each shared library on first use with g++; every entry point
degrades to ``None`` so the pure-Python paths in huffman.py and rans.py take
over when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SRC = os.path.join(_NATIVE_DIR, "huffman.cpp")
_SO = os.path.join(_BUILD_DIR, "libhuffman.so")


def _build_and_dlopen(src: str, so: str) -> ctypes.CDLL:
    """Compile-if-stale then dlopen; if an existing .so fails to load (wrong
    arch/libc on this host), delete it and retry ONE forced rebuild from
    source before giving up."""
    def build():
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file

    if not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
    ):
        build()
    try:
        return ctypes.CDLL(so)
    except OSError:
        if not os.path.exists(src):
            raise
        os.remove(so)
        build()
        return ctypes.CDLL(so)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("REPNERV_NO_NATIVE"):
            return None
        try:
            lib = _build_and_dlopen(_SRC, _SO)
            lib.huffman_encode.restype = ctypes.c_longlong
            lib.huffman_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_longlong,
            ]
            lib.huffman_decode.restype = ctypes.c_longlong
            lib.huffman_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_longlong,
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_available() -> bool:
    return _load() is not None


def native_encode(
    idx: np.ndarray, lens: np.ndarray, codes: np.ndarray
) -> Optional[Tuple[bytes, int]]:
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    codes = np.ascontiguousarray(codes, np.uint64)
    capacity = int(lens[idx].sum()) // 8 + 16
    out = np.empty(capacity, np.uint8)
    nbits = lib.huffman_encode(
        _ptr(idx, ctypes.c_int32),
        len(idx),
        _ptr(lens, ctypes.c_int32),
        _ptr(codes, ctypes.c_uint64),
        _ptr(out, ctypes.c_uint8),
        capacity,
    )
    if nbits < 0:
        return None
    nbytes = (int(nbits) + 7) // 8
    return out[:nbytes].tobytes(), int(nbits)


def native_decode(
    blob: np.ndarray, lens: np.ndarray, codes: np.ndarray, n_symbols: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    codes = np.ascontiguousarray(codes, np.uint64)
    out = np.empty(n_symbols, np.int32)
    produced = lib.huffman_decode(
        _ptr(blob, ctypes.c_uint8),
        len(blob),
        _ptr(lens, ctypes.c_int32),
        _ptr(codes, ctypes.c_uint64),
        len(lens),
        _ptr(out, ctypes.c_int32),
        n_symbols,
    )
    if produced != n_symbols:
        return None
    return out


# ---------------------------------------------------------------------------
# rANS backend (native/rans.cpp) — same compile-on-first-use pattern
# ---------------------------------------------------------------------------

_RANS_LIB: Optional[ctypes.CDLL] = None
_RANS_TRIED = False
_RANS_SRC = os.path.join(_NATIVE_DIR, "rans.cpp")
_RANS_SO = os.path.join(_BUILD_DIR, "librans.so")


def _load_rans() -> Optional[ctypes.CDLL]:
    global _RANS_LIB, _RANS_TRIED
    with _LOCK:
        if _RANS_TRIED:
            return _RANS_LIB
        _RANS_TRIED = True
        if os.environ.get("REPNERV_NO_NATIVE"):
            return None
        try:
            lib = _build_and_dlopen(_RANS_SRC, _RANS_SO)
            lib.rans_encode.restype = ctypes.c_longlong
            lib.rans_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_longlong,
            ]
            lib.rans_decode.restype = ctypes.c_longlong
            lib.rans_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_longlong,
            ]
            _RANS_LIB = lib
        except Exception:
            _RANS_LIB = None
        return _RANS_LIB


def rans_native_encode(
    idx: np.ndarray, freq: np.ndarray, cum: np.ndarray, scale_bits: int
) -> Optional[bytes]:
    lib = _load_rans()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    freq = np.ascontiguousarray(freq, np.uint32)
    cum = np.ascontiguousarray(cum, np.uint32)
    # worst case ~2 bytes/symbol at scale_bits<=14 plus the 4 state bytes
    capacity = 2 * len(idx) + 64
    out = np.empty(capacity, np.uint8)
    nbytes = lib.rans_encode(
        _ptr(idx, ctypes.c_int32),
        len(idx),
        _ptr(freq, ctypes.c_uint32),
        _ptr(cum, ctypes.c_uint32),
        scale_bits,
        _ptr(out, ctypes.c_uint8),
        capacity,
    )
    if nbytes < 0:
        return None
    return out[: int(nbytes)].tobytes()


def rans_native_decode(
    blob: np.ndarray,
    freq: np.ndarray,
    cum: np.ndarray,
    slot2sym: np.ndarray,
    scale_bits: int,
    n_symbols: int,
) -> Optional[np.ndarray]:
    lib = _load_rans()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, np.uint8)
    freq = np.ascontiguousarray(freq, np.uint32)
    cum = np.ascontiguousarray(cum, np.uint32)
    slot2sym = np.ascontiguousarray(slot2sym, np.int32)
    out = np.empty(n_symbols, np.int32)
    produced = lib.rans_decode(
        _ptr(blob, ctypes.c_uint8),
        len(blob),
        _ptr(freq, ctypes.c_uint32),
        _ptr(cum, ctypes.c_uint32),
        _ptr(slot2sym, ctypes.c_int32),
        scale_bits,
        _ptr(out, ctypes.c_int32),
        n_symbols,
    )
    if produced != n_symbols:
        return None
    return out
