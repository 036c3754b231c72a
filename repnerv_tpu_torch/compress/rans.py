"""rANS entropy coding for quantized weights — the beyond-Huffman codec.

Huffman assigns whole bits per symbol, which costs ~9% overhead on the
near-gaussian quantized-weight histograms this pipeline emits (``efficiency``
~0.91).  (The port's own copy of ``repnerv_tpu/compress/rans.py``.)  rANS (Duda 2013) codes at fractional
bits/symbol, within ~0.1-1% of the entropy — a directly smaller BPP for the
same weights.  Selected with ``--codec rans`` (Huffman stays the default for
bit-exact parity with the reference's dahuffman accounting,
main_eval.py:673-698).

Static model: symbol frequencies quantized to sum ``1 << scale_bits`` by
largest-remainder (every present symbol keeps >= 1).  The serial encode /
decode loops run in C++ (native/rans.cpp via ctypes) with a pure-Python
fallback; both produce the identical bitstream.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .native import rans_native_decode, rans_native_encode

RANS_L = 1 << 23
SCALE_BITS = 12


def quantize_freqs(freqs: Dict[float, int], scale_bits: int = SCALE_BITS):
    """Largest-remainder quantization of a frequency table to sum 2**bits.

    Returns (symbols sorted, freq array uint32 — every entry >= 1).
    """
    if not freqs:
        raise ValueError("empty frequency table")
    syms = sorted(freqs)
    counts = np.array([freqs[s] for s in syms], np.float64)
    m = 1 << scale_bits
    if len(syms) > m:
        raise ValueError(f"more symbols ({len(syms)}) than slots ({m})")
    ideal = counts / counts.sum() * m
    f = np.maximum(np.floor(ideal), 1.0).astype(np.int64)
    # distribute the remaining +-delta to the largest buckets (they absorb
    # rounding with the least relative coding loss)
    delta = m - int(f.sum())
    order = np.argsort(-counts)
    i = 0
    while delta != 0:
        j = order[i % len(syms)]
        step = 1 if delta > 0 else -1
        if f[j] + step >= 1:
            f[j] += step
            delta -= step
        i += 1
    return syms, f.astype(np.uint32)


class RansCodec:
    """Static-model rANS codec over hashable symbols."""

    def __init__(self, syms: List, freq: np.ndarray, scale_bits: int = SCALE_BITS):
        self.syms = list(syms)
        self.freq = np.ascontiguousarray(freq, np.uint32)
        self.scale_bits = scale_bits
        self.cum = np.ascontiguousarray(
            np.concatenate([[0], np.cumsum(self.freq)[:-1]]), np.uint32
        )
        self._index = {s: i for i, s in enumerate(self.syms)}

    @classmethod
    def from_frequencies(cls, freqs: Dict[float, int], scale_bits: int = SCALE_BITS):
        syms, f = quantize_freqs(freqs, scale_bits)
        return cls(syms, f, scale_bits)

    @classmethod
    def from_data(cls, data, scale_bits: int = SCALE_BITS):
        return cls.from_frequencies(Counter(data), scale_bits)

    # -- bitstream ---------------------------------------------------------

    def encode(self, data: Sequence[float]) -> Tuple[bytes, int]:
        """Returns (blob, n_bits).  n_bits == len(blob) * 8 (byte stream)."""
        # vectorized symbol -> index: self.syms is sorted (quantize_freqs),
        # so searchsorted replaces the per-symbol dict lookup that made
        # --codec rans O(n) interpreter-bound on multi-million-weight models
        arr = np.asarray(data)
        sym_arr = np.asarray(self.syms)
        idx = np.ascontiguousarray(
            np.searchsorted(sym_arr, arr).astype(np.int32)
        )
        if (idx >= len(sym_arr)).any() or (sym_arr[idx] != arr).any():
            raise KeyError("symbol not in codec table")
        blob = rans_native_encode(idx, self.freq, self.cum, self.scale_bits)
        if blob is None:
            blob = self._encode_py(idx)
        return blob, len(blob) * 8

    def decode(self, blob: bytes, n_symbols: int) -> List[float]:
        slot2sym = np.repeat(
            np.arange(len(self.syms), dtype=np.int32), self.freq.astype(np.int64)
        )
        idx = rans_native_decode(
            np.frombuffer(blob, np.uint8),
            self.freq,
            self.cum,
            slot2sym,
            self.scale_bits,
            n_symbols,
        )
        if idx is None:
            idx = self._decode_py(blob, slot2sym, n_symbols)
        return [self.syms[i] for i in idx]

    # -- pure-python fallbacks (same bitstream as native/rans.cpp) ---------

    def _encode_py(self, idx: np.ndarray) -> bytes:
        x = RANS_L
        out = bytearray()
        freq, cum, sb = self.freq, self.cum, self.scale_bits
        for i in idx[::-1]:
            f = int(freq[i])
            x_max = ((RANS_L >> sb) << 8) * f
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            x = ((x // f) << sb) + (x % f) + int(cum[i])
        out.extend([(x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF])
        return bytes(out[::-1])

    def _decode_py(self, blob: bytes, slot2sym: np.ndarray, n: int) -> List[int]:
        x = int.from_bytes(blob[:4], "little")
        pos = 4
        mask = (1 << self.scale_bits) - 1
        out: List[int] = []
        freq, cum, sb = self.freq, self.cum, self.scale_bits
        for i in range(n):
            slot = x & mask
            s = int(slot2sym[slot])
            out.append(s)
            x = int(freq[s]) * (x >> sb) + slot - int(cum[s])
            # renormalize after EVERY symbol (incl. the last — restores the
            # encoder's initial RANS_L; see native/rans.cpp)
            while x < RANS_L:
                if pos >= len(blob):
                    raise ValueError("truncated rANS stream")
                x = (x << 8) | blob[pos]
                pos += 1
        if x != RANS_L or pos != len(blob):
            raise ValueError("corrupt rANS stream")
        return out


def entropy_stats_rans(codes: Sequence[float], quant_bit: int) -> Dict[str, float]:
    """Same shape as huffman.entropy_stats, with MEASURED bits (real encode)."""
    arr = np.asarray(codes)
    uniq, cnt = np.unique(arr, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    codec = RansCodec.from_frequencies(freqs)
    _, total_bits = codec.encode(arr)
    avg_bits = total_bits / max(arr.size, 1)
    return {
        "total_bits": float(total_bits),
        "avg_bits": avg_bits,
        "efficiency": avg_bits / quant_bit if quant_bit > 0 else 0.0,
        "num_symbols": float(len(freqs)),
    }
