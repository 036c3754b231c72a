"""Huffman entropy coding for quantized weights.

Replaces the reference's ``dahuffman`` dependency (main_eval.py:658-698) with
our own codec: a canonical Huffman table built from symbol frequencies, plus
actual bitstream encode/decode (the reference only *counts* bits; we also
produce the real compressed artifact).

The bit-packing hot loop has a native C++ backend (native/huffman.cpp,
loaded via ctypes) with a pure-Python fallback — the entropy coder is the
only part of the pipeline that is irreducibly serial/host-side, so it is the
one place native code pays off (the reference has zero native components;
this is a runtime-side improvement, not a parity obligation).  (The port's
own copy of ``repnerv_tpu/compress/huffman.py``.)
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .native import native_decode, native_encode  # optional C++ backend


class HuffmanCodec:
    """Canonical Huffman codec over hashable symbols.

    ``get_code_table()`` returns {symbol: (bit_length, code_int)} — the same
    shape as dahuffman's table consumed at main_eval.py:680-691.
    """

    def __init__(self, code_table: Dict[float, Tuple[int, int]]):
        self._table = dict(code_table)
        # decode table: (bitlen, code) -> symbol
        self._decode = {v: k for k, v in self._table.items()}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_frequencies(cls, freqs: Dict[float, int]) -> "HuffmanCodec":
        if not freqs:
            raise ValueError("empty frequency table")
        if len(freqs) == 1:
            (sym,) = freqs
            return cls({sym: (1, 0)})
        # heap of (freq, tiebreak, node); node = symbol or (left, right)
        heap: List = []
        for i, (sym, f) in enumerate(sorted(freqs.items(), key=lambda kv: kv[0])):
            heap.append((f, i, sym))
        heapq.heapify(heap)
        next_id = len(heap)
        while len(heap) > 1:
            f1, _, n1 = heapq.heappop(heap)
            f2, _, n2 = heapq.heappop(heap)
            heapq.heappush(heap, (f1 + f2, next_id, (n1, n2)))
            next_id += 1
        lengths: Dict[float, int] = {}

        def walk(node, depth):
            if isinstance(node, tuple):
                walk(node[0], depth + 1)
                walk(node[1], depth + 1)
            else:
                lengths[node] = max(depth, 1)

        walk(heap[0][2], 0)
        # ONE canonical-assignment implementation: the encoder and the
        # bitstream decoder (from_lengths) must agree bit-for-bit, so
        # from_frequencies ends in the same code path the artifact reader
        # uses rather than duplicating the assignment loop.
        return cls.from_lengths(lengths)

    @classmethod
    def from_data(cls, data: Iterable) -> "HuffmanCodec":
        return cls.from_frequencies(Counter(data))

    @classmethod
    def from_lengths(cls, lengths: Dict[float, int]) -> "HuffmanCodec":
        """Rebuild a codec from {symbol: bit_length} — the canonical-code
        property makes lengths alone sufficient, which is what the bitstream
        artifact serializes (compress/bitstream.py)."""
        table: Dict[float, Tuple[int, int]] = {}
        code = 0
        prev_len = 0
        for sym in sorted(lengths, key=lambda s: (lengths[s], s)):
            ln = lengths[sym]
            code <<= ln - prev_len
            table[sym] = (ln, code)
            code += 1
            prev_len = ln
        return cls(table)

    # -- accounting --------------------------------------------------------

    def get_code_table(self) -> Dict[float, Tuple[int, int]]:
        return dict(self._table)

    def total_bits(self, freqs: Dict[float, int]) -> int:
        return sum(f * self._table[s][0] for s, f in freqs.items())

    # -- real bitstream ----------------------------------------------------

    def encode(self, data: Sequence[float]) -> Tuple[bytes, int]:
        """Pack symbols into a bitstream.  Returns (bytes, n_bits)."""
        arr = np.asarray(data)
        # canonical (length, code) order — required by the native decoder's
        # consecutive-code range lookup
        syms = sorted(self._table, key=lambda s: self._table[s])
        lens = np.array([self._table[s][0] for s in syms], np.int32)
        codes = np.array([self._table[s][1] for s in syms], np.uint64)
        # symbol -> canonical index via searchsorted over the value-sorted
        # symbols (symbols are exact quantized floats, so equality is exact);
        # a per-symbol Python dict lookup here costs seconds on flagship-size
        # streams (same fix as rans.py encode)
        sym_arr = np.asarray(syms)
        order = np.argsort(sym_arr, kind="stable").astype(np.int32)
        pos = np.searchsorted(sym_arr[order], arr)
        if pos.size and int(pos.max()) >= len(order):
            raise KeyError("symbol(s) above the codec table's range")
        idx = order[pos]
        if (sym_arr[idx] != arr).any():  # same guard as rans.py encode
            raise KeyError("symbol(s) not present in the codec table")
        packed = native_encode(idx, lens, codes)
        if packed is not None:
            return packed
        # pure-python fallback
        bits = 0
        nbits = 0
        out = bytearray()
        for i in idx:
            ln = int(lens[i])
            bits = (bits << ln) | int(codes[i])
            nbits += ln
            while nbits >= 8:
                nbits -= 8
                out.append((bits >> nbits) & 0xFF)
        total = int(lens[idx].sum())
        if nbits:
            out.append((bits << (8 - nbits)) & 0xFF)
        return bytes(out), total

    def decode(self, blob: bytes, n_symbols: int) -> List[float]:
        syms = sorted(self._table, key=lambda s: self._table[s])
        lens = np.array([self._table[s][0] for s in syms], np.int32)
        codes = np.array([self._table[s][1] for s in syms], np.uint64)
        idx = native_decode(np.frombuffer(blob, np.uint8), lens, codes, n_symbols)
        if idx is None:
            # pure-python fallback
            out = []
            cur = 0
            cur_len = 0
            pos = 0
            table = self._decode
            for byte in blob:
                for bit in range(7, -1, -1):
                    cur = (cur << 1) | ((byte >> bit) & 1)
                    cur_len += 1
                    sym = table.get((cur_len, cur))
                    if sym is not None:
                        out.append(sym)
                        cur = 0
                        cur_len = 0
                        if len(out) == n_symbols:
                            return out
            return out
        return [syms[i] for i in idx]


def entropy_stats(codes: Sequence[float], quant_bit: int) -> Dict[str, float]:
    """total/avg bits + encoding efficiency (main_eval.py:673-698)."""
    arr = np.asarray(codes)
    uniq, cnt = np.unique(arr, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    codec = HuffmanCodec.from_frequencies(freqs)
    total_bits = codec.total_bits(freqs)
    avg_bits = total_bits / max(arr.size, 1)
    return {
        "total_bits": float(total_bits),
        "avg_bits": avg_bits,
        "efficiency": avg_bits / quant_bit if quant_bit > 0 else 0.0,
        "num_symbols": float(len(freqs)),
    }


def bits_per_pixel(total_bits: float, n_frames: int, h: int, w: int) -> float:
    """BPP = huffman bits / (frames * H * W) (main_eval.py:714-727)."""
    pixels = n_frames * h * w
    return total_bits / pixels if pixels > 0 else 0.0
