"""Write and read a ``.rnvb`` compressed-model artifact on the port's state
dict, the counterpart of ``repnerv_tpu/compress/bitstream.py``.

``write_bitstream`` serializes a quantized state dict into ONE file: header
JSON (model config, per-tensor shapes/axes, codec table), per-tensor
QuantParams (t_min/scale), packed sparsity bitmaps for pruned tensors, and the
entropy-coded nonzero codes (canonical Huffman or rANS).  ``read_bitstream``
parses it back to the reference-named numpy state dict, bit-exactly equal to
the dequantized state the compression pipeline evaluates (zero elements
decode deterministically from QuantParams alone).  The format and the bytes
are the JAX package's: the tests hold the two writers to equal files.

Format (little-endian):
  magic ``RNVB`` | u32 version | u64 header_len | header JSON |
  concat f32 t_min/scale arrays (order = header tensor order) |
  concat packbits sparsity bitmaps (tensors with n_zero > 0) |
  entropy-coded payload.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import ModelConfig, _tupled
from .huffman import HuffmanCodec
from .quantize import quantize_state
from .rans import RansCodec

MAGIC = b"RNVB"
VERSION = 1


def _codes_of_zero(qp_t_min: np.ndarray, qp_scale: np.ndarray) -> np.ndarray:
    """The integer code a zero element receives (reference utils.py:63-64)."""
    return np.round((0.0 - qp_t_min) / (qp_scale + 1e-19))


def write_bitstream(
    path: str,
    state: Dict[str, np.ndarray],
    mcfg: ModelConfig,
    quant_bit: int,
    quant_axis: int = 0,
    codec: str = "huffman",
    precomputed: Optional[Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]] = None,
) -> Dict[str, float]:
    """Quantize the reference-named ``state`` dict (reference grouping
    semantics) and write the artifact.  Returns accounting: file bytes,
    payload bits, symbol count.

    Deterministic: running this on the pre-quantization state produces an
    artifact whose decode equals ``compress()``'s dequantized output exactly
    (same quantize_state call).  ``precomputed`` lets the pipeline pass the
    ``(state, codes, qparams)`` its own quantize_state call just produced so
    the per-channel host sweep is not repeated (``state`` is then unread).
    """
    if precomputed is not None:
        state, codes, qparams = precomputed
    else:
        _, codes, _, qparams = quantize_state(state, quant_bit, quant_axis)

    keys = list(state.keys())
    all_nonzero = (
        np.concatenate([codes[k][state[k] != 0].ravel() for k in keys])
        if keys
        else np.zeros(0)
    )

    # frequency table via np.unique: a Counter over a multi-million-entry
    # Python list costs seconds of host time per artifact write
    uniq, cnt = np.unique(all_nonzero, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    if codec == "rans":
        cdc = RansCodec.from_frequencies(freqs)
        blob, n_bits = cdc.encode(all_nonzero)
        table = {
            "syms": [float(s) for s in cdc.syms],
            "freq": [int(f) for f in cdc.freq],
            "scale_bits": cdc.scale_bits,
        }
    else:
        cdc = HuffmanCodec.from_frequencies(freqs)
        blob, n_bits = cdc.encode(all_nonzero)
        tbl = cdc.get_code_table()
        table = {
            "syms": [float(s) for s in tbl],
            "lens": [int(tbl[s][0]) for s in tbl],
        }

    tensors = []
    qp_payload = bytearray()
    bitmap_payload = bytearray()
    for k in keys:
        v = np.asarray(state[k])
        qp = qparams[k]
        n_zero = int((v == 0).sum())
        tensors.append(
            {
                "key": k,
                "shape": list(v.shape),
                "axis": int(qp.axis),
                "n_zero": n_zero,
                "n_elem": int(v.size),
            }
        )
        qp_payload += np.ascontiguousarray(qp.t_min, np.float32).tobytes()
        qp_payload += np.ascontiguousarray(qp.scale, np.float32).tobytes()
        if n_zero:
            bitmap_payload += np.packbits((v == 0).ravel()).tobytes()

    header = json.dumps(
        {
            "version": VERSION,
            "quant_bit": quant_bit,
            "quant_axis": quant_axis,
            "codec": codec,
            "model_cfg": dataclasses.asdict(mcfg),
            "tensors": tensors,
            "codec_table": table,
            "n_symbols": int(all_nonzero.size),
            "payload_bits": int(n_bits),
        }
    ).encode()

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IQ", VERSION, len(header)))
        f.write(header)
        f.write(bytes(qp_payload))
        f.write(bytes(bitmap_payload))
        f.write(blob)

    return {
        "file_bytes": float(os.path.getsize(path)),
        "payload_bits": float(n_bits),
        "n_symbols": float(all_nonzero.size),
        "distinct_symbols": float(len(table["syms"])),
        "header_bytes": float(len(header) + 16),
        "qparams_bytes": float(len(qp_payload)),
        "bitmap_bytes": float(len(bitmap_payload)),
    }


def all_in_bpp(file_bytes: float, n_frames: int, h: int, w: int) -> float:
    """The honest BPP: every byte on disk over every displayed pixel."""
    pixels = n_frames * h * w
    return file_bytes * 8.0 / pixels if pixels > 0 else 0.0


def read_bitstream(path: str) -> Tuple[Dict[str, np.ndarray], ModelConfig, Dict[str, Any]]:
    """Decode the artifact -> (state dict of f32 numpy arrays, ModelConfig,
    header dict)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path} is not a RNVB bitstream")
        version, hlen = struct.unpack("<IQ", f.read(12))
        if version != VERSION:
            raise ValueError(f"unsupported bitstream version {version}")
        header = json.loads(f.read(hlen))
        rest = f.read()

    tensors = header["tensors"]
    off = 0
    qps = []  # per tensor (t_min, scale), shaped for broadcast
    for t in tensors:
        shape, axis = t["shape"], t["axis"]
        if axis == -1:
            qn, qshape = 1, ()
        else:
            qn = shape[axis]
            qshape = tuple(shape[axis] if d == axis else 1 for d in range(len(shape)))
        t_min = np.frombuffer(rest, np.float32, qn, off).reshape(qshape)
        off += 4 * qn
        scale = np.frombuffer(rest, np.float32, qn, off).reshape(qshape)
        off += 4 * qn
        qps.append((t_min, scale))
    masks = []  # per tensor: zero bitmap, or None when nothing was pruned
    for t in tensors:
        if t["n_zero"]:
            nbytes = (t["n_elem"] + 7) // 8
            bits = np.unpackbits(np.frombuffer(rest, np.uint8, nbytes, off), count=t["n_elem"])
            off += nbytes
            masks.append(bits.astype(bool))
        else:
            masks.append(None)
    blob = rest[off:]

    table = header["codec_table"]
    n_symbols = header["n_symbols"]
    if header["codec"] == "rans":
        cdc = RansCodec(table["syms"], np.asarray(table["freq"], np.uint32), table["scale_bits"])
    else:
        cdc = HuffmanCodec.from_lengths(dict(zip(table["syms"], table["lens"])))
    # f32 codes: the pipeline's dequant is an f32 multiply-add, so the same
    # precision keeps the decode bit-exact
    decoded = np.asarray(cdc.decode(blob, n_symbols), np.float32)

    state: Dict[str, np.ndarray] = {}
    pos = 0
    for t, (t_min, scale), zmask in zip(tensors, qps, masks):
        n_nonzero = t["n_elem"] - t["n_zero"]
        sym = decoded[pos : pos + n_nonzero]
        pos += n_nonzero
        codes = np.empty(t["n_elem"], np.float32)
        if zmask is None:
            codes[:] = sym
        else:
            # zero elements decode deterministically from their QuantParams
            zero_codes = np.broadcast_to(_codes_of_zero(t_min, scale), t["shape"]).ravel()
            codes[zmask] = zero_codes[zmask]
            codes[~zmask] = sym
        state[t["key"]] = (t_min + scale * codes.reshape(t["shape"])).astype(np.float32)
    if pos != n_symbols:
        raise ValueError("bitstream symbol count mismatch")

    mcfg = ModelConfig(**{k: _tupled(v) for k, v in header["model_cfg"].items()})
    return state, mcfg, header
