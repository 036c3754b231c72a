"""Read (and write) a ``.rnvb`` compressed-model artifact as the port's
state dict.

The parse of ``repnerv_tpu.compress.bitstream.read_bitstream``, ending at
the reference-named numpy state dict (what the writer serialized) instead of
a JAX pytree.  The format, the Huffman and rANS codecs and the zero-code rule
are the JAX package's own (numpy-only modules), reused here.  The state
equals the pipeline's dequantized state bit-exactly.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

from repnerv_tpu.compress.bitstream import MAGIC, VERSION, _codes_of_zero, write_bitstream
from repnerv_tpu.compress.huffman import HuffmanCodec
from repnerv_tpu.compress.quantize import quantize_state
from repnerv_tpu.config import ModelConfig, _tupled


def write_state_bitstream(
    path: str,
    state: Dict[str, np.ndarray],
    mcfg: ModelConfig,
    quant_bit: int = 8,
    quant_axis: int = 0,
    codec: str = "huffman",
) -> Dict[str, float]:
    """Quantize a reference-named state dict (e.g. a port model's
    ``state_dict()`` as numpy) and write it as a ``.rnvb`` artifact with the
    JAX package's numpy-only quantizer and writer.  Returns the writer's
    accounting (file bytes, payload bits, ...)."""
    _, codes, _, qparams = quantize_state(state, quant_bit, quant_axis)
    return write_bitstream(
        path, None, mcfg, quant_bit, quant_axis, codec, precomputed=(state, codes, qparams)
    )


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
        from repnerv_tpu.compress.rans import RansCodec

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
