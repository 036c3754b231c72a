"""Post-training linear quantization — nonzero-aware, per-tensor or per-axis.

Parity target: ``quantize_per_tensor`` (reference utils.py:11-67) and the
state-dict sweep in main_eval.py:652-669:

* min/max statistics are taken over *non-zero* elements only (so pruned zeros
  do not widen the range);
* ``scale = (max - min) / 2**bit``; ``q = round((t - min) / (scale + 1e-19))``;
* 2D/4D weight tensors quantize per-axis (``quant_axis`` 0 or 1); everything
  else (biases, scalars) per-tensor (axis=-1);
* the dequantized values are written back for quality evaluation.

Data-dependent boolean masking keeps this on the host: it runs on numpy at
compression time, never in the train/decode path.  (The port's own copy of
``repnerv_tpu/compress/quantize.py``.)
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np


class QuantParams(NamedTuple):
    """Per-tensor dequantization metadata: ``dequant = t_min + scale * q``.

    ``t_min``/``scale`` are scalars (axis=-1) or per-slice vectors reshaped
    for broadcast against the tensor; ``axis`` records the grouping used.
    Serialized into the bitstream artifact (compress/bitstream.py) so a
    decoder can reconstruct the dequantized weights bit-exactly.
    """

    t_min: np.ndarray
    scale: np.ndarray
    axis: int


def quantize_per_tensor(
    t: np.ndarray, bit: int = 8, axis: int = -1, *, return_qparams: bool = False
):
    """Return (integer codes, dequantized array[, QuantParams]).
    axis=-1: global; 0/1: per-slice."""
    t = np.asarray(t, dtype=np.float32)
    if axis == -1:
        valid = t != 0
        if valid.any():
            t_min = t[valid].min()
            t_max = t[valid].max()
        else:
            t_min = np.float32(0.0)
            t_max = np.float32(0.0)
        scale = (t_max - t_min) / 2**bit
        tmin_b, scale_b = t_min, scale
    elif axis in (0, 1):
        n = t.shape[axis]
        mins = np.zeros(n, np.float32)
        maxs = np.zeros(n, np.float32)
        for i in range(n):
            sl = np.take(t, i, axis=axis)
            valid = sl != 0
            if valid.any():
                mins[i] = sl[valid].min()
                maxs[i] = sl[valid].max()
        scale = (maxs - mins) / 2**bit
        shape = [1] * t.ndim
        shape[axis] = n
        tmin_b = mins.reshape(shape)
        scale_b = scale.reshape(shape)
    else:
        raise ValueError(f"unsupported quant axis {axis}")

    quant = np.round((t - tmin_b) / (scale_b + 1e-19))
    dequant = tmin_b + scale_b * quant
    if return_qparams:
        qp = QuantParams(
            np.asarray(tmin_b, np.float32), np.asarray(scale_b, np.float32), axis
        )
        return quant, dequant.astype(np.float32), qp
    return quant, dequant.astype(np.float32)


def quantize_state(
    flat_params: Dict[str, np.ndarray],
    bit: int,
    axis: int = 0,
) -> Tuple[
    Dict[str, np.ndarray],
    Dict[str, np.ndarray],
    List[np.ndarray],
    Dict[str, QuantParams],
]:
    """Quantize every tensor of a flattened (torch-layout) param dict.

    Reference-exact tensor selection (main_eval.py:662):
    ``large_tf = v.dim() in {2, 4} and 'bias' not in k`` — 2D/4D non-bias
    tensors quantize along ``axis`` of their OIHW / [out, in] layout (axis 0,
    the default, groups per OUTPUT channel); everything else per-tensor.
    Returns (dequantized params, integer codes, list of nonzero code vectors
    for entropy-coding statistics, per-tensor QuantParams metadata).
    """
    dequant: Dict[str, np.ndarray] = {}
    codes: Dict[str, np.ndarray] = {}
    nonzero_codes: List[np.ndarray] = []
    qparams: Dict[str, QuantParams] = {}
    for k, v in flat_params.items():
        v = np.asarray(v)
        large = v.ndim in (2, 4) and "bias" not in k
        q, dq, qp = quantize_per_tensor(
            v, bit, axis if large else -1, return_qparams=True
        )
        codes[k] = q
        dequant[k] = dq
        qparams[k] = qp
        nonzero_codes.append(q[v != 0].flatten())
    return dequant, codes, nonzero_codes, qparams
