"""Quantization-aware finetuning: train through the quantizer (port of
``repnerv_tpu/compress/qat.py``).

During the masked finetune the forward sees fake-quantized weights -- the
exact dequantized values the final ``quantize_state`` sweep will deploy --
while the gradient flows straight through (identity) to the latent f32
weights.  The fake quantizer is ``quantize_per_tensor``'s arithmetic in
PyTorch, in f32:

* min / max over the nonzero entries only (pruned zeros never widen the
  range); an all-zero slice gets min = max = 0;
* ``scale = (max - min) / 2**bit``, ``q = round((w - min) / (scale + 1e-19))``
  (half to even), ``dq = min + scale * q``; zeros fake-quantize to the
  dequantized code of zero, as the deployed artifact decodes them;
* 2D and 4D tensors per slice along ``quant_axis`` of the reference's
  layouts (OIHW convs, [out, in] linears -- the port's own, so axis 0 is
  dim 0 and the JAX package's layout remap is not needed); others per tensor.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def fake_quant_leaf(w: torch.Tensor, bit: int, axis: int) -> torch.Tensor:
    """Straight-through fake quantization of one tensor: per-tensor stats for
    ``axis=-1``, else per slice along ``axis``.  Value: ``w + (dq - w)`` with
    the dequantized ``dq`` (the JAX package's expression, rounded as it is);
    gradient: identity."""
    w32 = w.detach().to(torch.float32)
    flat = w32.reshape(1, -1) if axis == -1 else w32.movedim(axis, 0).reshape(w.shape[axis], -1)
    valid = flat != 0
    inf = torch.full((), float("inf"), device=w.device)
    any_valid = valid.any(dim=1)
    t_min = torch.where(any_valid, torch.where(valid, flat, inf).amin(dim=1), 0.0)
    t_max = torch.where(any_valid, torch.where(valid, flat, -inf).amax(dim=1), 0.0)
    shape = [1] * w.ndim
    if axis != -1:
        shape[axis] = -1
    t_min, t_max = t_min.reshape(shape), t_max.reshape(shape)
    scale = (t_max - t_min) / float(2**bit)
    q = torch.round((w32 - t_min) / (scale + 1e-19))
    dq = (t_min + scale * q).to(w.dtype)
    return w + (dq - w).detach()


def make_fake_quant(
    bit: int, quant_axis: int = 0
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """A {name: parameter} -> {name: fake-quantized parameter} transform, the
    in-graph mirror of ``quantize_state``'s sweep (2D/4D per axis, the rest
    per tensor)."""

    def transform(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            k: fake_quant_leaf(v, bit, quant_axis if v.ndim in (2, 4) else -1)
            for k, v in params.items()
        }

    return transform
