"""Upscale-conv variants (port of ``repnerv_tpu/models/upscale.py``), the
reference's ``CustomConv``: 'conv' (conv3x3 + PixelShuffle), 'deconv'
(ConvTranspose2d(k=s, stride=s)), 'bilinear' (align_corners upsample +
conv(2s+1)).

The reference's NeRVBlock never reads ``conv_type`` (the flag only feeds the
experiment name), so these are standalone layers kept for API completeness;
'conv' is the path the generator uses.  Tensors are NHWC; conv weights
OIHW, the deconv weight in ``nn.ConvTranspose2d``'s [in, out, kh, kw].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import conv2d, pixel_shuffle, torch_uniform

Params = Dict[str, Dict[str, torch.Tensor]]


def _conv(cin: int, cout: int, k: int, bias: bool, generator: torch.Generator) -> dict:
    fan_in = cin * k * k
    p = {"w": torch_uniform((cout, cin, k, k), fan_in, generator)}
    if bias:
        p["b"] = torch_uniform((cout,), fan_in, generator)
    return p


def init_custom_conv(ngf: int, new_ngf: int, stride: int, conv_type: str = "conv",
                     bias: bool = True, *, generator: torch.Generator) -> Params:
    """torch-default uniform init (bound 1/sqrt(fan_in)); the deconv's fan_in
    is in_channels * k * k, as the JAX package's."""
    if conv_type == "conv":
        return {"conv": _conv(ngf, new_ngf * stride * stride, 3, bias, generator)}
    if conv_type == "deconv":
        fan_in = ngf * stride * stride
        return {"deconv": {"w": torch_uniform((ngf, new_ngf, stride, stride), fan_in, generator),
                           "b": torch_uniform((new_ngf,), fan_in, generator)}}
    if conv_type == "bilinear":
        return {"conv": _conv(ngf, new_ngf, 2 * stride + 1, bias, generator)}
    raise KeyError(conv_type)


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC bilinear upsample on torch's ``align_corners=True`` grid:
    src = dst * (in - 1) / (out - 1)."""
    out = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale, mode="bilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def apply_custom_conv(params: Params, x: torch.Tensor, stride: int,
                      conv_type: str = "conv") -> torch.Tensor:
    if conv_type == "conv":
        return pixel_shuffle(conv2d(x, params["conv"]["w"], params["conv"].get("b")), stride)
    if conv_type == "deconv":
        p = params["deconv"]
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), stride=stride)
        return out.permute(0, 2, 3, 1) + p["b"].to(x.dtype)
    if conv_type == "bilinear":
        up = upsample_bilinear_align_corners(x, stride)
        return conv2d(up, params["conv"]["w"], params["conv"].get("b"))
    raise KeyError(conv_type)
