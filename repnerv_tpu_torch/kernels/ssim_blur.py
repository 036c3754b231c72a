"""Separable VALID gaussian blur for SSIM / MS-SSIM, the port of
``repnerv_tpu/pallas_kernels/ssim_blur.py``.

``gauss_blur_valid(x, win)`` blurs [N, H, W] f32 maps to [N, H-K+1, W-K+1].
On a CUDA tensor ``blur_valid`` launches the hand-written kernel in
``csrc/ssim_blur.cu`` and nothing else: a launch that fails raises.  On a
CPU tensor it runs the plain PyTorch version, ``blur_valid_reference``: the
exact-f32 slice sum of ``repnerv_tpu/ops/ssim.py::_gaussian_filter`` (never a
conv, whose TF32 or bf16 rounding SSIM cannot take), vertical taps first,
each product and sum rounded on its own.  The kernel does the same
operations in the same order, so the two agree to the bit.

The blur is linear and the window symmetric, so its VJP is the same blur on
the cotangent zero-padded by K-1 on each side; ``gauss_blur_valid`` is a
``torch.autograd.Function`` whose backward does that.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .build import load_library

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0


def window_tuple(size: int, sigma: float) -> Tuple[float, ...]:
    """The gaussian window as Python floats holding f32 values."""
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    return tuple(float(v) for v in g)


def blur_valid_reference(x: torch.Tensor, win: Tuple[float, ...]) -> torch.Tensor:
    """The plain version: [N, H, W] f32 -> [N, H-K+1, W-K+1], on any device."""
    size = len(win)
    ho, wo = x.shape[1] - size + 1, x.shape[2] - size + 1
    acc = win[0] * x[:, :ho]
    for k in range(1, size):
        acc = acc + win[k] * x[:, k : k + ho]
    out = win[0] * acc[:, :, :wo]
    for k in range(1, size):
        out = out + win[k] * acc[:, :, k : k + wo]
    return out


def blur_valid(x: torch.Tensor, win: Tuple[float, ...]) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; run the plain version on a CPU one."""
    global LAUNCHES
    if x.device.type == "cpu":
        return blur_valid_reference(x, win)
    if x.device.type != "cuda":
        raise ValueError(f"blur_valid runs on cuda or cpu tensors, not {x.device}")
    size = len(win)
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise TypeError(f"blur_valid needs a contiguous [N, H, W] f32 tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, h, w = x.shape
    if not 1 <= size <= 16 or h < size or w < size or not 1 <= n <= 65535:
        raise ValueError(f"blur_valid: {size}-tap window on {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError("blur_valid: the tensor must hold fewer than 2**31 elements")
    out = torch.empty(n, h - size + 1, w - size + 1, device=x.device, dtype=torch.float32)
    lib = load_library()  # builds csrc/*.cu on first use
    taps = (ctypes.c_float * size)(*win)
    with torch.cuda.device(x.device):
        err = lib.repnerv_gauss_blur_valid(
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            n, h, w,
            ctypes.cast(taps, ctypes.c_void_p),
            size,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"gauss_blur_valid kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


class _GaussBlurValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, win):
        ctx.win = win
        return blur_valid(x.contiguous(), win)

    @staticmethod
    def backward(ctx, ct):
        p = len(ctx.win) - 1
        return blur_valid(F.pad(ct, (p, p, p, p)).contiguous(), ctx.win), None


def gauss_blur_valid(x: torch.Tensor, win: Tuple[float, ...]) -> torch.Tensor:
    """Separable VALID gaussian blur on [N, H, W] f32 (``win``: Python
    floats); differentiable in ``x``."""
    return _GaussBlurValid.apply(x, win)
