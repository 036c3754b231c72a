"""Separable VALID gaussian blur for SSIM / MS-SSIM, the port of
``repnerv_tpu/pallas_kernels/ssim_blur.py``.

Two differentiable functions over [N, H, W] f32 maps, both on the kernels of
``csrc/ssim_blur.cu``:

* ``ssim_moments(x, y, win)``: the five blurred maps of an SSIM term,
  ``blur(x), blur(y), blur(x*x), blur(y*y), blur(x*y)``, each [N, H-K+1,
  W-K+1], in one launch; the products are formed inside the kernel.  Its
  backward is one launch per input that needs a gradient.
* ``gauss_blur_valid(x, win)``: one map, the counterpart of the JAX function
  of that name.

On a CUDA tensor the wrappers (``moments_forward``, ``moments_vjp``,
``blur_valid``, ``blur_full``) launch the hand-written kernel and nothing
else: a launch that fails raises.  On a CPU tensor they run the plain PyTorch
versions (``*_reference``): the exact-f32 slice sum of
``repnerv_tpu/ops/ssim.py::_gaussian_filter`` (never a conv, whose TF32 or
bf16 rounding SSIM cannot take), vertical taps first, each product and sum
rounded on its own.  The kernel does the same operations in the same order,
so the forward maps agree to the bit.

The blur is linear and the window symmetric (the wrappers check), so the VJP
of a VALID blur is the same blur of the cotangent zero-padded by K-1 on each
side (``blur_full``); the kernel reads the cotangent as it is and fills the
padding in its loader.  The moments' VJP sums three terms,
``d_x = B(g_mu) + 2 x B(g_xx) + y B(g_xy)``, in an order that autograd does
not fix: it agrees with autograd through the plain version to ~1e-6 of the
largest |entry|, not to the bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .build import load_library

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0

Window = Tuple[float, ...]


def window_tuple(size: int, sigma: float) -> Window:
    """The gaussian window as Python floats holding f32 values."""
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    return tuple(float(v) for v in g)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def blur_valid_reference(x: torch.Tensor, win: Window) -> torch.Tensor:
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


def blur_full_reference(ct: torch.Tensor, win: Window) -> torch.Tensor:
    """The plain VJP of the VALID blur: the blur of ``ct`` zero-padded by K-1."""
    p = len(win) - 1
    return blur_valid_reference(F.pad(ct, (p, p, p, p)), win)


def ssim_moments_reference(x: torch.Tensor, y: torch.Tensor, win: Window):
    """The plain version of ``ssim_moments``: five ``blur_valid_reference``
    calls; its gradient is autograd's."""
    return tuple(blur_valid_reference(a, win) for a in (x, y, x * x, y * y, x * y))


def moments_vjp_reference(g_mu, g_sq, g_ab, a, b, win: Window) -> torch.Tensor:
    """The plain version of ``moments_vjp``."""
    full = [blur_full_reference(g, win) for g in (g_mu, g_sq, g_ab)]
    return full[0] + 2.0 * (full[1] * a) + full[2] * b


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, win: Window, shape, *tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: all ``tensors`` contiguous f32
    of ``shape`` [N, H, W] on one CUDA device, H, W >= K, K odd in 3..15 and
    symmetric."""
    size = len(win)
    if size % 2 == 0 or not 3 <= size <= 15 or tuple(win) != tuple(reversed(win)):
        raise ValueError(f"{name}: needs a symmetric window of 3, 5, .. 15 taps, got {size}")
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {first.device}")
    if len(shape) != 3:
        raise TypeError(f"{name} needs [N, H, W] tensors, got {tuple(shape)}")
    for t in tensors:
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != first.device
                or not t.is_contiguous()):
            raise TypeError(f"{name} needs contiguous f32 tensors {tuple(shape)} on "
                            f"{first.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if shape[1] < 1 or shape[2] < 1 or not 1 <= shape[0] <= 65535:
        raise ValueError(f"{name}: {size}-tap window on {tuple(shape)}")
    if 5 * shape[0] * (shape[1] + size) * (shape[2] + size) >= 2**31:
        raise ValueError(f"{name}: the tensors must hold fewer than 2**31 elements")


def _launch(entry_name: str, tensors, nhw, win: Window, *flags: int) -> None:
    """Call the C entry ``(tensors..., N, H, W, window, size, flags..., stream)``;
    a refused launch raises."""
    global LAUNCHES
    lib = load_library()  # builds csrc/*.cu on first use
    dev = tensors[0].device
    taps = (ctypes.c_float * len(win))(*win)
    with torch.cuda.device(dev):
        err = getattr(lib, entry_name)(
            *[ctypes.c_void_p(t.data_ptr()) for t in tensors],
            *nhw,
            ctypes.cast(taps, ctypes.c_void_p),
            len(win),
            *flags,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"{entry_name} kernel launch failed: cudaError {err}")
    LAUNCHES += 1


def moments_forward(x: torch.Tensor, y: torch.Tensor, win: Window):
    """(blur(x), blur(y), blur(x*x), blur(y*y), blur(x*y)): one kernel launch
    on CUDA tensors (five views of one buffer), the plain version on CPU ones."""
    if x.device.type == "cpu":
        return ssim_moments_reference(x, y, win)
    _check("ssim_moments", win, x.shape, x, y)
    n, h, w = x.shape
    size = len(win)
    if h < size or w < size:
        raise ValueError(f"ssim_moments: {size}-tap window on {tuple(x.shape)}")
    out = torch.empty(5, n, h - size + 1, w - size + 1, device=x.device, dtype=torch.float32)
    _launch("repnerv_ssim_moments", (x, y, out), (n, h, w), win)
    return out.unbind(0)


def moments_vjp(g_mu, g_sq, g_ab, a: torch.Tensor, b: torch.Tensor, win: Window) -> torch.Tensor:
    """The gradient of the moments with respect to ``a`` from the cotangents
    of blur(a), blur(a*a), blur(a*b): one launch on CUDA tensors."""
    if a.device.type == "cpu":
        return moments_vjp_reference(g_mu, g_sq, g_ab, a, b, win)
    n, h, w = a.shape
    p = len(win) - 1
    _check("ssim_moments_vjp", win, a.shape, a, b)
    _check("ssim_moments_vjp", win, (n, h - p, w - p), g_mu, g_sq, g_ab)
    d = torch.empty_like(a)
    _launch("repnerv_ssim_moments_vjp", (g_mu, g_sq, g_ab, a, b, d), (n, h, w), win)
    return d


def _blur(x: torch.Tensor, win: Window, full: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return blur_full_reference(x, win) if full else blur_valid_reference(x, win)
    name = "blur_full" if full else "blur_valid"
    _check(name, win, x.shape, x)
    n, h, w = x.shape
    grow = (len(win) - 1) * (1 if full else -1)
    if h + grow < 1 or w + grow < 1:
        raise ValueError(f"{name}: {len(win)}-tap window on {tuple(x.shape)}")
    out = torch.empty(n, h + grow, w + grow, device=x.device, dtype=torch.float32)
    _launch("repnerv_gauss_blur_valid", (x, out), (n, h, w), win, int(full))
    return out


def blur_valid(x: torch.Tensor, win: Window) -> torch.Tensor:
    """[N, H, W] -> [N, H-K+1, W-K+1]: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    return _blur(x, win, full=False)


def blur_full(ct: torch.Tensor, win: Window) -> torch.Tensor:
    """[N, H, W] -> [N, H+K-1, W+K-1], the VALID blur of the zero-padded
    ``ct``: the kernel on a CUDA tensor (no padded copy is made), the plain
    version on a CPU one."""
    return _blur(ct, win, full=True)


# ---------------------------------------------------------------------------
# The differentiable functions
# ---------------------------------------------------------------------------


def _plain_layout(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()  # itself when it already is


class _SsimMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, win):
        x, y = x.contiguous(), y.contiguous()
        ctx.win = win
        ctx.save_for_backward(x, y)
        return moments_forward(x, y, win)

    @staticmethod
    def backward(ctx, g_x, g_y, g_xx, g_yy, g_xy):
        x, y = ctx.saved_tensors
        g_x, g_y, g_xx, g_yy, g_xy = map(_plain_layout, (g_x, g_y, g_xx, g_yy, g_xy))
        d_x = moments_vjp(g_x, g_xx, g_xy, x, y, ctx.win) if ctx.needs_input_grad[0] else None
        d_y = moments_vjp(g_y, g_yy, g_xy, y, x, ctx.win) if ctx.needs_input_grad[1] else None
        return d_x, d_y, None


def ssim_moments(x: torch.Tensor, y: torch.Tensor, win: Window):
    """(blur(x), blur(y), blur(x*x), blur(y*y), blur(x*y)) of [N, H, W] f32
    maps (``win``: Python floats); differentiable in ``x`` and ``y``."""
    return _SsimMoments.apply(x, y, win)


class _GaussBlurValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, win):
        ctx.win = win
        return blur_valid(x.contiguous(), win)

    @staticmethod
    def backward(ctx, ct):
        return blur_full(ct.contiguous(), ctx.win), None


def gauss_blur_valid(x: torch.Tensor, win: Window) -> torch.Tensor:
    """Separable VALID gaussian blur on [N, H, W] f32 (``win``: Python
    floats); differentiable in ``x``."""
    return _GaussBlurValid.apply(x, win)
