"""Separable VALID gaussian blur for SSIM / MS-SSIM, the port of
``repnerv_tpu/pallas_kernels/ssim_blur.py``.

Three differentiable functions over f32 maps; on CUDA tensors the first
and the last run the kernels of ``csrc/ssim_blur.cu``:

* ``ssim_stats(x, y, win, c1, c2)``: an SSIM term of [B, H, W, C] images,
  the per-channel means of the SSIM map and of the cs map, [B, C] each, in
  one launch that reads the images in place: the five moments are blurred
  and the formula and both sums run inside the kernel, which writes a few
  partial sums a plane and, only where a gradient is needed, the five
  moments for the backward.  Its backward is one launch per input that
  needs a gradient, which forms the moments' cotangents in its loader and
  writes the gradient in the images' layout.
* ``ssim_moments(x, y, win)``: the five blurred maps of an SSIM term,
  ``blur(x), blur(y), blur(x*x), blur(y*y), blur(x*y)``, each [N, H-K+1,
  W-K+1], in plain PyTorch, with a backward of one ``moments_vjp_reference``
  per input that needs a gradient: ``ssim_stats``' path on a CPU tensor.
* ``gauss_blur_valid(x, win)``: one map, the counterpart of the JAX function
  of that name.

The wrappers ``stats_forward`` and ``stats_vjp`` take CUDA tensors only;
``blur_valid`` and ``blur_full`` launch the kernel on a CUDA tensor and run
the plain version on a CPU one.  A launch that fails raises.  The plain
PyTorch versions (``*_reference``) run the exact-f32 slice sum of
``repnerv_tpu/ops/ssim.py::_gaussian_filter`` (never a conv, whose TF32 or
bf16 rounding SSIM cannot take), vertical taps first, each product and sum
rounded on its own.  The kernel does the same operations in the same order,
so the blurred maps agree to the bit.

The blur is linear and the window symmetric (the wrappers check), so the VJP
of a VALID blur is the same blur of the cotangent zero-padded by K-1 on each
side (``blur_full``); the kernel reads the cotangent as it is and fills the
padding in its loader.  The moments' VJP sums three terms,
``d_x = B(g_mu) + 2 x B(g_xx) + y B(g_xy)``, in an order that autograd does
not fix: it agrees with autograd through the plain version to ~1e-6 of the
largest |entry|, not to the bit.  The kernel's SSIM and cs means are the
plain formula's maps to the bit, summed in another order (per block, then
the blocks by ``.sum``): ~1e-7 relative.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .build import load_library

# kernel launches since the count was last set to 0 (chip_smoke.py reads it),
# and the same by entry point: "stats" the means alone, "stats_grad" the
# means and the moments kept for the backward, "vjp" the means' VJP, "blur"
# one map either way
LAUNCHES = 0
ROUTES = ("stats", "stats_grad", "vjp", "blur")
ROUTE_LAUNCHES: Dict[str, int] = dict.fromkeys(ROUTES, 0)

Window = Tuple[float, ...]

# csrc/ssim_blur.cu's TH and COLS: a block of a stats launch owns TILE_ROWS
# output rows and TILE_COLS - K + 1 output columns of a plane
TILE_ROWS, TILE_COLS = 32, 128


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
    """The gradient of the moments with respect to ``a`` (``b`` the other
    input) from the cotangents of blur(a), blur(a*a), blur(a*b):
    B(g_mu) + 2 a B(g_sq) + b B(g_ab), B the zero-padded blur."""
    full = [blur_full_reference(g, win) for g in (g_mu, g_sq, g_ab)]
    return full[0] + 2.0 * (full[1] * a) + full[2] * b


def stats_of_moments(moments, c1: float, c2: float):
    """(mean of the SSIM map, mean of the cs map) [N] of the five moments,
    the formula of ``pytorch_msssim`` as separate rounded ops."""
    mu1, mu2, e11, e22, e12 = moments
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2

    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))


def planes(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] images -> contiguous [B*C, H, W] planes, plane b*C + c
    channel c of image b."""
    b, h, w, c = img.shape
    return img.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()


def _image_stats(moments_of, x: torch.Tensor, y: torch.Tensor, win: Window, c1: float, c2: float):
    """``stats_of_moments`` of [B, H, W, C] images' planes, the moments by
    ``moments_of``, as [B, C] each."""
    ssim_mean, cs_mean = stats_of_moments(moments_of(planes(x), planes(y), win), c1, c2)
    return ssim_mean.reshape(x.shape[0], x.shape[3]), cs_mean.reshape(x.shape[0], x.shape[3])


def ssim_stats_reference(x: torch.Tensor, y: torch.Tensor, win: Window, c1: float, c2: float):
    """The plain version of ``ssim_stats``; its gradient is autograd's."""
    return _image_stats(ssim_moments_reference, x, y, win, c1, c2)


def stats_vjp_reference(moments, g_ssim, g_cs, a, b, win: Window, c1: float, c2: float):
    """The plain version of ``stats_vjp``, the kernel's loader as separate
    rounded ops: the cotangents (g_mu, g_sq, g_ab) of blur(a), blur(a*a),
    blur(a*b) from the planes' moments (mu_a, mu_b, e_aa, e_bb, e_ab) and the
    upstream [B, C], then the moments' VJP, returned as images."""
    mu_a, mu_b, e_aa, e_bb, e_ab = moments
    hw = mu_a.shape[1] * mu_a.shape[2]
    gs = (g_ssim.reshape(-1) / hw)[:, None, None]
    gc = (g_cs.reshape(-1) / hw)[:, None, None]
    m_aa, m_bb, m_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    b1 = m_aa + m_bb + c1
    b2 = (e_aa - m_aa) + (e_bb - m_bb) + c2
    lum = (2.0 * m_ab + c1) / b1
    cs = (2.0 * (e_ab - m_ab) + c2) / b2
    t = (gs * lum + gc) / b2
    g_mu = 2.0 * ((gs * cs) * (mu_b - lum * mu_a) / b1 + t * (cs * mu_a - mu_b))
    d = moments_vjp_reference(g_mu, -(t * cs), 2.0 * t, planes(a), planes(b), win)
    bsz, h, w, c = a.shape
    return d.reshape(bsz, c, h, w).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, win: Window, shape, *tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: all ``tensors`` contiguous f32
    of ``shape``, [N, H, W] planes or [B, H, W, C] images (N = B*C planes),
    on one CUDA device; at most 65535 planes, K odd in 3..15 and symmetric."""
    size = len(win)
    if size % 2 == 0 or not 3 <= size <= 15 or tuple(win) != tuple(reversed(win)):
        raise ValueError(f"{name}: needs a symmetric window of 3, 5, .. 15 taps, got {size}")
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {first.device}")
    if len(shape) not in (3, 4):
        raise TypeError(f"{name} needs [N, H, W] or [B, H, W, C] tensors, got {tuple(shape)}")
    for t in tensors:
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != first.device
                or not t.is_contiguous()):
            raise TypeError(f"{name} needs contiguous f32 tensors {tuple(shape)} on "
                            f"{first.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    n = shape[0] * (shape[3] if len(shape) == 4 else 1)
    if shape[1] < 1 or shape[2] < 1 or not 1 <= n <= 65535:
        raise ValueError(f"{name}: {size}-tap window on {tuple(shape)}")
    if 5 * n * (shape[1] + size) * (shape[2] + size) >= 2**31:
        raise ValueError(f"{name}: the tensors must hold fewer than 2**31 elements")


def _launch(entry_name: str, route: str, tensors, nhw, win: Window, *flags) -> None:
    """Call the C entry ``(tensors..., *nhw, window, size, flags..., stream)``
    (a tensor None: a null pointer); a refused launch raises."""
    global LAUNCHES
    lib = load_library()  # builds csrc/*.cu on first use
    dev = tensors[0].device
    taps = (ctypes.c_float * len(win))(*win)
    with torch.cuda.device(dev):
        err = getattr(lib, entry_name)(
            *[ctypes.c_void_p(None if t is None else t.data_ptr()) for t in tensors],
            *nhw,
            ctypes.cast(taps, ctypes.c_void_p),
            len(win),
            *flags,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"{entry_name} kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def stats_tiles(h: int, w: int, size: int) -> int:
    """The blocks a plane of a stats launch on [H, W] planes: its partial
    sums of each mean."""
    ho, wo, tw = h - size + 1, w - size + 1, TILE_COLS - (size - 1)
    return -(-wo // tw) * -(-ho // TILE_ROWS)


def stats_forward(x: torch.Tensor, y: torch.Tensor, win: Window, c1: float, c2: float,
                  keep_moments: bool):
    """(mean of the SSIM map [B, C], mean of the cs map [B, C], the planes'
    five moments or None) of CUDA [B, H, W, C] images: one kernel launch,
    which writes the moments only with ``keep_moments``."""
    _check("ssim_stats", win, x.shape, x, y)
    bsz, h, w, c = x.shape
    size = len(win)
    if h < size or w < size:
        raise ValueError(f"ssim_stats: {size}-tap window on {tuple(x.shape)}")
    tiles = stats_tiles(h, w, size)
    partial = torch.empty(2, bsz * c, tiles, device=x.device, dtype=torch.float32)
    moments = (torch.empty(5, bsz * c, h - size + 1, w - size + 1, device=x.device,
                           dtype=torch.float32) if keep_moments else None)
    _launch("repnerv_ssim_stats", "stats_grad" if keep_moments else "stats",
            (x, y, moments, partial), (bsz * c, h, w, c, tiles), win, c1, c2)
    # the blocks of a plane, in a fixed order
    ssim_mean, cs_mean = partial.sum(dim=2).reshape(2, bsz, c).unbind(0)
    return ssim_mean, cs_mean, None if moments is None else moments.unbind(0)


def stats_vjp(moments, g_ssim, g_cs, a: torch.Tensor, b: torch.Tensor, win: Window, c1: float,
              c2: float) -> torch.Tensor:
    """The gradient with respect to the CUDA images ``a`` of ``g_ssim`` [B, C]
    x mean(ssim map) + ``g_cs`` [B, C] x mean(cs map), from the planes'
    moments (mu_a, mu_b, e_aa, e_bb, e_ab) that ``stats_forward`` kept, in
    that order: one launch."""
    _check("ssim_stats_vjp", win, a.shape, a, b)
    bsz, h, w, c = a.shape
    p = len(win) - 1
    _check("ssim_stats_vjp", win, (bsz * c, h - p, w - p), *moments)
    for g in (g_ssim, g_cs):
        if (g.dtype != torch.float32 or tuple(g.shape) != (bsz, c) or g.device != a.device
                or not g.is_contiguous()):
            raise TypeError(f"ssim_stats_vjp needs contiguous f32 cotangents ({bsz}, {c}) on "
                            f"{a.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    d = torch.empty_like(a)
    _launch("repnerv_ssim_stats_vjp", "vjp", (*moments, g_ssim, g_cs, a, b, d), (bsz * c, h, w, c),
            win, c1, c2)
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
    _launch("repnerv_gauss_blur_valid", "blur", (x, out), (n, h, w), win, int(full))
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


class _SsimMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, win):
        x, y = x.contiguous(), y.contiguous()  # so the maps, and the order of their means
        ctx.win = win
        ctx.save_for_backward(x, y)
        return ssim_moments_reference(x, y, win)

    @staticmethod
    def backward(ctx, g_x, g_y, g_xx, g_yy, g_xy):
        x, y = ctx.saved_tensors
        d_x = (moments_vjp_reference(g_x, g_xx, g_xy, x, y, ctx.win)
               if ctx.needs_input_grad[0] else None)
        d_y = (moments_vjp_reference(g_y, g_yy, g_xy, y, x, ctx.win)
               if ctx.needs_input_grad[1] else None)
        return d_x, d_y, None


def ssim_moments(x: torch.Tensor, y: torch.Tensor, win: Window):
    """(blur(x), blur(y), blur(x*x), blur(y*y), blur(x*y)) of [N, H, W] f32
    maps (``win``: Python floats) in plain PyTorch; differentiable in ``x``
    and ``y``, one ``moments_vjp_reference`` per input."""
    return _SsimMoments.apply(x, y, win)


def _paired(moments):
    """The moments of (x, y) in the order of the pair (y, x)."""
    mu1, mu2, e11, e22, e12 = moments
    return mu2, mu1, e22, e11, e12


class _SsimStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, win, c1, c2):
        x, y = x.contiguous(), y.contiguous()
        ssim_mean, cs_mean, moments = stats_forward(x, y, win, c1, c2, keep_moments=True)
        ctx.win, ctx.c = win, (c1, c2)
        ctx.save_for_backward(x, y, *moments)
        return ssim_mean, cs_mean

    @staticmethod
    def backward(ctx, g_ssim, g_cs):
        x, y, *moments = ctx.saved_tensors
        g_ssim, g_cs = g_ssim.contiguous(), g_cs.contiguous()
        d_x = (stats_vjp(moments, g_ssim, g_cs, x, y, ctx.win, *ctx.c)
               if ctx.needs_input_grad[0] else None)
        d_y = (stats_vjp(_paired(moments), g_ssim, g_cs, y, x, ctx.win, *ctx.c)
               if ctx.needs_input_grad[1] else None)
        return d_x, d_y, None, None, None


def ssim_stats(x: torch.Tensor, y: torch.Tensor, win: Window, c1: float, c2: float):
    """(mean of the SSIM map, mean of the cs map), [B, C] each, of [B, H, W,
    C] f32 images (``win``: Python floats; ``c1``, ``c2``: the SSIM
    constants); differentiable in ``x`` and ``y``.  On a CUDA tensor one
    launch, which keeps the five moments only where autograd will need them;
    on a CPU tensor the plain formula over ``ssim_moments`` of the planes,
    with autograd's gradient through it."""
    if x.device.type == "cpu":
        return _image_stats(ssim_moments, x, y, win, c1, c2)
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _SsimStats.apply(x, y, win, c1, c2)
    ssim_mean, cs_mean, _ = stats_forward(x.contiguous(), y.contiguous(), win, c1, c2,
                                          keep_moments=False)
    return ssim_mean, cs_mean


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
