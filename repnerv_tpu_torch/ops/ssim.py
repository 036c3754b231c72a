"""SSIM and MS-SSIM over NHWC images (port of ``repnerv_tpu/ops/ssim.py``).

Numerics follow the ``pytorch_msssim`` package, as the JAX package's do:
an 11-tap sigma 1.5 separable gaussian, VALID; C1 = (0.01 L)^2, C2 =
(0.03 L)^2; per-channel mean of the map, then the batch mean; MS-SSIM over
5 levels with relu on the intermediate ``cs`` values and 2x2 average-pool
downsampling with zero padding on odd sides (``count_include_pad``).

Images flatten once to [B*C, H, W] (the layout of the JAX package's Pallas
path, ``_ssim_maps_pallas``) and every blur goes through
``kernels/ssim_blur.gauss_blur_valid``: the hand-written kernel on a CUDA
tensor, at every size, and its exact-f32 plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssim_blur

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _ssim_maps(
    x: torch.Tensor,
    y: torch.Tensor,
    win: Tuple[float, ...],
    data_range: float,
    k: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (ssim, cs) means [B, C] of NHWC f32 images."""
    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    b, h, w, c = x.shape
    x2 = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
    y2 = y.permute(0, 3, 1, 2).reshape(b * c, h, w)

    def blur(a):
        return ssim_blur.gauss_blur_valid(a, win)

    mu1, mu2 = blur(x2), blur(y2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(x2 * x2) - mu1_sq
    sigma2_sq = blur(y2 * y2) - mu2_sq
    sigma12 = blur(x2 * y2) - mu1_mu2

    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)).reshape(b, c), cs_map.mean(dim=(1, 2)).reshape(b, c)


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k: Tuple[float, float] = (0.01, 0.03),
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM over NHWC images; ``size_average`` mirrors pytorch_msssim."""
    win = ssim_blur.window_tuple(win_size, win_sigma)
    per_channel, _ = _ssim_maps(x, y, win, data_range, k)
    per_image = per_channel.mean(dim=-1)
    return per_image.mean() if size_average else per_image


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``F.avg_pool2d(kernel_size=2, padding=(H%2, W%2))`` with
    count_include_pad=True: zero padding on both sides of an odd dim, window
    sum / 4."""
    h, w = x.shape[1], x.shape[2]
    out = F.avg_pool2d(
        x.permute(0, 3, 1, 2), kernel_size=2, padding=(h % 2, w % 2), count_include_pad=True
    )
    return out.permute(0, 2, 3, 1)


def ms_ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k: Tuple[float, float] = (0.01, 0.03),
    weights: Tuple[float, ...] = MS_WEIGHTS,
    size_average: bool = True,
) -> torch.Tensor:
    """Multi-scale SSIM, NHWC.  Needs min(H, W) > (win_size-1) * 2**4 for the
    default 5 levels."""
    levels = len(weights)
    smaller = min(x.shape[1], x.shape[2])
    if smaller <= (win_size - 1) * 2 ** (levels - 1):
        raise ValueError(
            f"image side {smaller} too small for {levels}-level ms_ssim with "
            f"win_size={win_size}; need > {(win_size - 1) * 2 ** (levels - 1)}"
        )
    win = ssim_blur.window_tuple(win_size, win_sigma)
    mcs = []
    ssim_pc = None
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_maps(x, y, win, data_range, k)
        if i < levels - 1:
            mcs.append(F.relu(cs_pc))
            x = avg_pool_2x2(x)
            y = avg_pool_2x2(y)
    # prod over levels of value**weight, with Python-float exponents (a
    # weight tensor built on the host would make the stream wait)
    ms = None
    for v, wt in zip(mcs + [F.relu(ssim_pc)], weights):
        ms = v**wt if ms is None else ms * v**wt  # [B, C]
    per_image = ms.mean(dim=-1)
    return per_image.mean() if size_average else per_image
