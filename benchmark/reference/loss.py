"""Plain PyTorch reference of the training loss and the step's metric, NCHW
images in [0, 1], float32.

SSIM as the ``pytorch_msssim`` package computes it, which the reference
implementation of NeRV trains with: an 11-tap gaussian window of sigma 1.5,
applied separably and VALID; C1 = (0.01 L)^2, C2 = (0.03 L)^2; the maps'
mean per channel, then over channels and the batch.  MS-SSIM: five levels
weighted (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), relu on each level's
contrast term, 2 x 2 average pooling between levels (zero padding on an odd
side, counted).  Fusion6 = 0.7 L1 + 0.3 (1 - SSIM).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """VALID separable gaussian of each channel of [B, C, H, W]."""
    c = x.shape[1]
    x = F.conv2d(x, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return F.conv2d(x, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)


def ssim_terms(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0):
    """Per-channel means [B, C] of the SSIM map and of the contrast map."""
    g = window(device=x.device)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu1, mu2 = blur(x, g), blur(y, g)
    s11 = blur(x * x, g) - mu1 * mu1
    s22 = blur(y * y, g) - mu2 * mu2
    s12 = blur(x * y, g) - mu1 * mu2
    cs = (2 * s12 + c2) / (s11 + s22 + c2)
    ssim_map = ((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs
    return ssim_map.flatten(2).mean(-1), cs.flatten(2).mean(-1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ssim_terms(x, y)[0].mean()


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    levels = []
    for i in range(len(WEIGHTS)):
        s, cs = ssim_terms(x, y)
        if i < len(WEIGHTS) - 1:
            levels.append(F.relu(cs))
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, padding=pad)
            y = F.avg_pool2d(y, 2, padding=pad)
    levels.append(F.relu(s))
    w = torch.tensor(WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.prod(torch.stack(levels) ** w[:, None, None], dim=0).mean()


def fusion6(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.7 * (pred - target).abs().mean() + 0.3 * (1.0 - ssim(pred, target))
