"""The 16 loss variants of the reference table (port of
``repnerv_tpu/ops/losses.py``).  The paper config uses ``Fusion6`` =
``0.7 * L1 + 0.3 * (1 - SSIM)``.  Losses take NHWC predictions and targets
in [0, 1] and return a scalar; the target is detached, as in the reference.
"""

from __future__ import annotations

import torch

from .ssim import ms_ssim, ssim


def _l2(pred, target):
    return torch.mean((pred - target) ** 2)


def _l1(pred, target):
    return torch.mean(torch.abs(pred - target))


def _ssim_loss(pred, target):
    return 1.0 - ssim(pred, target, data_range=1.0, size_average=True)


def _msssim_loss(pred, target):
    return 1.0 - ms_ssim(pred, target, data_range=1.0, size_average=True)


def _freq_l1(pred, target):
    """Per-image mean of 0.5 * (|Re dF| + |Im dF|) of the 2-D FFT over H, W,
    then the batch mean (the Fusion13/15 term, as the JAX package defines it)."""
    pf = torch.fft.fft2(pred, dim=(1, 2))
    tf = torch.fft.fft2(target, dim=(1, 2))
    diff = torch.abs(pf.real - tf.real) + torch.abs(pf.imag - tf.imag)
    per_image = diff.reshape(diff.shape[0], -1).mean(dim=1) * 0.5
    return per_image.mean()


# loss_type -> [(weight, term), ...]; Fusion13/15 add the FFT term to 60x this
_MIXES = {
    "L2": [(1.0, _l2)],
    "L1": [(1.0, _l1)],
    "SSIM": [(1.0, _ssim_loss)],
    "Fusion1": [(0.3, _l2), (0.7, _ssim_loss)],
    "Fusion2": [(0.3, _l1), (0.7, _ssim_loss)],
    "Fusion3": [(0.5, _l2), (0.5, _ssim_loss)],
    "Fusion4": [(0.5, _l1), (0.5, _ssim_loss)],
    "Fusion5": [(0.7, _l2), (0.3, _ssim_loss)],
    "Fusion6": [(0.7, _l1), (0.3, _ssim_loss)],
    "Fusion7": [(0.7, _l2), (0.3, _l1)],
    "Fusion8": [(0.5, _l2), (0.5, _l1)],
    "Fusion9": [(0.9, _l1), (0.1, _ssim_loss)],
    "Fusion10": [(0.7, _l1), (0.3, _msssim_loss)],
    "Fusion11": [(0.9, _l1), (0.1, _msssim_loss)],
    "Fusion12": [(0.8, _l1), (0.2, _msssim_loss)],
    "Fusion13": [(0.7, _l1), (0.3, _ssim_loss)],
    "Fusion15": [(0.7, _l1), (0.3, _msssim_loss)],
}
LOSS_TYPES = tuple(_MIXES)


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type not in _MIXES:
        raise KeyError(f"Unknown loss_type {loss_type}")
    target = target.detach()
    (w0, f0), *rest = _MIXES[loss_type]
    loss = w0 * f0(pred, target)
    for w, f in rest:
        loss = loss + w * f(pred, target)
    if loss_type in ("Fusion13", "Fusion15"):
        loss = 60.0 * loss + _freq_l1(pred, target)
    return loss


def multi_scale_loss(outputs, targets, loss_type: str, lw: float = 1.0) -> torch.Tensor:
    """Weighted sum over the heads: ``lw`` on all but the last output."""
    n = len(outputs)
    total = torch.zeros((), dtype=torch.float32, device=outputs[0].device)
    for i, (o, t) in enumerate(zip(outputs, targets)):
        li = loss_fn(o.float(), t.float(), loss_type)
        total = total + li * (lw if i < n - 1 else 1.0)
    return total
