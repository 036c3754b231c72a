"""Quality metrics per multi-scale stage (port of ``repnerv_tpu/ops/metrics.py``).

``psnr_fn`` is ``-10 log10(mse)`` over the whole batch per stage, broadcast
to [B, n_stage]; ``msssim_fn`` computes MS-SSIM where ``min(H, W) > 160``
(the hard limit of 5 levels with an 11-tap window) and 0 elsewhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ssim import ms_ssim


def psnr_fn(outputs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-stage PSNR from the batch-mean MSE -> [B, n_stage]."""
    cols = [
        -10.0 * torch.log10(torch.mean((o.float() - t.float()) ** 2))
        for o, t in zip(outputs, targets)
    ]
    row = torch.stack(cols)
    return row[None, :].expand(outputs[0].shape[0], row.shape[0])


def msssim_fn(outputs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-stage MS-SSIM -> [B, n_stage]; 0 where the stage is too small."""
    vals = []
    for o, t in zip(outputs, targets):
        if min(o.shape[1], o.shape[2]) > 160:
            vals.append(ms_ssim(o.float(), t.float(), data_range=1.0, size_average=True))
        else:
            vals.append(torch.zeros((), dtype=torch.float32, device=o.device))
    row = torch.stack(vals)
    return row[None, :].expand(outputs[-1].shape[0], row.shape[0])


def round_tensor(x, num: int = 2, group_str: bool = False) -> str:
    """String formatting of a metric row (reference utils.py:213-238)."""
    x = np.asarray(x)
    if group_str:
        return "/".join(
            ",".join(str(round(float(e), num)) for e in x[i].flatten()) for i in range(x.shape[0])
        )
    return ",".join(str(round(float(e), num)) for e in x.flatten())
