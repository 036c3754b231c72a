"""Plain PyTorch reference of the first training steps: the forward of
``model.forward``, the Fusion6 loss, autograd's backward in f32, and Adam
written out (Kingma & Ba, with eps outside the square root, as
``torch.optim.Adam``) at the recipe's learning rate: a linear warmup from
0.1 of the base rate over ``int(warmup * epochs)`` epochs, then a cosine to
0, the epoch counted fractionally by steps.  The MS-SSIM of each step's
output is the step's metric.  And a val sweep: each frame's PSNR and
MS-SSIM under given weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import loss as L
from . import model as M


def lr_at(step: int, t: dict, steps_per_epoch: int) -> float:
    frac = step / steps_per_epoch
    warm = int(t["warmup"] * t["epochs"])
    if frac < warm:
        mult = 0.1 + 0.9 * frac / warm
    else:
        mult = 0.5 * (math.cos(math.pi * (frac - warm) / (t["epochs"] - warm)) + 1.0)
    return t["lr"] * mult


def steps(p0: Dict[str, torch.Tensor], m: dict, t: dict, frames: torch.Tensor,
          times: torch.Tensor, rows: List[List[int]], steps_per_epoch: int,
          prec: Optional[str] = None) -> dict:
    """Train from ``p0`` (left as it is) over the batches ``rows`` of
    ``frames`` [N, H, W, 3] uint8 and ``times`` [N].  Returns each step's
    "loss", "msssim" and "grads" (each leaf's gradient), and "params"
    (each leaf after the last step)."""
    b1, b2, eps = t["beta"], 0.999, 1e-8
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in p0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "msssim": [], "grads": []}
    with M.exact_f32():
        for n, r in enumerate(rows):
            idx = torch.as_tensor(r, device=frames.device)
            target = frames[idx].float().permute(0, 3, 1, 2) / 255.0
            pred = M.forward(p, m, times[idx], prec)
            loss = L.fusion6(pred, target)
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                out["loss"].append(loss.item())
                # the step's metric, where the frame is large enough for five levels
                big = min(pred.shape[2:]) > 160
                out["msssim"].append(L.ms_ssim(pred, target).item() if big else 0.0)
                out["grads"].append({k: g.clone() for k, g in zip(p, grads)})
                lr = lr_at(n, t, steps_per_epoch)
                for (k, v), g in zip(p.items(), grads):
                    mom[k].mul_(b1).add_(g, alpha=1 - b1)
                    vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    bc1, bc2 = 1 - b1 ** (n + 1), 1 - b2 ** (n + 1)
                    v.addcdiv_(mom[k], vel[k].sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)
            del pred, loss, grads
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out


@torch.no_grad()
def sweep(p: Dict[str, torch.Tensor], m: dict, frames: torch.Tensor, times: torch.Tensor,
          rows: List[int], batch: int, prec: Optional[str] = None) -> dict:
    """A val sweep of the model ``p`` over the frames ``rows`` in batches of
    ``batch``: each batch's "psnr" (-10 log10 of its mean squared error)
    and "msssim" (None where the frames are too small for five levels),
    repeated for each of its frames."""
    psnr, msssim = [], []
    with M.exact_f32():
        for i in range(0, len(rows), batch):
            idx = torch.as_tensor(rows[i : i + batch], device=frames.device)
            target = frames[idx].float().permute(0, 3, 1, 2) / 255.0
            pred = M.forward(p, m, times[idx], prec)
            psnr += [float(-10.0 * torch.log10(((pred - target) ** 2).mean()))] * len(idx)
            if min(pred.shape[2:]) > 160:
                msssim += [float(L.ms_ssim(pred, target))] * len(idx)
            del pred, target
    return {"psnr": psnr, "msssim": msssim or None}
