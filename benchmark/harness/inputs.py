"""A cell's inputs, made on the device from ``--seed``: the weights and the
video.  Both sides, the program and the reference, are handed the same.

Each input draws from its own stream of the seed (``stream``), so that
adding one never moves another.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

STREAMS = ("weights", "video", "sample")


def generator(seed: int, what: str, device) -> torch.Generator:
    """A generator on ``device`` for the input ``what`` of run ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * len(STREAMS) + STREAMS.index(what)) % (2 ** 63))
    return g


def weights(shapes: List[Tuple[str, tuple, int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``shapes`` ((name, shape, fan_in)) uniform in
    +-1/sqrt(fan_in), torch's default for convs and linears: one draw of
    all of them, then one scale a tensor.  f32 views of one buffer."""
    g = generator(seed, "weights", device)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        out[name] = flat[at : at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
    return out


def video(n_frames: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """[n, h, w, 3] uint8: the recipe of the JAX package's and the port's
    ``data/frames.py::synthetic_video`` in torch on the device (a
    translating four-octave value-noise texture, smooth colour gradients
    and a moving bright box; natural-image-like statistics keep SSIM
    non-degenerate).  Its own draws, so not the same bytes."""
    g = generator(seed, "video", device)

    def octave(cy: int, cx: int, amp: float) -> torch.Tensor:
        grid = torch.randn(1, 3, cy + 1, cx + 1, generator=g, device=device)
        return F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)[0] * amp

    texture = (octave(4, 6, 0.5) + octave(12, 20, 0.25) + octave(36, 60, 0.12)
               + octave(max(h // 8, 2), max(w // 8, 2), 0.06))  # [3, h, w]
    phases = torch.rand(3, 1, 1, generator=g, device=device) * 2 * math.pi
    freqs = 1.0 + 1.5 * torch.rand(3, 2, generator=g, device=device)
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    arg = 2 * math.pi * (freqs[:, 0, None, None] * yy + freqs[:, 1, None, None] * xx) + phases
    frames = torch.empty(n_frames, h, w, 3, dtype=torch.uint8, device=device)
    bh, bw = h // 4, w // 4
    for n in range(n_frames):
        t = n / n_frames
        img = 0.5 + 0.3 * torch.sin(arg + 2 * math.pi * t)
        img += torch.roll(texture, (int(t * h * 0.5) % h, int(t * w * 0.25) % w), dims=(1, 2))
        y0 = int((h - bh) * t)
        x0 = int((w - bw) * (0.5 + 0.5 * math.sin(2 * math.pi * t)))
        img[:, y0 : y0 + bh, x0 : x0 + bw] += 0.3
        frames[n] = torch.round(img.clamp(0, 1) * 255).permute(1, 2, 0).to(torch.uint8)
    return frames


def frame_times(n_frames: int) -> torch.Tensor:
    """t = i / n of each frame, f32 on the host."""
    return torch.arange(n_frames, dtype=torch.float32) / n_frames
