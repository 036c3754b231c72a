"""Decode functions (the decode part of ``repnerv_tpu/train/loop.py``).

The JAX package decodes a whole video in one ``lax.scan`` dispatch; here a
Python loop over frame batches takes its place (PyTorch runs eagerly, and a
decode batch is tens of milliseconds of device work, so the host loop is not
what bounds it).  Throughput is timed with CUDA events on the card, and a
measurement without a card fails rather than timing the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..models.embedding import positional_encoding

DECODE_REPS = 3  # timed whole-video decodes per fps measurement


def make_decode_fn(cfg: TrainConfig) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """decode(model, t [B]) -> the final frame batch [B, H, W, 3] f32."""
    mcfg = cfg.model

    @torch.no_grad()
    def decode(model: nn.Module, t: torch.Tensor) -> torch.Tensor:
        return model(positional_encoding(t, mcfg.embed))[-1]

    return decode


def decode_video(
    model: nn.Module, cfg: TrainConfig, t_batches: torch.Tensor, *, keep_frames: bool = True
) -> torch.Tensor:
    """Decode every row of ``t_batches`` [n_batches, B].  Returns frames
    [n_batches, B, H, W, 3] (f32) when ``keep_frames``, else a checksum per
    batch [n_batches] (decode-and-discard, the throughput measurement)."""
    decode = make_decode_fn(cfg)
    outs = []
    for t in t_batches:
        frames = decode(model, t)
        outs.append(frames if keep_frames else frames.sum())
    return torch.stack(outs)


def decode_batch_cap(h: int, w: int, base: int = 8) -> int:
    """Decode batch that bounds activation memory: ``base`` frames at 720p,
    fewer at larger sizes (stage buffers scale with bsz*H*W)."""
    return min(max(base, 1), max(base * 921600 // (h * w), 1))


def measure_decode_fps(
    model: nn.Module, cfg: TrainConfig, t_all, bsz: int, reps: int = DECODE_REPS
) -> float:
    """Whole-video decode throughput on the card: one warm-up decode, then
    ``reps`` timed decodes of the same frames, each between two CUDA events;
    frames per second of the fastest.  Decodes ``(1 + reps) * n_batches``
    batches in all."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"decode fps is measured on a CUDA device, not {device}")
    t_all = np.asarray(t_all, np.float32)
    n_batches = max(len(t_all) // bsz, 1)
    t_mat = torch.from_numpy(t_all[: n_batches * bsz].reshape(n_batches, bsz)).to(device)
    decode_video(model, cfg, t_mat, keep_frames=False)  # warm-up: build, allocator
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        decode_video(model, cfg, t_mat, keep_frames=False)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return n_batches * bsz / min(times)
