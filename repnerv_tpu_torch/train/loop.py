"""Training and decode loops (port of ``repnerv_tpu/train/loop.py``).

The train step: positional encoding -> generator (train mode) -> multi-scale
targets by adaptive pooling -> the loss -> backward -> prune masks on the
gradients -> Adam(beta, 0.999, eps 1e-8) at the step's learning rate ->
prune masks on the parameters; PSNR (and MS-SSIM, under ``no_grad`` on the
detached outputs) as metrics.  torch's Adam with eps outside the square root
is optax ``scale_by_adam`` followed by ``p - lr * u``.

The JAX package runs an epoch as one ``lax.scan`` dispatch.  PyTorch runs
eagerly, so ``run_epoch`` is a Python loop over the steps, with the uint8
video resident on the device, the epoch's permutation sent to the device
once, and every metric kept on the device until one fetch at the end of the
epoch: no host sync per step.  (A CUDA-graph capture of the step is a later
step of the port.)  The learning rate is a host-side f32 function of the
step counter, so setting it costs no sync either.

Decoding runs one batch per call; throughput is timed with CUDA events on
the card, and a measurement without a card fails rather than timing the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..data.frames import FrameStore, adaptive_avg_pool
from ..models.embedding import positional_encoding
from ..models.generator import Generator
from ..ops.losses import multi_scale_loss
from ..ops.metrics import msssim_fn, psnr_fn
from .schedule import lr_at_step

DECODE_REPS = 3  # timed whole-video decodes per fps measurement

Masks = Optional[Dict[str, Optional[torch.Tensor]]]  # parameter name -> 0/1 mask


@dataclass
class TrainState:
    model: Generator  # in train mode
    optimizer: torch.optim.Adam
    step: int  # global step counter (drives the LR schedule)


@dataclass
class EpochMetrics:
    psnr: np.ndarray  # [n_stage]
    msssim: np.ndarray  # [n_stage]
    loss: float
    lr: float


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> torch.optim.Adam:
    """torch.optim.Adam(betas=(beta, 0.999), eps=1e-8), the reference's; the
    learning rate is set on every step.  On the card it is the fused
    implementation: one launch for all parameters instead of a few per
    tensor."""
    fused = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(
        model.parameters(), lr=cfg.lr, betas=(cfg.beta, 0.999), eps=1e-8, fused=fused
    )


def init_train_state(cfg: TrainConfig, device, seed: Optional[int] = None) -> TrainState:
    model = Generator(cfg.model, seed=cfg.manual_seed if seed is None else seed, device=device)
    model.train()
    return TrainState(model, make_optimizer(cfg, model), 0)


def _apply_masks(tensors: Dict[str, torch.Tensor], masks: Masks) -> None:
    if masks is None:
        return
    for name, t in tensors.items():
        m = masks.get(name)
        if m is not None and t is not None:
            t.mul_(m.to(t.dtype))


def build_train_step_fn(cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool = True):
    """The train step: (state, frames [B, H, W, 3] f32, t [B], masks | None)
    -> (state, aux) with aux["loss"], aux["lr"] and aux["psnr"] [n_stage]
    (and aux["msssim"]) as device tensors (``lr`` a float).  The state's
    model and optimizer update in place; its step counter advances."""
    mcfg = cfg.model
    warmup_epochs = cfg.warmup_epochs()
    # "sample" reproduces the reference's adjust_lr denominator at b > 1
    samples_per_epoch = (
        steps_per_epoch * cfg.data.batch_size if cfg.lr_frac_mode == "sample" else None
    )

    def step_fn(state: TrainState, frames: torch.Tensor, t: torch.Tensor, masks: Masks = None):
        lr = float(
            lr_at_step(
                state.step,
                base_lr=cfg.lr,
                steps_per_epoch=steps_per_epoch,
                epochs=cfg.epochs,
                warmup_epochs=warmup_epochs,
                lr_type=cfg.lr_type,
                lr_steps=cfg.lr_steps,
                samples_per_epoch=samples_per_epoch,
            )
        )
        model, opt = state.model, state.optimizer
        outs = model(positional_encoding(t, mcfg.embed))
        targets = [adaptive_avg_pool(frames, o.shape[1:3]) for o in outs]
        loss = multi_scale_loss(outs, targets, cfg.loss_type, cfg.lw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = dict(model.named_parameters())
        with torch.no_grad():
            _apply_masks({k: p.grad for k, p in params.items()}, masks)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            _apply_masks(params, masks)
            outs = [o.detach() for o in outs]
            aux = {"loss": loss.detach(), "lr": lr, "psnr": psnr_fn(outs, targets).mean(dim=0)}
            if with_msssim:
                aux["msssim"] = msssim_fn(outs, targets).mean(dim=0)
        state.step += 1
        return state, aux

    return step_fn


# PyTorch has no jit: the single-device step is the raw step itself
make_train_step = build_train_step_fn


def run_epoch(
    state: TrainState,
    step_fn,
    store: FrameStore,
    cfg: TrainConfig,
    epoch: int,
    masks: Masks = None,
    max_steps: Optional[int] = None,
) -> Tuple[TrainState, EpochMetrics]:
    """One epoch over the device-resident video in the JAX package's shuffled
    order (``np.random.default_rng(manual_seed * 100003 + epoch)``), with one
    device-to-host fetch of the stacked metrics at the end."""
    b = cfg.data.batch_size
    idx = store.sample_indices()
    np.random.default_rng(cfg.manual_seed * 100003 + epoch).shuffle(idx)
    n_steps = len(idx) // b
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    dev = store.frames.device
    perm = torch.from_numpy(idx[: n_steps * b].reshape(n_steps, b)).to(dev)
    t_all = torch.from_numpy(np.asarray(store.t, np.float32)).to(dev)
    losses, psnrs, msssims = [], [], []
    lr = 0.0
    for rows in perm:
        state, aux = step_fn(state, store.gather(rows), t_all[rows], masks)
        losses.append(aux["loss"])
        psnrs.append(aux["psnr"])
        if "msssim" in aux:
            msssims.append(aux["msssim"])
        lr = aux["lr"]
    loss = torch.stack(losses).mean().item()  # the epoch's one sync
    psnr = torch.stack(psnrs).mean(dim=0).cpu().numpy()
    msssim = torch.stack(msssims).mean(dim=0).cpu().numpy() if msssims else np.zeros_like(psnr)
    return state, EpochMetrics(psnr, msssim, loss, lr)


def make_eval_step(cfg: TrainConfig, with_msssim: bool = True):
    """eval(model, frames, t) -> (outputs, aux with [B, n_stage] metrics), in
    eval mode and without autograd."""
    mcfg = cfg.model

    @torch.no_grad()
    def eval_fn(model: nn.Module, frames: torch.Tensor, t: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            outs = model(positional_encoding(t, mcfg.embed))
        finally:
            model.train(was_training)
        targets = [adaptive_avg_pool(frames, o.shape[1:3]) for o in outs]
        aux = {"psnr": psnr_fn(outs, targets)}
        if with_msssim:
            aux["msssim"] = msssim_fn(outs, targets)
        return outs, aux

    return eval_fn


def evaluate(
    model: nn.Module,
    eval_step,
    store: FrameStore,
    cfg: TrainConfig,
    max_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Validation sweep in frame order -> (psnr [n_stage], msssim [n_stage])."""
    dev = store.frames.device
    psnrs, msssims = [], []
    for i, (rows, t) in enumerate(
        store.epoch_batches(cfg.data.batch_size, shuffle=False, seed=0, drop_last=False)
    ):
        if max_steps is not None and i >= max_steps:
            break
        _, aux = eval_step(model, store.gather(rows), torch.from_numpy(t).to(dev))
        psnrs.append(aux["psnr"])
        if "msssim" in aux:
            msssims.append(aux["msssim"])
    psnr = torch.cat(psnrs, 0).mean(dim=0).cpu().numpy()
    msssim = torch.cat(msssims, 0).mean(dim=0).cpu().numpy() if msssims else np.zeros_like(psnr)
    return psnr, msssim


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
