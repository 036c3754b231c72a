"""Training and decode loops (port of ``repnerv_tpu/train/loop.py``).

The train step: positional encoding -> generator (train mode) -> multi-scale
targets by adaptive pooling -> the loss -> backward -> prune masks on the
gradients -> Adam(beta, 0.999, eps 1e-8) at the step's learning rate ->
prune masks on the parameters; PSNR (and MS-SSIM, under ``no_grad`` on the
detached outputs) as metrics.  torch's Adam with eps outside the square root
is optax ``scale_by_adam`` followed by ``p - lr * u``.  Its learning rate is
an f32 tensor on the parameters' device that the step writes: no host sync.

Two epoch runners over the device-resident uint8 video, both in the JAX
package's shuffled order and with one fetch of the stacked metrics at the
end of the epoch:

* ``run_epoch`` drives the eager step (``make_train_step``), a Python loop
  of steps;
* ``run_fused_epoch`` drives ``make_epoch_fn``, the counterpart of the JAX
  package's one ``lax.scan`` dispatch per epoch.  Its step reads everything
  from fixed device buffers: the epoch's frame-row matrix and learning-rate
  table (copied once per epoch), a step counter it advances itself, and the
  metric rows it writes.  On the card that step is captured once as a CUDA
  graph and replayed once per step; on the CPU the same step runs eagerly.

Decoding runs one batch per call; throughput is timed with CUDA events on
the card, and a measurement without a card fails rather than timing the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig, head_plan
from ..data.frames import FrameStore, adaptive_avg_pool
from ..kernels import launches
from ..models.embedding import positional_encoding
from ..models.generator import Generator
from ..ops.losses import multi_scale_loss
from ..ops.metrics import msssim_fn, psnr_fn
from .schedule import lr_at_step, lr_table

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
    """torch.optim.Adam(betas=(beta, 0.999), eps=1e-8), the reference's,
    with the learning rate as an f32 tensor on the parameters' device (the
    step writes it).  On the card it is the fused implementation (one launch
    for all parameters) and capturable, so that a CUDA graph can hold its
    step."""
    p0 = next(model.parameters())
    cuda = p0.device.type == "cuda"
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=p0.device)
    return torch.optim.Adam(
        model.parameters(), lr=lr, betas=(cfg.beta, 0.999), eps=1e-8, fused=cuda,
        capturable=cuda,
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


def _schedule(cfg: TrainConfig, steps_per_epoch: int) -> dict:
    """``lr_at_step``'s keyword arguments for ``cfg``."""
    return dict(
        base_lr=cfg.lr,
        steps_per_epoch=steps_per_epoch,
        epochs=cfg.epochs,
        warmup_epochs=cfg.warmup_epochs(),
        lr_type=cfg.lr_type,
        lr_steps=cfg.lr_steps,
        # "sample" reproduces the reference's adjust_lr denominator at b > 1
        samples_per_epoch=(
            steps_per_epoch * cfg.data.batch_size if cfg.lr_frac_mode == "sample" else None
        ),
    )


def _make_update(cfg: TrainConfig, with_msssim: bool, param_transform):
    """update(state, frames, t, masks, lr) -> aux: one step's forward,
    backward and Adam update at ``lr`` (a float, or a 0-dim f32 tensor on the
    device), in place; aux holds the device tensors "loss", "psnr" [n_stage]
    (and "msssim")."""
    mcfg = cfg.model

    def update(state: TrainState, frames, t, masks: Masks, lr) -> dict:
        model, opt = state.model, state.optimizer
        embed = positional_encoding(t, mcfg.embed)
        if param_transform is None:
            outs = model(embed)
        else:
            params = param_transform(dict(model.named_parameters()))
            outs = torch.func.functional_call(model, params, (embed,))
        targets = [adaptive_avg_pool(frames, o.shape[1:3]) for o in outs]
        loss = multi_scale_loss(outs, targets, cfg.loss_type, cfg.lw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = dict(model.named_parameters())
        with torch.no_grad():
            _apply_masks({k: p.grad for k, p in params.items()}, masks)
            for group in opt.param_groups:
                group["lr"].fill_(lr)  # a 0-dim tensor is copied on the device
            opt.step()
            _apply_masks(params, masks)
            outs = [o.detach() for o in outs]
            aux = {"loss": loss.detach(), "psnr": psnr_fn(outs, targets).mean(dim=0)}
            if with_msssim:
                aux["msssim"] = msssim_fn(outs, targets).mean(dim=0)
        return aux

    return update


def build_train_step_fn(
    cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool = True, param_transform=None
):
    """The train step: (state, frames [B, H, W, 3] f32, t [B], masks | None)
    -> (state, aux) with aux["loss"], aux["lr"] and aux["psnr"] [n_stage]
    (and aux["msssim"]) as device tensors (``lr`` a float).  The state's
    model and optimizer update in place; its step counter advances.

    ``param_transform`` ({name: parameter} -> {name: tensor}) is applied
    before the forward only: the forward runs on the transformed tensors
    (``torch.func.functional_call``) and the gradients reach the latent
    parameters through it (compress/qat.py's straight-through quantizer)."""
    lr_at = partial(lr_at_step, **_schedule(cfg, steps_per_epoch))
    update = _make_update(cfg, with_msssim, param_transform)

    def step_fn(state: TrainState, frames: torch.Tensor, t: torch.Tensor, masks: Masks = None):
        lr = float(lr_at(state.step))
        aux = update(state, frames, t, masks, lr)
        aux["lr"] = lr
        state.step += 1
        return state, aux

    return step_fn


# PyTorch has no jit: the single-device step is the raw step itself
make_train_step = build_train_step_fn


def epoch_rows(store: FrameStore, cfg: TrainConfig, epoch: int,
               max_steps: Optional[int] = None) -> np.ndarray:
    """The epoch's frame rows [n_steps, B] in the JAX package's shuffled
    order (``np.random.default_rng(manual_seed * 100003 + epoch)``)."""
    b = cfg.data.batch_size
    idx = store.sample_indices()
    np.random.default_rng(cfg.manual_seed * 100003 + epoch).shuffle(idx)
    n_steps = len(idx) // b
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    return idx[: n_steps * b].reshape(n_steps, b)


def _epoch_metrics(loss, psnr, msssim, lr: float) -> EpochMetrics:
    """The epoch's means from the stacked per-step metrics on the device:
    the epoch's one sync."""
    psnr_m = psnr.mean(dim=0).cpu().numpy()
    msssim_m = msssim.mean(dim=0).cpu().numpy() if msssim is not None else np.zeros_like(psnr_m)
    return EpochMetrics(psnr_m, msssim_m, loss.mean().item(), lr)


def run_epoch(
    state: TrainState,
    step_fn,
    store: FrameStore,
    cfg: TrainConfig,
    epoch: int,
    masks: Masks = None,
    max_steps: Optional[int] = None,
) -> Tuple[TrainState, EpochMetrics]:
    """One epoch of eager steps over the device-resident video, with one
    device-to-host fetch of the stacked metrics at the end."""
    dev = store.frames.device
    perm = torch.from_numpy(epoch_rows(store, cfg, epoch, max_steps)).to(dev)
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
    return state, _epoch_metrics(torch.stack(losses), torch.stack(psnrs),
                                 torch.stack(msssims) if msssims else None, lr)


@dataclass
class _StepBuffers:
    """The fused epoch's fixed device buffers: a captured step reads and
    writes only these (and the model, the optimizer and the video)."""

    perm: torch.Tensor  # [rows, B] int64: the epoch's frame rows
    t_all: torch.Tensor  # [N] f32: every frame's t
    lr: torch.Tensor  # [rows] f32: the epoch's learning rates
    k: torch.Tensor  # [1] int64: the step within the epoch, advanced by the step
    loss: torch.Tensor  # [rows] f32
    psnr: torch.Tensor  # [rows, n_stage] f32
    msssim: Optional[torch.Tensor]  # [rows, n_stage] f32


class FusedEpoch:
    """The epoch function of ``make_epoch_fn``:
    ``epoch_fn(state, store, perm [n_steps, B] int, masks) -> (state, aux)``
    runs ``n_steps`` train steps over the resident video, the step ``i`` on
    the rows ``perm[i]``; aux holds the stacked per-step metrics "loss"
    [n_steps], "psnr" [n_steps, n_stage] (and "msssim"), views of device
    buffers that the next call overwrites, and the host f32 learning rates
    "lr" [n_steps].

    On the card the first step after a change of what the graph holds (the
    first step of the run, or after another model, optimizer state, masks,
    video or batch size) runs eagerly on a side stream, as a real step of
    the trajectory that also makes every cache and Adam's state; then the
    step is captured as a CUDA graph, and every later step is one replay.
    A capture or a replay that fails raises: nothing falls back to eager."""

    streaming = False  # run_fused_epoch refuses a streaming epoch function (ROADMAP A7)

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool,
                 param_transform):
        self.cfg = cfg
        self.with_msssim = with_msssim
        self.schedule = _schedule(cfg, steps_per_epoch)
        self.update = _make_update(cfg, with_msssim, param_transform)
        self.buffers: Optional[_StepBuffers] = None
        self.graph = None  # torch.cuda.CUDAGraph of the step
        self.graph_key = None  # what the graph was captured on (_graph_key)
        self.replay_counts: Optional[launches.Counts] = None  # kernel launches of a replay

    def _buffers(self, store: FrameStore, b: int) -> _StepBuffers:
        rows = store.num_samples // b
        dev = store.frames.device
        buf = self.buffers
        if buf is None or buf.perm.shape != (rows, b) or buf.perm.device != dev:
            self.graph = self.graph_key = None  # it reads the old buffers
            n_stage = sum(head_plan(self.cfg.model))

            def zeros(*shape, dtype=torch.float32):
                return torch.zeros(*shape, dtype=dtype, device=dev)

            buf = self.buffers = _StepBuffers(
                perm=zeros(rows, b, dtype=torch.long), t_all=zeros(len(store.t)), lr=zeros(rows),
                k=zeros(1, dtype=torch.long), loss=zeros(rows), psnr=zeros(rows, n_stage),
                msssim=zeros(rows, n_stage) if self.with_msssim else None)
        return buf

    def step(self, state: TrainState, store: FrameStore, buf: _StepBuffers, masks: Masks) -> None:
        """One train step on the buffers: the rows ``perm[k]``, the learning
        rate ``lr[k]``, the metrics into row ``k``; then ``k += 1``."""
        k = buf.k
        rows = buf.perm.index_select(0, k).reshape(-1)
        aux = self.update(state, store.gather(rows), buf.t_all.index_select(0, rows), masks,
                          buf.lr.index_select(0, k).reshape(()))
        with torch.no_grad():
            buf.loss.index_copy_(0, k, aux["loss"].reshape(1))
            buf.psnr.index_copy_(0, k, aux["psnr"].reshape(1, -1))
            if buf.msssim is not None:
                buf.msssim.index_copy_(0, k, aux["msssim"].reshape(1, -1))
        k.add_(1)

    def _graph_key(self, state: TrainState, store: FrameStore, masks: Masks) -> tuple:
        """Everything a captured step holds by address."""
        opt = state.optimizer
        tensors = [store.frames]
        for group in opt.param_groups:
            tensors.append(group["lr"])
            for p in group["params"]:
                tensors.append(p)
                tensors.extend(v for v in opt.state.get(p, {}).values() if torch.is_tensor(v))
        names = tuple(sorted(k for k, m in (masks or {}).items() if m is not None))
        tensors.extend(masks[k] for k in names)
        return (id(state.model), id(opt), names, tuple(t.data_ptr() for t in tensors))

    def _capture(self, state: TrainState, store: FrameStore, buf: _StepBuffers,
                 masks: Masks) -> None:
        """Run one step eagerly on a side stream, then capture the step."""
        dev = store.frames.device
        self.graph = self.graph_key = None  # let the old graph's memory go first
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step(state, store, buf, masks)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        with torch.cuda.graph(graph):
            self.step(state, store, buf, masks)
        # the capture ran no kernel: its counts come back at every replay
        self.replay_counts = launches.since(before)
        launches.add(self.replay_counts, -1)
        self.graph, self.graph_key = graph, self._graph_key(state, store, masks)

    def __call__(self, state: TrainState, store: FrameStore, perm: np.ndarray, masks: Masks):
        n_steps, b = perm.shape
        buf = self._buffers(store, b)
        lrs = lr_table(state.step, n_steps, **self.schedule)
        buf.perm[:n_steps].copy_(torch.from_numpy(np.asarray(perm, np.int64)))
        buf.t_all.copy_(torch.from_numpy(np.asarray(store.t, np.float32)))
        buf.lr[:n_steps].copy_(torch.from_numpy(lrs))
        buf.k.zero_()
        if store.frames.device.type != "cuda":
            for _ in range(n_steps):
                self.step(state, store, buf, masks)
        else:
            replays = n_steps
            if n_steps and (self.graph is None
                            or self.graph_key != self._graph_key(state, store, masks)):
                self._capture(state, store, buf, masks)  # step 0 runs in here
                replays -= 1
            for _ in range(replays):
                self.graph.replay()
                launches.add(self.replay_counts)
        state.step += n_steps
        aux = {"loss": buf.loss[:n_steps], "psnr": buf.psnr[:n_steps], "lr": lrs}
        if buf.msssim is not None:
            aux["msssim"] = buf.msssim[:n_steps]
        return state, aux


def make_epoch_fn(
    cfg: TrainConfig,
    steps_per_epoch: int,
    with_msssim: bool = False,
    param_transform=None,
) -> FusedEpoch:
    """The whole-epoch train function (the JAX package's ``lax.scan`` epoch):
    a ``FusedEpoch``, which ``run_fused_epoch`` drives.  ``steps_per_epoch``
    sizes the learning-rate schedule; ``param_transform`` as in
    ``build_train_step_fn``, inside the captured step."""
    return FusedEpoch(cfg, steps_per_epoch, with_msssim, param_transform)


def run_fused_epoch(
    state: TrainState,
    epoch_fn,
    store: FrameStore,
    cfg: TrainConfig,
    epoch: int,
    masks: Masks = None,
    max_steps: Optional[int] = None,
) -> Tuple[TrainState, EpochMetrics]:
    """Drive ``make_epoch_fn``: the epoch's shuffled batch matrix on the host
    (the order of ``run_epoch``), one ``epoch_fn`` call, the stacked metrics
    reduced with one fetch; the learning rate of the epoch's last step."""
    if getattr(epoch_fn, "streaming", False):
        raise NotImplementedError(
            "a streaming epoch function (host-resident video) is not ported yet (ROADMAP A7)"
        )
    perm = epoch_rows(store, cfg, epoch, max_steps)
    state, aux = epoch_fn(state, store, perm, masks)
    return state, _epoch_metrics(aux["loss"], aux["psnr"], aux.get("msssim"),
                                 float(aux["lr"][-1]))


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
    """Validation sweep in frame order -> (psnr [n_stage], msssim [n_stage]).
    The frame rows and the ``t`` column go to the device once, before the
    sweep (a host tensor copied per batch would make the stream wait)."""
    dev = store.frames.device
    b = cfg.data.batch_size
    idx = store.sample_indices()
    if max_steps is not None:
        idx = idx[: max_steps * b]
    rows_all = torch.from_numpy(idx).to(dev)
    t_all = torch.from_numpy(np.asarray(store.t, np.float32)).to(dev)
    psnrs, msssims = [], []
    for i in range(0, len(idx), b):  # the last batch may be short
        rows = rows_all[i : i + b]
        _, aux = eval_step(model, store.gather(rows), t_all[rows])
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


def decode_time_batches(t_all, bsz: int) -> np.ndarray:
    """The frame times of a throughput measurement as [n_batches, B] f32: whole
    batches of ``bsz`` frames, the rest dropped; a video shorter than one
    batch is one batch of all its frames."""
    t_all = np.asarray(t_all, np.float32)
    if len(t_all) == 0:
        raise ValueError("decode_time_batches: no frame to decode")
    bsz = max(min(bsz, len(t_all)), 1)
    n_batches = len(t_all) // bsz
    return t_all[: n_batches * bsz].reshape(n_batches, bsz)


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
    t_np = decode_time_batches(t_all, bsz)
    n_batches, bsz = t_np.shape
    t_mat = torch.from_numpy(t_np).to(device)
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
