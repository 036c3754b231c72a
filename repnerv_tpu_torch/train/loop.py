"""Training and decode loops (port of ``repnerv_tpu/train/loop.py``).

The train step: positional encoding -> generator (train mode) -> multi-scale
targets by adaptive pooling -> the loss -> backward -> prune masks on the
gradients -> Adam(beta, 0.999, eps 1e-8) at the step's learning rate ->
prune masks on the parameters; PSNR (and MS-SSIM, under ``no_grad`` on the
detached outputs) as metrics.  torch's Adam with eps outside the square root
is optax ``scale_by_adam`` followed by ``p - lr * u``.  Its learning rate is
an f32 tensor on the parameters' device that the step writes: no host sync.

Two epoch runners, both in the JAX package's shuffled order and with one
fetch of the stacked metrics at the end of the epoch:

* ``run_epoch`` drives a step function, a Python loop of steps: the JAX
  package's jitted per-step ``make_train_step``, which on the card is one
  CUDA graph replay a step (``StepGraph``: the fused epoch's step on fixed
  buffers of one batch), or ``build_train_step_fn``, the eager step, its
  oracle and what runs on the CPU;
* ``run_fused_epoch`` drives ``make_epoch_fn``, the counterpart of the JAX
  package's one ``lax.scan`` dispatch per epoch.  Its step reads everything
  from fixed device buffers: the epoch's frame-row matrix and learning-rate
  table (copied once per epoch), a step counter it advances itself, and the
  metric rows it writes.  On the card that step is captured once as a CUDA
  graph and replayed once per step; on the CPU the same step runs eagerly.
  For a video on the host or on disk it drives ``make_streaming_epoch_fn``:
  the same step reads its frames from a ring of device chunk buffers, and
  the next chunk is copied in on a side stream while the graph replays the
  steps of the current one.  ``parallel/sharding.py`` captures the
  data-parallel step as two graphs around an all-reduce (the
  ``_capture_graphs`` / ``_replay`` hooks), and ``parallel/suite.py`` runs one
  ``FusedEpoch`` per video, each on its own stream.

The eval step (``make_eval_step``, which ``evaluate`` calls once a batch) is
the JAX package's jitted ``eval_fn``: on the card a batch is captured once
as a CUDA graph on fixed buffers and replayed once per batch (``EvalStep``);
``build_eval_step_fn``, the eager step, is its oracle and what runs on the
CPU.  Decoding (``make_video_decode_fn``, ``make_decode_fn``) is the JAX
package's one ``lax.scan`` dispatch per video: on the card a batch's decode
is captured once as a CUDA graph on fixed buffers and replayed once per
batch (``VideoDecode``); ``decode_video``, the eager loop of batches, is its
oracle and what runs on the CPU.  A replay changes the parameters in place
without Python, so it moves no ``_version``: the train graphs move it
themselves after their replays (``mark_written``), and every key or cache
that reads versions sees the new weights.  Throughput is timed with CUDA
events on the card, and a measurement without a card fails rather than
timing the CPU.

The step's parts (``step.forward``, ``step.loss``, ``step.backward``,
``step.adam``, ``step.metrics``), the epochs' edges, the step's capture and
the decode's host work run inside ``utils/profiling.py::span``s, and every
replay inside ``graph.replay:<id>`` of its capture's labels, so that a
trace charges a replayed kernel to the span that launched it at the
capture.  The train step, the eval step and the decode each hold one
``CapturedGraph``: the capture, the key it holds, the replay and its
launch counts, and the release, in one place.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig, head_plan, output_hw
from ..data.frames import FrameStore, adaptive_avg_pool, read_frames
from ..kernels import launches
from ..models.embedding import positional_encoding
from ..models.generator import Generator
from ..ops.losses import multi_scale_loss
from ..ops.metrics import msssim_fn, psnr_fn
from ..utils.profiling import capture_graph, labelled, span
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


def make_optimizer_like(opt: torch.optim.Adam, params) -> torch.optim.Adam:
    """A new optimizer over ``params`` with every setting of ``opt`` (one
    that ``make_optimizer`` made: the learning-rate tensor is shared)."""
    return type(opt)(params, **opt.defaults)


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


def _make_forward_backward(cfg: TrainConfig, param_transform, mesh=None):
    """fb(state, frames, t) -> (outputs, targets, loss): the forward, the
    loss and its backward into fresh ``.grad`` tensors; outputs and loss
    come back detached.  ``mesh``: the forward runs over it
    (``Generator.forward``'s argument)."""
    mcfg = cfg.model
    kw = {} if mesh is None else {"mesh": mesh}

    def forward_backward(state: TrainState, frames, t):
        model, opt = state.model, state.optimizer
        with span("step.forward"):
            embed = positional_encoding(t, mcfg.embed)
            if param_transform is None:
                outs = model(embed, **kw)
            else:
                params = param_transform(dict(model.named_parameters()))
                outs = torch.func.functional_call(model, params, (embed,), kw)
        with span("step.loss"):
            targets = [adaptive_avg_pool(frames, o.shape[1:3]) for o in outs]
            loss = multi_scale_loss(outs, targets, cfg.loss_type, cfg.lw)
        with span("step.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        return [o.detach() for o in outs], targets, loss.detach()

    return forward_backward


@torch.no_grad()
def apply_update(state: TrainState, masks: Masks, lr) -> None:
    """Adam at ``lr`` (a float, or a 0-dim f32 tensor on the device) on the
    ``.grad`` tensors, with the prune masks on the gradients before and on
    the parameters after, in place."""
    with span("step.adam"):
        params = dict(state.model.named_parameters())
        _apply_masks({k: p.grad for k, p in params.items()}, masks)
        for group in state.optimizer.param_groups:
            group["lr"].fill_(lr)  # a 0-dim tensor is copied on the device
        state.optimizer.step()
        _apply_masks(params, masks)


def _make_update(cfg: TrainConfig, with_msssim: bool, param_transform):
    """update(state, frames, t, masks, lr) -> aux: one step's forward,
    backward and Adam update at ``lr``, in place; aux holds the device
    tensors "loss", "psnr" [n_stage] (and "msssim")."""
    forward_backward = _make_forward_backward(cfg, param_transform)

    def update(state: TrainState, frames, t, masks: Masks, lr) -> dict:
        outs, targets, loss = forward_backward(state, frames, t)
        apply_update(state, masks, lr)
        with torch.no_grad(), span("step.metrics"):
            aux = {"loss": loss, "psnr": psnr_fn(outs, targets).mean(dim=0)}
            if with_msssim:
                aux["msssim"] = msssim_fn(outs, targets).mean(dim=0)
        return aux

    return update


def build_train_step_fn(
    cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool = True, param_transform=None
):
    """The eager train step: (state, frames [B, H, W, 3] f32, t [B], masks |
    None) -> (state, aux) with aux["loss"], aux["psnr"] [n_stage] (and
    aux["msssim"]) as device tensors and aux["lr"] a float.  The state's
    model and optimizer update in place; its step counter advances.  The
    oracle of ``make_train_step``'s graph step, and what it runs on the CPU.

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
    """One epoch of ``step_fn`` calls (``make_train_step``'s: on the card one
    CUDA graph replay a step; or the eager ``build_train_step_fn``), with one
    device-to-host fetch of the stacked metrics at the end.  A resident video
    is gathered on the device; a host or disk video one batch at a time on
    the host (``FrameStore.gather``), copied on the current stream, the one
    the graph step's copy into its frame buffer and its replay run on.
    A data-parallel step (``parallel.sharding.make_sharded_train_step``, which
    carries its ``mesh``) gets this rank's rows of each batch: every rank
    draws the same global permutation and keeps its slice of it."""
    dev = store.device
    with span("train.epoch_start"):
        rows_np = epoch_rows(store, cfg, epoch, max_steps)
        mesh = getattr(step_fn, "mesh", None)
        if mesh is not None:
            from ..parallel.sharding import local_batch

            rows_np = rows_np[:, local_batch(rows_np.shape[1], mesh)]
        perm = torch.from_numpy(rows_np).to(dev)
        t_all = torch.from_numpy(np.asarray(store.t, np.float32)).to(dev)
    losses, psnrs, msssims = [], [], []
    lr = 0.0
    for i, rows in enumerate(perm):
        frames = store.gather(rows if store.resident else rows_np[i])
        state, aux = step_fn(state, frames, t_all[rows], masks)
        losses.append(aux["loss"])
        psnrs.append(aux["psnr"])
        if "msssim" in aux:
            msssims.append(aux["msssim"])
        lr = aux["lr"]
    with span("train.epoch_end"):
        metrics = _epoch_metrics(torch.stack(losses), torch.stack(psnrs),
                                 torch.stack(msssims) if msssims else None, lr)
    return state, metrics


def mark_written(tensors) -> None:
    """Move the ``_version`` of tensors that a CUDA graph replay wrote in
    place.  A replay runs no Python, so their versions stand still while
    their values change; every key or cache that reads versions
    (``decode_graph_key``, ``eval_graph_key``, the packed decode weights of
    ``Generator._packed_stage``) would go on reading the old weights."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


class CapturedGraph:
    """The CUDA-graph lifecycle of one owner: the train step's
    (``FusedEpoch`` and its subclasses), the eval step's (``EvalStep``) or
    the decode's (``VideoDecode``).  ``graph`` is what the owner's capture
    callable returned (a ``CUDAGraph``, a graph and its outputs, or the
    sharded step's two graphs), ``key`` what it was captured on, ``counts``
    the kernel launches of one replay, ``labels`` the capture's span labels
    and ``captures`` the captures since construction.  Each owner computes
    its own key (the train key holds addresses, since the step writes the
    weights; the eval and decode keys hold versions too) and hands it over
    as a callable: the train key reads tensors that the step's first run
    makes (Adam's state, the sharded step's bucket), so it is taken only
    where a graph is held and once a capture is done.  ``holds`` is the one
    place that compares it."""

    def __init__(self):
        self.graph = None
        self.key = None
        self.counts: Optional[launches.Counts] = None
        self.labels = None
        self.captures = 0

    def holds(self, key: Callable[[], object]) -> bool:
        """Whether a graph is captured, on ``key()``."""
        return self.graph is not None and self.key == key()

    def drop(self) -> None:
        """Let the graph and its pool go: the buffers it reads changed, or
        its owner releases it."""
        self.graph = self.key = None

    def capture(self, device: torch.device, key: Callable[[], object],
                eager: Callable[[], None], capture: Callable[[torch.cuda.Stream], object],
                kind: str):
        """Drop the old graph, run ``eager()`` on a new side stream of
        ``device``, then ``capture(side)``, which captures its CUDA graphs on
        that stream through ``utils/profiling.py::capture_graph``, with
        cyclic collection held off and its labels a ``Labels`` whose id
        begins with ``kind``.  Keeps what ``capture`` returned as ``graph``,
        on ``key()``, taken once the capture is done.

        The eager run builds the kernels and fills every cache a capture must
        find full (packed weights, PE factors, cuDNN's and cuBLAS's plans).
        Each capture has a stream of its own, not torch's one default capture
        stream: cuBLAS keeps one workspace per stream, which a graph then
        holds, and two graphs captured on one stream and replayed side by
        side (the parallel suite) would share it.  The capture runs no
        kernel: its launch counts are taken back here, and ``replay`` adds
        them (``kernels/launches.py``)."""
        self.drop()  # let the old graph's memory go first
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            eager()
        torch.cuda.current_stream(device).wait_stream(side)
        before = launches.snapshot()
        # no cyclic collection inside the capture: freeing pinned memory that
        # a copy used makes the host allocator record and query CUDA events,
        # which invalidates a capture (torch.cuda.graph collects first)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with labelled(kind) as labels:
                graph = capture(side)
        finally:
            if collecting:
                gc.enable()
        self.counts, self.labels = launches.since(before), labels
        launches.add(self.counts, -1)
        self.graph, self.key = graph, key()
        self.captures += 1

    def replay(self, run: Callable[[], None]) -> None:
        """``run()``, which replays the graph, inside ``span(labels.span)``,
        by which a trace's summary charges each replayed op to the span that
        launched it at the capture; then the replay's launches are counted."""
        with span(self.labels.span):
            run()
        launches.add(self.counts)


@dataclass
class _StepBuffers:
    """The fused epoch's fixed device buffers: a captured step reads and
    writes only these (and the model, the optimizer and its frames)."""

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

    streaming = False  # run_fused_epoch dispatches on this tag

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool,
                 param_transform):
        self.cfg = cfg
        self.with_msssim = with_msssim
        self.schedule = _schedule(cfg, steps_per_epoch)
        self.update = _make_update(cfg, with_msssim, param_transform)
        self.buffers: Optional[_StepBuffers] = None
        self.captured = CapturedGraph()  # of _capture_graphs, on _graph_key

    def _check_store(self, store: FrameStore) -> None:
        if not store.resident:
            raise ValueError("make_epoch_fn runs over a device-resident video; a host or disk "
                             "video takes make_streaming_epoch_fn")

    def _buffers(self, store: FrameStore, b: int, n_steps: int) -> _StepBuffers:
        # a suite's shorter video runs the longest video's steps (parallel/suite.py)
        rows = max(store.num_samples // b, n_steps)
        dev = store.device
        buf = self.buffers
        if buf is None or buf.perm.shape != (rows, b) or buf.perm.device != dev:
            buf = self._new_buffers(dev, rows, b, len(store.t))
        return buf

    def _new_buffers(self, dev: torch.device, rows: int, b: int, n_t: int) -> _StepBuffers:
        """Zeroed buffers of ``rows`` steps of ``b`` frames and ``n_t`` frame
        times; the graph, which reads the old ones, is dropped."""
        self.captured.drop()
        n_stage = sum(head_plan(self.cfg.model))

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        self.buffers = _StepBuffers(
            perm=zeros(rows, b, dtype=torch.long), t_all=zeros(n_t), lr=zeros(rows),
            k=zeros(1, dtype=torch.long), loss=zeros(rows), psnr=zeros(rows, n_stage),
            msssim=zeros(rows, n_stage) if self.with_msssim else None)
        return self.buffers

    def _frames(self, store: FrameStore, buf: _StepBuffers, rows: torch.Tensor) -> torch.Tensor:
        """The step's frames [B, H, W, 3] f32: gathered from the resident video."""
        return store.gather(rows)

    def _held(self, store: FrameStore) -> list:
        """The frame tensors a captured step reads by address."""
        return [store.frames]

    def step(self, state: TrainState, store: FrameStore, buf: _StepBuffers, masks: Masks) -> None:
        """One train step on the buffers: the rows ``perm[k]``, the learning
        rate ``lr[k]``, the metrics into row ``k``; then ``k += 1``."""
        k = buf.k
        rows = buf.perm.index_select(0, k).reshape(-1)
        aux = self.update(state, self._frames(store, buf, rows),
                          buf.t_all.index_select(0, rows), masks,
                          buf.lr.index_select(0, k).reshape(()))
        with torch.no_grad(), span("step.metrics"):
            buf.loss.index_copy_(0, k, aux["loss"].reshape(1))
            buf.psnr.index_copy_(0, k, aux["psnr"].reshape(1, -1))
            if buf.msssim is not None:
                buf.msssim.index_copy_(0, k, aux["msssim"].reshape(1, -1))
        k.add_(1)

    def _graph_key(self, state: TrainState, store: FrameStore, masks: Masks) -> tuple:
        """Everything a captured step holds by address."""
        opt = state.optimizer
        tensors = self._held(store)
        for group in opt.param_groups:
            tensors.append(group["lr"])
            for p in group["params"]:
                tensors.append(p)
                tensors.extend(v for v in opt.state.get(p, {}).values() if torch.is_tensor(v))
        names = tuple(sorted(k for k, m in (masks or {}).items() if m is not None))
        tensors.extend(masks[k] for k in names)
        return (id(state.model), id(opt), names, tuple(t.data_ptr() for t in tensors))

    def _capture_graphs(self, state: TrainState, store: FrameStore, buf: _StepBuffers,
                        masks: Masks, stream):
        """Capture the step on ``stream`` (the caller holds off cyclic
        collection); returns what ``_replay`` replays."""
        graph = torch.cuda.CUDAGraph()
        with capture_graph(graph, stream):
            self.step(state, store, buf, masks)
        return graph

    def _replay(self) -> None:
        self.captured.graph.replay()

    def _start(self, state: TrainState, store: FrameStore, perm: np.ndarray):
        """The epoch's buffers with its rows, t, learning rates and k = 0;
        returns (buffers, the host learning rates)."""
        self._check_store(store)
        n_steps, b = perm.shape
        with span("train.epoch_start"):
            buf = self._buffers(store, b, n_steps)
            lrs = lr_table(state.step, n_steps, **self.schedule)
            buf.perm[:n_steps].copy_(torch.from_numpy(np.asarray(perm, np.int64)))
            buf.t_all.copy_(torch.from_numpy(np.asarray(store.t, np.float32)))
            buf.lr[:n_steps].copy_(torch.from_numpy(lrs))
            buf.k.zero_()
        return buf, lrs

    def _steps(self, state: TrainState, store: FrameStore, buf: _StepBuffers, masks: Masks,
               n: int) -> None:
        """``n`` steps from the buffers' ``k`` on: eagerly on the CPU; on the
        card one replay each, the first after a capture when the key moved.
        After replays the model's tensors are marked written (``mark_written``)."""
        if buf.k.device.type != "cuda":
            for _ in range(n):
                self.step(state, store, buf, masks)
            return
        key = partial(self._graph_key, state, store, masks)
        if n and not self.captured.holds(key):
            with span("train.capture"):  # one step runs eagerly in here
                self.captured.capture(
                    buf.k.device, key, lambda: self.step(state, store, buf, masks),
                    lambda side: self._capture_graphs(state, store, buf, masks, side), "step")
            n -= 1
        for _ in range(n):
            self.captured.replay(self._replay)
        if n:
            mark_written([*state.model.parameters(), *state.model.buffers()])

    def _finish(self, state: TrainState, buf: _StepBuffers, n_steps: int, lrs: np.ndarray):
        state.step += n_steps
        aux = {"loss": buf.loss[:n_steps], "psnr": buf.psnr[:n_steps], "lr": lrs}
        if buf.msssim is not None:
            aux["msssim"] = buf.msssim[:n_steps]
        return state, aux

    def __call__(self, state: TrainState, store: FrameStore, perm: np.ndarray, masks: Masks):
        buf, lrs = self._start(state, store, perm)
        self._steps(state, store, buf, masks, len(perm))
        return self._finish(state, buf, len(perm), lrs)


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


class StepGraph(FusedEpoch):
    """The train step of ``make_train_step``, the JAX package's jitted step:
    ``step(state, frames [B, H, W, 3] f32, t [B], masks | None) -> (state,
    aux)``, the surface of ``build_train_step_fn``: aux holds "loss", "psnr"
    [n_stage] (and "msssim") as device tensors that a later call does not
    overwrite, and "lr" a float; ``state.step`` advances on the host.

    On the card it is ``FusedEpoch``'s step on buffers of one batch: the
    frames and ``t`` are copied into fixed device buffers, the step's
    learning rate is written into one by ``fill_`` (no host tensor), and the
    step reads row 0 of them.  The first call after a change of
    ``FusedEpoch._graph_key`` (the model, the optimizer and its state, the
    masks, the frame buffer: a new batch shape) runs eagerly on a side
    stream; then the step is captured, and every later call is one replay.
    The divergence guard's restore writes into the same tensors, so the
    graph replays on.  A capture or a replay that fails raises.  On the CPU
    the eager ``build_train_step_fn`` runs."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool,
                 param_transform):
        super().__init__(cfg, steps_per_epoch, with_msssim, param_transform)
        self.eager = build_train_step_fn(cfg, steps_per_epoch, with_msssim, param_transform)
        self.lr_at = partial(lr_at_step, **self.schedule)
        self.frames: Optional[torch.Tensor] = None  # [B, H, W, 3] f32: the step's frames

    def _frames(self, store, buf: _StepBuffers, rows: torch.Tensor) -> torch.Tensor:
        return self.frames

    def _held(self, store) -> list:
        return [self.frames]

    def step(self, state: TrainState, store, buf: _StepBuffers, masks: Masks) -> None:
        super().step(state, store, buf, masks)
        buf.k.zero_()  # every call is row 0

    def _step_buffers(self, frames: torch.Tensor) -> _StepBuffers:
        if self.frames is None or self.frames.shape != frames.shape \
                or self.frames.device != frames.device:
            b = frames.shape[0]
            buf = self._new_buffers(frames.device, 1, b, b)
            buf.perm.copy_(torch.arange(b, device=frames.device).reshape(1, b))
            self.frames = torch.empty_like(frames)
        return self.buffers

    def __call__(self, state: TrainState, frames: torch.Tensor, t: torch.Tensor,
                 masks: Masks = None):
        if next(state.model.parameters()).device.type != "cuda":
            return self.eager(state, frames, t, masks)
        lr = float(self.lr_at(state.step))
        buf = self._step_buffers(frames)
        self.frames.copy_(frames)
        buf.t_all.copy_(t)
        buf.lr.fill_(lr)
        self._steps(state, None, buf, masks, 1)
        with torch.no_grad():  # copies: the next call writes the same buffers
            aux = {"loss": buf.loss[0].clone(), "psnr": buf.psnr[0].clone()}
            if buf.msssim is not None:
                aux["msssim"] = buf.msssim[0].clone()
        aux["lr"] = lr
        state.step += 1
        return state, aux


def make_train_step(
    cfg: TrainConfig,
    steps_per_epoch: int,
    with_msssim: bool = True,
    param_transform=None,
) -> StepGraph:
    """The single-device train step (the JAX package's jitted step), which
    ``run_epoch`` drives: a ``StepGraph``, one CUDA graph replay a call on
    the card, ``build_train_step_fn``'s eager step on the CPU; arguments as
    ``build_train_step_fn``'s."""
    return StepGraph(cfg, steps_per_epoch, with_msssim, param_transform)


class StreamingEpoch(FusedEpoch):
    """The epoch function of ``make_streaming_epoch_fn``: ``FusedEpoch``'s
    step over a video on the host or on disk.
    ``epoch_fn(state, store, perm, masks, chunk)`` runs the ``n_steps``
    steps in chunks of ``chunk`` steps (the last may be short); the step
    reads its frames from a ring of device buffers [R, B, H, W, 3] uint8,
    R = min(2 * chunk, rows), slot ``k mod R``, which the chunks fill in
    turn.  The graph holds the ring's address, never the store's.

    On the card chunk ``c + 1`` is copied on a side stream while the graph
    replays the steps of chunk ``c``.  Two events per half of the ring order
    copy -> replay (``ready``) and replay -> the next copy into the same
    slots (``freed``).  A host array in pinned memory (``make_frame_store``
    pins it) is copied frame by frame straight from its pages, so the host
    never waits; any other source (a ``DirFrames``, an array that is not
    pinned) is first read on the host into one of two pinned staging
    buffers, and before it refills one the host waits for the copy out of
    it, one wait a chunk at most.  On the CPU the chunks are read into the
    ring and the steps run eagerly."""

    streaming = True

    def __init__(self, *args):
        super().__init__(*args)
        self.ring: Optional[torch.Tensor] = None  # [R, B, H, W, 3] uint8
        self.staging: list = []  # two pinned [chunk, B, H, W, 3] uint8
        self.copy_stream = None
        self.ready: list = []  # per half: the copy into it is done
        self.freed: list = []  # per half: the replays reading it are done
        self.chunk_copies = 0  # chunks copied into the ring since construction

    def _check_store(self, store: FrameStore) -> None:
        if store.resident:
            raise ValueError("make_streaming_epoch_fn streams a host or disk video; a "
                             "device-resident one takes make_epoch_fn")

    def _ring(self, store: FrameStore, b: int, chunk: int) -> torch.Tensor:
        h, w = store.hw
        shape = (min(2 * chunk, store.num_samples // b), b, h, w, 3)
        if self.ring is None or tuple(self.ring.shape) != shape or self.ring.device != store.device:
            if self.copy_stream is not None:
                self.copy_stream.synchronize()  # no copy into the old ring is pending
            self.captured.drop()  # it reads the old ring
            self.ring = torch.zeros(shape, dtype=torch.uint8, device=store.device)
            self.staging = []
            if store.device.type == "cuda":
                self.copy_stream = torch.cuda.Stream(store.device)
                self.ready = [torch.cuda.Event() for _ in range(2)]
                self.freed = [torch.cuda.Event() for _ in range(2)]
        return self.ring

    def _frames(self, store: FrameStore, buf: _StepBuffers, rows: torch.Tensor) -> torch.Tensor:
        """The step's frames: ring slot ``k mod R``, then /255 as ``gather``."""
        slot = buf.k % self.ring.shape[0]
        return self.ring.index_select(0, slot)[0].float() / 255.0

    def _held(self, store: FrameStore) -> list:
        return [self.ring]

    def _fill(self, store: FrameStore, perm: np.ndarray, k0: int, k1: int, half: int) -> None:
        """Copy the frames of steps [k0, k1) into ring slots k0 % R on (no
        wrap: a chunk starts at 0 or ``chunk`` of a ring of 2 chunks)."""
        ring = self.ring
        rows = np.asarray(perm[k0:k1]).reshape(-1)
        s0 = k0 % ring.shape[0]
        dst = ring[s0 : s0 + k1 - k0].view(-1, *ring.shape[2:])
        self.chunk_copies += 1
        if store.device.type != "cuda":
            read_frames(store.frames, rows, dst.numpy())
            return
        src = None
        if isinstance(store.frames, np.ndarray):
            src = torch.from_numpy(store.frames)
            if not src.is_pinned():
                src = None
        if src is None:
            if not self.staging or self.staging[0].shape[0] < k1 - k0:
                self.staging = [torch.empty((k1 - k0, *ring.shape[1:]), dtype=torch.uint8,
                                            pin_memory=True) for _ in range(2)]
            stage = self.staging[half][: k1 - k0].view(-1, *ring.shape[2:])
            self.ready[half].synchronize()  # the copy out of this buffer is done
            read_frames(store.frames, rows, stage.numpy())
        side = self.copy_stream
        with torch.cuda.stream(side):
            side.wait_event(self.freed[half])
            if src is None:
                dst.copy_(stage, non_blocking=True)
            else:
                for j, r in enumerate(rows):
                    dst[j].copy_(src[int(r)], non_blocking=True)
            side.record_event(self.ready[half])

    def __call__(self, state: TrainState, store: FrameStore, perm: np.ndarray, masks: Masks,
                 chunk: int):
        buf, lrs = self._start(state, store, perm)
        n_steps, b = perm.shape
        self._ring(store, b, chunk)
        main = torch.cuda.current_stream(store.device) if store.device.type == "cuda" else None
        if n_steps:
            self._fill(store, perm, 0, min(chunk, n_steps), 0)
        for c, k0 in enumerate(range(0, n_steps, chunk)):
            k1 = min(k0 + chunk, n_steps)
            if main is not None:
                main.wait_event(self.ready[c % 2])
            self._steps(state, store, buf, masks, k1 - k0)
            if main is not None:
                main.record_event(self.freed[c % 2])
            if k1 < n_steps:
                self._fill(store, perm, k1, min(k1 + chunk, n_steps), (c + 1) % 2)
        return self._finish(state, buf, n_steps, lrs)


def make_streaming_epoch_fn(
    cfg: TrainConfig,
    steps_per_epoch: int,
    with_msssim: bool = False,
    param_transform=None,
) -> StreamingEpoch:
    """The whole-epoch train function for a video on the host or on disk
    (out-of-core): a ``StreamingEpoch``, tagged ``streaming``, which
    ``run_fused_epoch`` drives in chunks of ``DataConfig.stream_chunk_mb``, so
    the device holds two chunks of pixels, never the video.  Arguments as
    ``make_epoch_fn``'s; ``steps_per_epoch`` sizes the schedule of the whole
    epoch, not of a chunk."""
    return StreamingEpoch(cfg, steps_per_epoch, with_msssim, param_transform)


def stream_chunk_steps(store: FrameStore, cfg: TrainConfig) -> int:
    """Steps a chunk of the streaming epoch: as many batches of uint8 pixels
    as ``stream_chunk_mb`` holds, at least one."""
    h, w = store.hw
    per_step = cfg.data.batch_size * h * w * 3
    return max(1, (cfg.data.stream_chunk_mb << 20) // max(per_step, 1))


def run_fused_epoch(
    state: TrainState,
    epoch_fn,
    store: FrameStore,
    cfg: TrainConfig,
    epoch: int,
    masks: Masks = None,
    max_steps: Optional[int] = None,
) -> Tuple[TrainState, EpochMetrics]:
    """Drive ``make_epoch_fn`` or, tagged ``streaming``,
    ``make_streaming_epoch_fn`` (in chunks of ``stream_chunk_steps``): the
    epoch's shuffled batch matrix on the host (the order of ``run_epoch``),
    one ``epoch_fn`` call, the stacked metrics reduced with one fetch; the
    learning rate of the epoch's last step."""
    perm = epoch_rows(store, cfg, epoch, max_steps)
    if getattr(epoch_fn, "streaming", False):
        state, aux = epoch_fn(state, store, perm, masks, stream_chunk_steps(store, cfg))
    else:
        state, aux = epoch_fn(state, store, perm, masks)
    with span("train.epoch_end"):
        metrics = _epoch_metrics(aux["loss"], aux["psnr"], aux.get("msssim"),
                                 float(aux["lr"][-1]))
    return state, metrics


def _make_eval_batch(cfg: TrainConfig, with_msssim: bool):
    """batch(model, frames, t) -> (outputs, aux with [B, n_stage] metrics):
    the eval step's body, in the model's current mode."""
    mcfg = cfg.model

    def batch(model: nn.Module, frames: torch.Tensor, t: torch.Tensor):
        outs = model(positional_encoding(t, mcfg.embed))
        targets = [adaptive_avg_pool(frames, o.shape[1:3]) for o in outs]
        aux = {"psnr": psnr_fn(outs, targets)}
        if with_msssim:
            aux["msssim"] = msssim_fn(outs, targets)
        return outs, aux

    return batch


def build_eval_step_fn(cfg: TrainConfig, with_msssim: bool = True):
    """The eager eval step: eval(model, frames [B, H, W, 3] f32, t [B]) ->
    (outputs, aux with "psnr" (and "msssim") [B, n_stage]), in eval mode and
    without autograd; the model's mode is put back.  The oracle of
    ``make_eval_step``'s graph, and what it runs on a CPU model."""
    batch = _make_eval_batch(cfg, with_msssim)

    @torch.no_grad()
    def eval_fn(model: nn.Module, frames: torch.Tensor, t: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            return batch(model, frames, t)
        finally:
            model.train(was_training)

    return eval_fn


def _int8_tensors(model: Generator) -> list:
    """Every tensor of the module's int8 decode tables, the packed stages'
    included, in table order."""
    out = []
    for name in sorted(model.int8):
        entry = model.int8[name]
        for v in entry:
            if dataclasses.is_dataclass(v):
                out.extend(getattr(v, f.name) for f in dataclasses.fields(v))
            else:
                out.append(v)
    return [t for t in out if torch.is_tensor(t)]


def weights_key(model: Generator) -> tuple:
    """What a captured forward of ``model`` holds: the module, its mode and
    config, and each parameter's, buffer's and int8 table's address and
    version (a change in place moves the version, and with it the packed
    kernel weights the capture read).  The module by a weak reference, which
    equals another only while both name the same live module: a new module
    may take a freed one's id, and even its tensors' addresses."""
    tensors = [*model.parameters(), *model.buffers(), *_int8_tensors(model)]
    return (weakref.ref(model), model.training, model.cfg, tuple(sorted(model.int8)),
            tuple((t.data_ptr(), t._version) for t in tensors))


def eval_graph_key(model: Generator, frames_shape, with_msssim: bool) -> tuple:
    """What a captured eval batch holds: ``weights_key``, the batch size, the
    frame shape and whether it computes MS-SSIM."""
    b, *hw = frames_shape
    return (weights_key(model), b, tuple(hw), with_msssim)


class EvalStep:
    """The eval step of ``make_eval_step``, the JAX package's jitted
    ``eval_fn``: ``eval_step(model, frames [B, H, W, 3] f32, t [B]) ->
    (outputs, aux)``, the model's outputs in eval mode without autograd and
    aux "psnr" [B, n_stage] (and "msssim" [B, n_stage]), tensors that a
    later call does not overwrite; the model's mode is put back.

    On a CUDA model the frames and ``t`` are copied into fixed device
    buffers, and the batch (the positional encoding, the eval-mode forward,
    the targets and the metrics) runs on them.  The first batch after a
    change of ``eval_graph_key`` (taken in eval mode: another model, a
    weight changed in place, the batch or frame shape, MS-SSIM on or off)
    runs eagerly on a side stream, then the batch is captured as a CUDA
    graph, and every later batch is one replay, its outputs copied out of
    the graph's pool.  A batch smaller than the captured one on the same
    weights, a sweep's short last batch, runs eagerly and is never
    captured.  A capture or a replay that fails raises: nothing falls back
    to eager.  On a CPU model ``build_eval_step_fn``'s eager step runs."""

    def __init__(self, cfg: TrainConfig, with_msssim: bool):
        self.with_msssim = with_msssim
        self.eager = build_eval_step_fn(cfg, with_msssim)
        self.batch = _make_eval_batch(cfg, with_msssim)
        self.frames: Optional[torch.Tensor] = None  # [B, H, W, 3] f32: the batch's frames
        self.t: Optional[torch.Tensor] = None  # [B] f32: its frame times
        # (graph of one batch, its (outputs, aux) in the graph's pool), on eval_graph_key
        self.captured = CapturedGraph()
        self.pool_bytes = 0  # device memory the last capture reserved for the graph's pool

    def release(self) -> None:
        """Let the graph, its pool and the buffers go.  A caller that changes
        the weights or runs other device work before its next sweep calls it
        after a sweep: the key could not match again, and the pool would be
        held through that work."""
        self.captured.drop()
        self.frames = self.t = None

    @torch.no_grad()
    def __call__(self, model: nn.Module, frames: torch.Tensor, t: torch.Tensor):
        if next(model.parameters()).device.type != "cuda":
            return self.eager(model, frames, t)
        was_training = model.training
        model.eval()  # the capture records the eval-mode forward, the key that mode
        try:
            return self._run(model, frames, t)
        finally:
            model.train(was_training)

    def _run(self, model: Generator, frames: torch.Tensor, t: torch.Tensor):
        key = eval_graph_key(model, frames.shape, self.with_msssim)
        held = self.captured.key
        if held is not None and key[0] == held[0] and key[2:] == held[2:] and key[1] < held[1]:
            return self.batch(model, frames, t)  # the short last batch
        if not self.captured.holds(lambda: key):
            return self._capture(model, frames, t, key)
        self.frames.copy_(frames)
        self.t.copy_(t)
        graph, (outs, aux) = self.captured.graph
        self.captured.replay(graph.replay)
        return [o.clone() for o in outs], {k: v.clone() for k, v in aux.items()}

    def _capture(self, model: Generator, frames: torch.Tensor, t: torch.Tensor, key: tuple):
        """The batch eagerly on a side stream, then its capture; returns the
        eager batch's outputs."""
        self.captured.drop()  # let the old graph's memory go before new buffers
        dev = frames.device
        if self.frames is None or self.frames.shape != frames.shape or self.frames.device != dev:
            self.frames, self.t = torch.empty_like(frames), torch.empty_like(t)
        self.frames.copy_(frames)
        self.t.copy_(t)
        first = []

        def capture(side):
            graph = torch.cuda.CUDAGraph()
            with capture_graph(graph, side, capture_error_mode="thread_local"):
                # inside: entering the capture empties the allocator's cache
                reserved = torch.cuda.memory_reserved(dev)
                out = self.batch(model, self.frames, self.t)
                self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            return graph, out

        self.captured.capture(dev, lambda: key,
                              lambda: first.append(self.batch(model, self.frames, self.t)),
                              capture, "eval")
        outs, aux = first[0]
        main = torch.cuda.current_stream(dev)
        for x in (*outs, *aux.values()):
            x.record_stream(main)  # made on the side stream, read on this one
        return outs, aux


def make_eval_step(cfg: TrainConfig, with_msssim: bool = True) -> EvalStep:
    """eval(model, frames, t) -> (outputs, aux with [B, n_stage] metrics), in
    eval mode and without autograd: an ``EvalStep``, one CUDA graph replay a
    batch on the card; the graph lives until its ``release`` or as long as
    the returned function."""
    return EvalStep(cfg, with_msssim)


def evaluate(
    model: nn.Module,
    eval_step,
    store: FrameStore,
    cfg: TrainConfig,
    max_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Validation sweep in frame order -> (psnr [n_stage], msssim [n_stage]).
    The frame rows and the ``t`` column go to the device once, before the
    sweep (a host tensor copied per batch would make the stream wait); a host
    or disk video sends its pixels one batch at a time from pinned memory."""
    dev = store.device
    b = cfg.data.batch_size
    idx = store.sample_indices()
    if max_steps is not None:
        idx = idx[: max_steps * b]
    rows_all = torch.from_numpy(idx).to(dev)
    t_all = torch.from_numpy(np.asarray(store.t, np.float32)).to(dev)
    psnrs, msssims = [], []
    for i in range(0, len(idx), b):  # the last batch may be short
        rows = rows_all[i : i + b]
        frames = store.gather(rows if store.resident else idx[i : i + b])
        _, aux = eval_step(model, frames, t_all[rows])
        psnrs.append(aux["psnr"])
        if "msssim" in aux:
            msssims.append(aux["msssim"])
    psnr = torch.cat(psnrs, 0).mean(dim=0).cpu().numpy()
    msssim = torch.cat(msssims, 0).mean(dim=0).cpu().numpy() if msssims else np.zeros_like(psnr)
    return psnr, msssim


@torch.no_grad()
def decode_batch(model: nn.Module, cfg: TrainConfig, t: torch.Tensor) -> torch.Tensor:
    """The final frame batch [B, H, W, 3] f32 of ``t`` [B], eagerly: the
    positional encoding and the generator's forward."""
    return model(positional_encoding(t, cfg.model.embed))[-1]


def decode_video(
    model: nn.Module, cfg: TrainConfig, t_batches: torch.Tensor, *, keep_frames: bool = True
) -> torch.Tensor:
    """Decode every row of ``t_batches`` [n_batches, B] eagerly, one
    ``decode_batch`` a row: the oracle of ``make_video_decode_fn``, and what
    it runs on the CPU.  Returns frames [n_batches, B, H, W, 3] (f32) when
    ``keep_frames``, else a checksum per batch [n_batches] (decode-and-discard,
    the throughput measurement)."""
    outs = []
    for t in t_batches:
        frames = decode_batch(model, cfg, t)
        outs.append(frames if keep_frames else frames.sum())
    return torch.stack(outs)


def decode_graph_key(model: Generator, batch: int, keep_frames: bool) -> tuple:
    """What a captured decode of ``batch`` frames holds: ``weights_key``, the
    batch size and whether it keeps the frames."""
    return (weights_key(model), batch, keep_frames)


class VideoDecode:
    """The decode function of ``make_video_decode_fn``:
    ``run(model, t_batches [n_batches, B]) -> frames [n_batches, B, H, W, 3]
    f32`` (``keep_frames``) or a checksum per batch [n_batches] f32, new
    tensors at every call, as the JAX package's one ``lax.scan`` dispatch
    returns new arrays.

    On the card a batch's decode runs on fixed device buffers: it reads row
    ``k`` of a [rows, B] buffer of frame times, decodes it (``decode_batch``:
    the stem, block 0 and the casts on the library, blocks 1-4 through K1 or
    K2), writes the batch's checksum at ``k`` (or leaves its frames in the
    graph's pool, copied out after the replay) and advances ``k``.  The first
    batch after a change of what the graph holds (``decode_graph_key``: the
    first call, another model, a weight or int8 table changed in place, the
    batch size; or more batches than the buffers hold) runs eagerly on a
    side stream; then the batch is captured as a CUDA graph, and every later
    batch is one replay.  A capture or a replay that fails raises: nothing
    falls back to eager.  The graph's pool holds one batch's activations.
    On the CPU ``decode_video`` runs."""

    def __init__(self, cfg: TrainConfig, keep_frames: bool):
        self.cfg = cfg
        self.keep_frames = keep_frames
        self.t: Optional[torch.Tensor] = None  # [rows, B] f32: the batches' frame times
        self.k: Optional[torch.Tensor] = None  # [1] int64: the batch, advanced by the decode
        self.sums: Optional[torch.Tensor] = None  # [rows] f32: the checksums
        # (graph of one batch, its frames in the graph's pool), on decode_graph_key
        self.captured = CapturedGraph()

    def _buffers(self, device: torch.device, n: int, b: int) -> None:
        t = self.t
        if t is None or t.shape[0] < n or t.shape[1] != b or t.device != device:
            self.captured.drop()  # it reads the old buffers
            self.t = torch.zeros(max(n, 1), b, device=device)
            self.k = torch.zeros(1, dtype=torch.long, device=device)
            self.sums = torch.zeros(max(n, 1), device=device)

    @torch.no_grad()
    def step(self, model: Generator) -> torch.Tensor:
        """Decode the batch ``t[k]``, its checksum into ``sums[k]`` unless
        ``keep_frames``; then ``k += 1``.  Returns the frames."""
        k = self.k
        frames = decode_batch(model, self.cfg, self.t.index_select(0, k).reshape(-1))
        if not self.keep_frames:
            self.sums.index_copy_(0, k, frames.sum().reshape(1))
        k.add_(1)
        return frames

    def _capture(self, model: Generator, key: tuple, frames: Optional[torch.Tensor]) -> None:
        """The first batch eagerly (into ``frames[0]``), then the capture."""

        def eager():
            out = self.step(model)
            if frames is not None:
                frames[0].copy_(out)

        def capture(side):
            graph = torch.cuda.CUDAGraph()
            # thread-local: a process group's own threads (NCCL's watchdog
            # queries its events) may call CUDA while this thread captures
            with capture_graph(graph, side, capture_error_mode="thread_local"):
                out = self.step(model)
            return graph, out

        self.captured.capture(self.t.device, lambda: key, eager, capture, "decode")

    def _prepare(self, model: Generator, t_batches, device: torch.device):
        """The buffers with the batches' times and ``k = 0``; returns (n,
        the frames' tensor or None, the graph key)."""
        t_batches = torch.as_tensor(t_batches, dtype=torch.float32)
        n, b = t_batches.shape
        self._buffers(device, n, b)
        self.t[:n].copy_(t_batches)
        self.k.zero_()
        frames = None
        if self.keep_frames:
            frames = torch.empty((n, b, *output_hw(model.cfg), 3), device=device)
        with span("decode.key"):
            key = decode_graph_key(model, b, self.keep_frames)
        return n, frames, key

    def __call__(self, model: Generator, t_batches) -> torch.Tensor:
        with span("decode.prepare"):
            device = next(model.parameters()).device
            if device.type == "cuda":
                n, frames, key = self._prepare(model, t_batches, device)
        if device.type != "cuda":
            return decode_video(model, self.cfg, t_batches, keep_frames=self.keep_frames)
        first = 0
        if n and not self.captured.holds(lambda: key):
            self._capture(model, key, frames)  # the first batch runs in here
            first = 1
        for i in range(first, n):
            graph, out = self.captured.graph
            self.captured.replay(graph.replay)
            if frames is not None:
                with span("decode.copy_out"):
                    frames[i].copy_(out)
        if frames is not None:
            return frames
        with span("decode.copy_out"):
            return self.sums[:n].clone()


def make_video_decode_fn(cfg: TrainConfig, *, keep_frames: bool = True) -> VideoDecode:
    """Whole-video decode, the JAX package's one-dispatch ``lax.scan``:
    ``run(model, t_batches [n_batches, B])`` -> frames [n_batches, B, H, W,
    3] f32 when ``keep_frames``, else a checksum per batch [n_batches].  On
    the card one CUDA graph replay a batch (``VideoDecode``); the graph lives
    as long as the returned function."""
    return VideoDecode(cfg, keep_frames)


def make_decode_fn(cfg: TrainConfig) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """decode(model, t [B]) -> the final frame batch [B, H, W, 3] f32: the
    one-batch case of ``make_video_decode_fn``, one replay a call on the card."""
    run = make_video_decode_fn(cfg, keep_frames=True)

    def decode(model: nn.Module, t: torch.Tensor) -> torch.Tensor:
        return run(model, t.reshape(1, -1))[0]

    return decode


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


def time_decode(decode_all, model: nn.Module, t_mat: torch.Tensor, reps: int = DECODE_REPS):
    """``decode_all(model, t_mat)`` (checksums [n_batches]) once as a warm-up,
    then ``reps`` times, each between two CUDA events.  Returns (seconds of
    each rep, the reps' checksums [reps, n_batches])."""
    decode_all(model, t_mat)  # warm-up: build, allocator, the capture
    times, sums = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sums.append(decode_all(model, t_mat))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times, torch.stack(sums)


def measure_decode_fps(
    model: nn.Module, cfg: TrainConfig, t_all, bsz: int, reps: int = DECODE_REPS, mesh=None
) -> float:
    """Whole-video decode throughput on the card: ``make_video_decode_fn``'s
    checksums, one warm-up decode (the eager first batch and the capture),
    then ``reps`` timed decodes of the same frames, one replay a batch, each
    decode between two CUDA events (``time_decode``); frames per second of
    the fastest.  Decodes ``(1 + reps) * n_batches`` batches in all.  The
    graph is made for this call and dies with it: a model that trains
    between two measurements (``train_main --eval_fps``) gets a new one.
    With ``mesh`` each rank decodes its columns of every batch
    (``parallel.sharding.make_sharded_video_decode_fn``); ``bsz`` is the
    global batch and must divide by the data axis.  The timed window holds
    no collective: each rep's checksums stay on the rank, and after the loop
    ``reduce_decode_reps`` sums them and takes each rep's time as the
    slowest rank's."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"decode fps is measured on a CUDA device, not {device}")
    if mesh is None:
        decode_all = make_video_decode_fn(cfg, keep_frames=False)
    else:
        from ..parallel.sharding import make_sharded_video_decode_fn, reduce_decode_reps

        decode_all = make_sharded_video_decode_fn(cfg, mesh, local=True)
    t_np = decode_time_batches(t_all, bsz)
    n_batches, bsz = t_np.shape
    times, sums = time_decode(decode_all, model, torch.from_numpy(t_np).to(device), reps)
    if mesh is not None:
        times, _ = reduce_decode_reps(times, sums, mesh)
    return n_batches * bsz / min(times)
