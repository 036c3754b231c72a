"""Multi-video suite fitting (port of ``repnerv_tpu/parallel/suite.py``).

The reference fits the 7 UVG videos with one ``main_train.py`` run each
(reference README.md:63-111).  No state is shared between the fits, so the
suite CLI (``cli/suite_main.py``) has two modes:

* **sequential**: one fit after the other through the fused epoch;
* **parallel**: the ranks of a ``("video",)`` mesh (one without torchrun)
  each hold their share of the videos (``video_sharding``), and each video
  has its own ``FusedEpoch``: its own captured step, buffers and optimizer.
  An epoch enqueues every local video's epoch on its own CUDA stream before
  the first host wait, so the fits run side by side on the card: the
  counterpart of the JAX package's one vmapped dispatch for the suite.

Every video runs the longest video's step count an epoch, and a shorter
video cycles through its own frames (``suite_perms``, the JAX package's
draw byte for byte).  The kernels stay on: the JAX package turns its Pallas
kernels off here for a batching rule of the TPU's compiler (ROADMAP A9).

Per-video seeds: video ``v`` of a suite of ``n`` starts from the weights of
seed ``manual_seed + v`` (``suite_seeds``), the seed its synthetic content
and its shuffles use too; a refit attempt ``a >= 1`` of video ``v`` from
seed ``manual_seed + a * n + v`` (``refit_seed``), which no first draw of
the suite uses.  Both modes draw the same seeds, so their fits are equal.

Like the JAX package's, the parallel mode has no in-run ``DivergenceGuard``
(the sequential fit has one); the suite's flag-and-refit pass after the fit
(``cli/suite_main.py``) covers both modes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.frames import FrameStore
from ..train.loop import TrainState, init_train_state, make_epoch_fn
from .sharding import Mesh

Params = Dict[str, np.ndarray]


def suite_seeds(manual_seed: int, n_videos: int) -> List[int]:
    """The init seed of each video's first fit: ``manual_seed + v``."""
    return [manual_seed + v for v in range(n_videos)]


def refit_seed(manual_seed: int, n_videos: int, v: int, attempt: int) -> int:
    """The init seed of refit ``attempt`` (>= 1) of video ``v``:
    ``manual_seed + attempt * n_videos + v``, above every first draw."""
    if attempt < 1:
        raise ValueError(f"refit attempts count from 1, got {attempt}")
    return manual_seed + attempt * n_videos + v


def init_suite_states(cfg: TrainConfig, n_videos: int, device,
                      videos: Optional[Sequence[int]] = None) -> List[TrainState]:
    """One train state per video (``videos``: the suite indices to make,
    default all), each from its ``suite_seeds`` seed: equal to the
    sequential fits' first states."""
    seeds = suite_seeds(cfg.manual_seed, n_videos)
    videos = range(n_videos) if videos is None else videos
    return [init_train_state(cfg, device, seed=seeds[v]) for v in videos]


def video_sharding(mesh: Optional[Mesh], n_videos: int, axis: str = "video") -> range:
    """The suite indices this rank holds: a contiguous share of the videos
    over the first ``min(ranks, n_videos)`` ranks of the mesh's ``axis`` (the
    rest hold none), all of them off-mesh."""
    if mesh is None or axis not in mesh.axis_names:
        return range(n_videos)
    used = min(mesh.axis_size(axis), n_videos)
    if mesh.rank >= used:
        return range(0)
    per = n_videos // used
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def shard_suite(items: Sequence, mesh: Optional[Mesh], axis: str = "video") -> list:
    """This rank's entries of a per-video sequence (all of them off-mesh)."""
    return [items[v] for v in video_sharding(mesh, len(items), axis)]


def suite_perms(cfg: TrainConfig, n_videos: int, n_frames, steps_per_epoch: int,
                epoch: int) -> np.ndarray:
    """Per-video shuffled batch matrices [V, steps, B], the JAX package's
    byte for byte: video ``v`` draws ``default_rng((manual_seed + v) * 100003
    + epoch)`` permutations of its gap-strided samples (the sequential fit's
    ``epoch_rows`` with the seed ``manual_seed + v``).  ``n_frames`` is one
    int or one per video; a video shorter than ``steps * B`` samples cycles
    through more permutations of its own frames, and the first equals the
    equal-length draw."""
    b = cfg.data.batch_size
    gap = cfg.data.frame_gap
    if np.isscalar(n_frames):
        n_frames = [int(n_frames)] * n_videos
    need = steps_per_epoch * b
    out = np.empty((n_videos, need), np.int32)
    for v in range(n_videos):
        rng = np.random.default_rng((cfg.manual_seed + v) * 100003 + epoch)
        n_samples = n_frames[v] // gap
        if n_samples <= 0:
            raise ValueError(
                f"suite video {v} has {n_frames[v]} frames < frame_gap "
                f"{gap}: no trainable samples (the cycling draw below "
                "would never terminate)"
            )
        chunks = []
        got = 0
        while got < need:
            idx = rng.permutation(n_samples) * gap
            chunks.append(idx)
            got += len(idx)
        out[v] = np.concatenate(chunks)[:need]
    return out.reshape(n_videos, steps_per_epoch, b)


class SuiteEpoch:
    """The parallel suite's epoch function (``make_suite_epoch_fn``):
    ``epoch_fn(states, stores, perms) -> (states, auxes)`` runs one epoch of
    every local video, video ``i`` from ``stores[i]`` over ``perms[i]``
    [steps, B], through its own ``FusedEpoch``.  On the card each video's
    epoch goes on its own stream, all of them before any host wait, and the
    current stream waits for them all; ``auxes[i]`` is that video's
    ``FusedEpoch`` aux."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, n_videos: int,
                 with_msssim: bool):
        self.epoch_fns = [make_epoch_fn(cfg, steps_per_epoch, with_msssim=with_msssim)
                          for _ in range(n_videos)]
        self.streams: list = []

    def __call__(self, states: List[TrainState], stores: List[FrameStore], perms):
        if len(states) != len(self.epoch_fns) or len(stores) != len(states):
            raise ValueError(f"{len(states)} states and {len(stores)} stores for a suite epoch "
                             f"of {len(self.epoch_fns)} videos")
        dev = stores[0].device
        if dev.type != "cuda":
            auxes = []
            for i, fn in enumerate(self.epoch_fns):
                states[i], aux = fn(states[i], stores[i], perms[i], None)
                auxes.append(aux)
            return states, auxes
        if not self.streams:
            self.streams = [torch.cuda.Stream(dev) for _ in self.epoch_fns]
        main = torch.cuda.current_stream(dev)
        auxes = []
        for i, (fn, stream) in enumerate(zip(self.epoch_fns, self.streams)):
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                states[i], aux = fn(states[i], stores[i], perms[i], None)
            auxes.append(aux)
        for stream in self.streams:
            main.wait_stream(stream)
        return states, auxes


def make_suite_epoch_fn(cfg: TrainConfig, steps_per_epoch: int, n_videos: int, *,
                        with_msssim: bool = False) -> SuiteEpoch:
    """The epoch function of ``n_videos`` local videos, each ``steps_per_epoch``
    steps of the learning-rate schedule an epoch."""
    return SuiteEpoch(cfg, steps_per_epoch, n_videos, with_msssim)


def run_suite_epoch(states: List[TrainState], epoch_fn: SuiteEpoch, stores: List[FrameStore],
                    cfg: TrainConfig, epoch: int, steps_per_epoch: int,
                    mesh: Optional[Mesh] = None, n_frames=None,
                    ) -> Tuple[List[TrainState], Dict[str, np.ndarray]]:
    """One parallel epoch of this rank's videos (``stores`` are this rank's;
    ``n_frames`` every video's frame count, default this rank's stores');
    returns the per-video metrics: "psnr" [V, n_stage] and "loss" [V] means
    over the steps, "lr" [V] of the last step (and "msssim")."""
    if n_frames is None:
        if mesh is not None:
            raise ValueError("run_suite_epoch over a mesh needs every video's n_frames")
        n_frames = [s.frames.shape[0] for s in stores]
    local = video_sharding(mesh, len(n_frames))
    perms = suite_perms(cfg, len(n_frames), n_frames, steps_per_epoch, epoch)
    states, auxes = epoch_fn(states, stores, [perms[v] for v in local])
    # the fetches wait for every video's epoch, after all were enqueued
    metrics = {
        "psnr": np.stack([a["psnr"].mean(dim=0).cpu().numpy() for a in auxes]),
        "loss": np.asarray([a["loss"].mean().item() for a in auxes]),
        "lr": np.asarray([float(a["lr"][-1]) for a in auxes]),
    }
    if "msssim" in auxes[0]:
        metrics["msssim"] = np.stack([a["msssim"].mean(dim=0).cpu().numpy() for a in auxes])
    return states, metrics


def extract_video_params(states: List[TrainState], v: int) -> Params:
    """One video's parameters as a host numpy state dict."""
    return {k: t.detach().cpu().numpy() for k, t in states[v].model.state_dict().items()}
