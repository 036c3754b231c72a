#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repnerv_tpu_torch``) on one
NVIDIA GPU: build the hand-written kernels, hold each against its plain
PyTorch version at the flagship shapes, serve a flagship-width ``.rnvb``
artifact through ``repnerv_tpu_torch.cli.decode_main``, and train the
flagship through ``repnerv_tpu_torch.cli.train_main``, compress that
training run through ``repnerv_tpu_torch.cli.eval_main`` and serve its
``.rnvb`` in int8, fit a suite of videos through
``repnerv_tpu_torch.cli.suite_main``, train and decode over
``torch.distributed`` and train over a tensor-parallel model axis, checking
that every main path went through the kernels and matches its plain path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — a CUDA device is required; its name and power limit
  2. build   — nvcc builds csrc/*.cu from the checkout, one process per source;
               the library's SASS is searched, per wgmma kernel source, for
               HGMMA (bf16, tf32) / IGMMA (int8) and UTMALDG (TMA) instructions
  3. kernel  — K1 (decode stage) vs plain version, f32 and bf16, at the shapes
               the serve phase gives it (Bunny-720p ERB flagship, batch 8); per
               shape the route it took (wgmma_tf32x3 / fma in f32, wgmma / wmma
               in bf16), its bound (the least time the card could take,
               ``roofline``), the time of one F.conv2d on the same shape (the
               library yardstick, used nowhere in the port) and, on a wgmma
               route, the time (f32: and the error) of the kernel the shape
               ran before, the FMA or the WMMA kernel, in the same run
  4. serve   — flagship ERB generator from seed 0 -> 8-bit .rnvb -> decode_main
               (32 frames, batch 8; one CUDA graph replay a batch) in f32 and
               bf16; launch count, frames vs the plain path, fps of both
               paths; ``[serve-graph]`` lines: the graph decode vs the eager
               one (decode_video): frames to the bit, K1 launches a replayed
               batch by route, a recapture after a weight changed in place,
               then in turns (eager, graph, graph, eager) fps, the decode
               window's idle share (torch.profiler) and batch-1 latency
  5. train-kernels — K3 (training stage forward) and K4 (its epilogue
               backward, with the bias and head gradients it sums itself:
               values, and equal bits from two launches) at the four fused
               block shapes of a -b 1 flagship step, f32 and bf16; K5 (SSIM
               blur) at the loss's and the MS-SSIM levels' shapes: the SSIM
               and cs means in one launch (stated bound, equal bits from two
               launches; the loss's moments kept, bitwise), their VJP for x
               and y (stated bound), and the single-map blur; each vs its
               plain version, with times
  6. train   — train_main on the flagship (16 synthetic 720p frames, -b 1,
               Fusion6, 2 epochs; the fused epoch: one CUDA graph replay per
               step) in bf16 (with --eval_fps: the FPS lines of its
               rank0.txt), f32 and mixed: launches per step, finite
               losses, PSNR rising, the .pth files; one step of the kernel
               path vs --no_pallas_train (loss, gradients); ms per step of
               both paths; where a step's time goes (torch.profiler); the
               graph step vs the eager step from the same weights (per-step
               losses, launches per replayed step), and ms per step, device
               total and idle share of both in turns (bf16, f32, mixed);
               ``[step-graph]`` lines: make_train_step's per-step graph
               (run_epoch, as --profile drives it) vs the eager step, the
               same checks and turns; ``[eval-graph]`` lines: make_eval_step's
               graph vs the eager eval step on a training model (bf16, f32)
               over the 16 frames at -b 1 with MS-SSIM: metrics to the bit,
               5 K5 a replayed frame, the graph's pool, ms a frame of the
               sweep in turns (eager, graph, graph, eager)
  7. int8-kernel — K2 (int8 decode stage) vs plain version at the flagship's
               int8 blocks 3 and 4 + head (batch 8, the wgmma s8 kernel; beside
               it the WMMA kernel's and the bf16 kernel's time on the same
               shape) and the stride-5 stage (the WMMA kernel)
  8. compress — eval_main on phase 6's bf16 run: PATH B (prune 0.2, 8 bits,
               .rnvb) without and with --decode_int8, PATH A (1 masked
               finetune epoch), QAT (1 epoch); then decode_main --decode_int8
               serves the .rnvb: 2 K1 + 2 K2 launches per batch (both K2 on
               the wgmma route), frames vs the plain path, fps of the int8,
               bf16 and plain paths; the int8 ``[serve-graph]`` lines (as
               phase 4's, the recapture after its packed scale changed);
               ``[eval-graph]`` lines (as phase 6's) on the served bf16
               deploy model (4 K1 + 5 K5 a frame) and the int8 one (2 K1 +
               2 K2 + 5 K5)
  9. out-of-core — the flagship trained from its 16 frames in pinned host
               memory (rung 2: --hbm_budget_mb 1, 16 MiB chunks of 6, 6 and
               4 steps copied on a side stream under the graph's replays) vs
               from the device (rung 1), bf16 and f32: per-step losses from
               the same weights, launches of an epoch of replays, chunk
               copies, ms per step in turns (rung 1, 2, 2, 1), device busy
               ms, idle share and the copies' overlap with kernels (the
               torch.profiler timeline), the H2D rate; from the frames as
               PNG files on disk (rung 3, a DirFrames: --host_budget_mb 1),
               losses vs rung 2, ms per step, and train_main from the
               directory; train_main on rung 2 (bf16, --eval_fps) and
               eval_main's PATH A finetune from a host store
 10. suite + multi-GPU — (a) suite_main --suite_mode sequential on phase 6's
               flags (bf16, 2 synthetic videos of 8 frames, 2 epochs, 8-bit
               .rnvb each): the table, each .rnvb against the evaluated
               weights (bitwise), 4 K3 + 4 K4 + 7 K5 a replayed step, one
               capture a video; (b) the same in parallel mode (a stream a
               video): per-step losses equal to (a)'s (cuDNN deterministic),
               fit seconds in turns (seq, par, par, seq), a steady epoch's
               ms and device busy share (profiler timeline); (c)
               train_main --mesh_shape 1 (an NCCL world of one) vs without,
               bf16 and f32: per-step losses to the bit, launches a replayed
               step, ms a graph step in turns, the all-reduce's device ms;
               (d) two gloo ranks on the one card (this script with
               --gloo-rank, f32, -b 1 each) vs one process at -b 2 over 8
               steps: losses, weights, the ranks' weights bitwise, ms a step;
               (e) decode_main --mesh_shape 1 on phase 8's .rnvb, bf16 and
               int8: frames to the bit, launches a batch, fps in turns
 11. tensor parallel — (e) K3 / K4 vs plain at one model rank's shard shapes
               (Cout 384 -> 192, c = 48, -b 1, f32 and bf16): values, times,
               bounds, F.conv2d at the shard's Cout (run after phase 5,
               where torch.profiler sees K4); gloo ranks on the one
               card (this script with --tp-rank) from the seed's weights:
               (a) a (1, 2) data x model mesh, -b 1, bf16 and f32, 8 steps,
               and (d) --norm bn over (2,) data ranks, f32, -b 2, 4 steps, in
               one world of 2; (b) a (2, 2) mesh, f32, -b 2, 4 steps, in a
               world of 4; each against one process at the global batch:
               per-step losses, first-step gradients (gathered), final
               weights (reported), launches a step by route, the bytes the
               collectives move, ms a step, device ms, idle share; (c)
               train_main over a (1, 1) data x model mesh (an NCCL world of
               one) vs without: per-step losses to the bit
 12. quality — the first 10 epochs of the paper recipe of ROADMAP C14
               (repnerv_tpu_torch/tools/quality.py: the ERB flagship on the
               132-frame synthetic 720p video, bf16, -b 1, seed 1, the
               cosine schedule of -e 300) through train_main --stop_epoch,
               on the kernel path and with --no_pallas_train: launches a
               step, train PSNR rising, the epoch-10 PSNR of the kernel path
               within a stated bound of the library path's and of the
               300-epoch run's; the 132-frame val sweep of the kernel path's
               model, eager vs graph eval step in turns: seconds a sweep,
               metrics to the bit (``python3 chip_smoke.py --quality`` runs
               phases 1, 2 and 12 alone)
 13. profile — train_main --profile on phase 6's flags (bf16, -e 2): the
               first epoch's 3 steps under utils/profiling.py's trace
               (torch.profiler, CPU and CUDA): make_train_step's eager first
               step, its capture and 2 replays; the rest of the run a replay a
               step; the trace file read back: K3 / K4 / K5 kernel events
               equal to the traced epoch's launches (4 / 4 / 7 a step), the
               top device ops, ms of the traced steps beside the untraced
               graph steps of epoch 2 and phase 6's graph steps
               (``python3 chip_smoke.py --profile`` runs phases 1, 2 and 13
               alone)
Phase 5b, fold: ERB's branch fusion (kernels/reparam_fuse.py, two launches
forward and two in the VJP) at every ERB block shape of erb-720p and
erb-uvg1080p against the plain fusion (``fuse_erb_plain``) and autograd in
f64, within twice the plain f32 path's error; its time and the plain
path's from the same inputs, and its bound; then ``train_main``'s own run
(bf16) counts its launches in the training steps and in the eval
(``python3 chip_smoke.py --fold`` runs phases 1, 2 and 5b alone).  The
plain side of every kernel-vs-plain step comparison folds with
``fuse_erb_plain`` (``plain_fold``).
Every kernel's row of the ``kernels`` line carries ``bound_ms`` / ``bound_by``
and ``library_ms`` (null where no single PyTorch call computes the kernel's
heavy part, with a ``library_note`` saying why; K5's is a depthwise
``F.conv2d`` on the five stacked maps of each stats launch).  Every
torch.profiler session goes through ``utils/profiling.py::trace`` (its
window primed and padded against ROADMAP C24); the ``[profiler-probe]``
summary counts the traces of ``profile_kernels`` that lost kernels.  The
last line is {"ok": true, "device": {...}}.  Needs no network; imports no
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from repnerv_tpu_torch.cli import decode_main, eval_main, train_main
from repnerv_tpu_torch.compress.bitstream import read_bitstream, write_bitstream
from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import DirFrames, FrameStore, make_frame_store, synthetic_video
from repnerv_tpu_torch.kernels import build
from repnerv_tpu_torch.kernels import decode as dk
from repnerv_tpu_torch.kernels import decode_int8 as k8
from repnerv_tpu_torch.kernels import launches as kernel_launches
from repnerv_tpu_torch.kernels import reparam_fuse as rfk
from repnerv_tpu_torch.kernels import ssim_blur as sb
from repnerv_tpu_torch.kernels import train_tail as tt
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models import reparam
from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, param_count
from repnerv_tpu_torch.utils.profiling import trace
from repnerv_tpu_torch.train.loop import (
    DECODE_REPS,
    build_eval_step_fn,
    build_train_step_fn,
    decode_batch,
    decode_time_batches,
    decode_video,
    epoch_rows,
    evaluate,
    init_train_state,
    make_decode_fn,
    make_epoch_fn,
    make_eval_step,
    make_streaming_epoch_fn,
    make_train_step,
    make_video_decode_fn,
    measure_decode_fps,
    run_epoch,
    run_fused_epoch,
    stream_chunk_steps,
    time_decode,
)

SEED = 0
# stage shapes of the flagship decode (ModelConfig(branch_type="ERB")):
# (name, H, W, Cin, C, stride, fused head); blocks 1-4 run the kernel on the
# main path, the stride-5 stage 0 shape is checked for the general case
SHAPES = [
    ("block1", 45, 80, 26, 96, 2, False),
    ("block2", 90, 160, 96, 96, 2, False),
    ("block3", 180, 320, 96, 96, 2, False),
    ("block4+head", 360, 640, 96, 96, 2, True),
    ("stride5", 9, 16, 26, 26, 5, False),
]
MAIN_PATH_SHAPES = ("block1", "block2", "block3", "block4+head")
SERVE_FRAMES, SERVE_BATCH = 32, 8
# f32 against cuDNN with TF32 off, K = 9*Cin <= 864 products a value.  The FMA
# kernel sums the same exact f32 products in another order: ~sqrt(K) * 2^-24 *
# |sum|.  The wgmma kernel sums three TF32 tensor-core products per f32
# product (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, operands split so that each is
# exact) and drops a_lo*b_lo, ~2^-22 a term.  The tensor core adds into its f32
# accumulator by truncation, so the kernel leaves it only the 16 channels of
# one tap at a time (6 MMAs from zero: small sums, small truncation) and adds
# those 54 partial sums with f32 additions, rounded to nearest.  Both kernels'
# errors on the same inputs are printed side by side.
F32_ATOL = 1e-4
# bf16 without a head: both round the same f32 value (up to that summation
# order) to bf16, so they differ by at most one bf16 ulp: 2^-7 |ref| + 1e-4.
# With the head the output is f32 on both sides, and F32_ATOL applies.
BF16_RTOL = 2.0**-7
# served frames, bf16: the plain path rounds to bf16 after the conv, the
# bias add, the activation and the head (the JAX XLA path's cast points);
# the kernel once per stage.  Those extra roundings (2^-8 relative each)
# compound over 5 stages; the squash (tanh slope <= 1/2) maps them to [0, 1].
SERVE_BF16_ATOL = 5e-2

# the training slice: the paper recipe at -b 1 on 16 synthetic 720p frames
TRAIN_FRAMES, TRAIN_EPOCHS = 16, 2
TRAIN_ARGV = (
    f"--dataset synth --synthetic_frames {TRAIN_FRAMES} --synthetic_hw 720 1280 "
    "--embed 1.25_40 --stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 "
    "--strides 5 2 2 2 2 --lower_width 96 --branch_type ERB --act swish --single_res "
    f"--loss Fusion6 -b 1 --lr 5e-4 -e {TRAIN_EPOCHS} --device cuda"
).split()
# launches per training step: K3 and K4 on blocks 1-4; K5 once for the means
# of the Fusion6 SSIM term, once for their VJP (the target needs none) and
# once per level of the MS-SSIM metric.  Per frame of the eval: 5 K5.
PER_STEP = {"K3": 4, "K4": 4, "K5": 1 + 1 + 5}
# "mixed" runs every conv on the library (the JAX gate keeps it off K3 / K4)
PER_STEP_MIXED = {"K3": 0, "K4": 0, "K5": 1 + 1 + 5}
PER_EVAL_FRAME = {"K3": 0, "K4": 0, "K5": 5}
# ERB's fusion: each of the flagship's 5 ERB blocks folds in two launches a
# training step, and its VJP in two more; an eval frame folds them with no VJP
# (every dtype: the branch weights stay f32)
FOLD_PER_STEP = {"FOLD": 5 * 2, "FOLD_VJP": 5 * 2}
FOLD_PER_EVAL_FRAME = {"FOLD": 5 * 2, "FOLD_VJP": 0}
# (name, Oo = Om, I) of every ERB block of erb-720p and erb-uvg1080p (M = 2 I)
FOLD_SHAPES = (("erb720.b0", 650, 26), ("erb720.b1", 384, 26), ("erb720.b2-4", 384, 96),
               ("erb1080.b0", 1200, 48), ("erb1080.b1", 864, 48))
# graph step vs eager step from the same weights over the 16 steps of an
# epoch: the same kernels in the same order, so the losses agree to the bit
# but where cuDNN's dX / dW algorithms sum in an order that is not fixed
# (f32: the stage-0 conv and the fused stages' dX / dW; mixed: every conv of
# the step, 1e6 f32 products a dW sum at 720p; bf16 rounds each dW to bf16).
# graph_vs_eager holds cuDNN to its deterministic algorithms: without them,
# two eager mixed epochs alone differed by up to 7.5e-5 over 16 steps
# (NVIDIA H100 80GB HBM3, 700 W).
GRAPH_TOL = {"bfloat16": 1e-3, "float32": 1e-5, "mixed": 1e-4}
# one step, kernel path vs --no_pallas_train, from the same weights and batch:
# f32 sums the same products in other orders (TF32 off): loss within 1e-5
# relative, each parameter's gradient within 1e-4 of its largest |entry|
# (the dW of a 720p stage sums ~1e6 products).  bf16: the library path
# rounds to bf16 after every conv, bias add, activation and head (the
# kernel path once per stage, then f32), so the two paths differ by a few
# bf16 ulps per stage, and the gradients through four stages of bf16
# backward convs by a few percent: loss within 5e-3 relative, gradients
# within 0.15 of each tensor's largest |entry|.
STEP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-3, 0.15)}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): operations per second by the unit a type can use, and bytes per
# second of device memory.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def roofline(ops: float, nbytes: float, unit: str) -> dict:
    """The least time the card could take for a piece of work:
        bound_ms = max(ops / PEAK_OPS[unit], nbytes / PEAK_BYTES) * 1e3
    ``ops`` counts the operations the function does on these inputs (2 per
    multiply-add), ``nbytes`` each input read once and each output written
    once, whatever a kernel reads again.  ``bound_by`` names the larger."""
    ops_ms, bytes_ms = ops / PEAK_OPS[unit] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sum_bounds(rows: list) -> dict:
    """The bound of several calls: the sum of theirs; bound by what the
    larger share of that sum is bound by."""
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    total = sum(r["bound_ms"] for r in rows)
    return {"bound_ms": total, "bound_by": "operations" if by_ops >= total - by_ops else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def stage_ops(bsz: int, h: int, w: int, cin: int, c: int, s: int, c_final: int) -> float:
    """FLOPs of one fused stage: the 3x3 conv (2 * 9 * Cin * Cout per low-res
    pixel) and the 1x1 head (2 * C * c_final per output pixel)."""
    return 2.0 * bsz * h * w * s * s * c * (9 * cin + c_final)


def conv_library_ms(x: torch.Tensor, p, tf32: bool = False) -> float:
    """The library yardstick of a stage: one ``F.conv2d`` (cuDNN) of the same
    shape in the stage's type, bf16 in channels_last, f32 with TF32 as said.
    It leaves out the bias, shuffle, activation and head that the kernel also
    does.  The port never calls it."""
    cin = x.shape[-1]
    xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wk = p.w.reshape(3, 3, cin, -1).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return cuda_ms(lambda: F.conv2d(xn, wk, padding=1))
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def old_kernel_run(route: str, x: torch.Tensor, p, out: torch.Tensor, z=None):
    """A call of the kernel that ran this shape before its wgmma kernel
    existed: ``route`` "wmma" (bf16) or "fma" (f32) of csrc/decode.cu through
    the C entry, into ``out`` (and ``z``).  A measurement of this script only;
    the port's wrappers take no route."""
    lib = build.load_library()
    ptr = ctypes.c_void_p
    bsz, h, w, cin = x.shape
    entry = lib.repnerv_fused_conv_ps_act if z is None else lib.repnerv_train_stage_fwd
    args = [dk.ROUTES.index(route), ptr(x.data_ptr()), ptr(p.w.data_ptr()), ptr(None),
            ptr(p.b.data_ptr()), ptr(p.head_w.data_ptr() if p.c_final else None),
            ptr(p.head_b.data_ptr() if p.c_final else None), ptr(out.data_ptr())]
    if z is not None:
        args.append(ptr(z.data_ptr()))
    args += [bsz, h, w, cin, p.c, p.stride, dk.ACT_CODES["swish"], p.c_final, 0]

    def run():
        err = entry(*args, ptr(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"{route} kernel launch failed: cudaError {err}")

    return run


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# (the wrappers' launches, their kernels' events in the file) of every trace
# of profile_kernels
TRACES: list = []


def empty_traces() -> int:
    """The traces that held none of the launched kernels."""
    return sum(1 for launched, seen in TRACES if launched and not seen)


def short_traces() -> int:
    """The traces that held fewer of the launched kernels than launched."""
    return sum(1 for launched, seen in TRACES if seen < launched)


def device_us(prof) -> dict:
    """{kernel name: device us} of a finished torch.profiler session."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total}


def profile_kernels(fn, fragment: str, reps: int = 5, traces: int = 3):
    """(the launches the wrappers counted, {kernel name: device us}) over a
    trace (``utils/profiling.py::trace``) of ``reps`` calls of ``fn()`` that
    launch one kernel named *fragment* each, after one call outside it.  A
    trace that holds fewer such kernel events than the wrappers launched
    (``trace`` itself raises when it holds none) is counted, logged and
    taken again, ``traces`` times at most (ROADMAP C24).  Every trace goes
    into ``TRACES``."""
    fn()
    torch.cuda.synchronize()
    launched, seen = reps, {}
    with tempfile.TemporaryDirectory() as d:
        for _ in range(traces):
            try:
                with trace(d) as rec:
                    for _ in range(reps):
                        fn()
            except RuntimeError as e:
                TRACES.append((reps, 0))
                log(f"[profiler] {e} (empty trace {empty_traces()} of {len(TRACES)} in the run): "
                    "tracing again")
                continue
            launched, seen = rec.launched, device_us(rec.profiler)
            events = sum(n for k, n in rec.kernels.items() if fragment in k.lower())
            TRACES.append((launched, events))
            if events >= launched:
                break
            log(f"[profiler] a trace of {reps} calls that launched {launched} held {events} "
                f"*{fragment}* kernel events ({short_traces()} short traces of {len(TRACES)} in "
                "the run): tracing again")
    return launched, seen


def kernel_device_ms(fn, fragment: str, reps: int = 5) -> float:
    """The card's own time for the kernels of one ``fn()`` whose name holds
    ``fragment``, from a torch.profiler trace of ``reps`` calls.  ``cuda_ms``
    of a call that is shorter than the host takes to launch it (K4 and K5 at
    the small stages: tens of microseconds) reads the host instead.  It fails
    where the wrappers launched less than once a call (the path) or the
    profiler saw no such kernel (the profiler), and says which."""
    launched, seen = profile_kernels(fn, fragment, reps)
    if launched < reps:
        raise AssertionError(f"{reps} calls launched {launched} kernels of K1-K5")
    us = sum(v for k, v in seen.items() if fragment in k.lower())
    if not us:
        raise RuntimeError(f"the profiler saw no kernel named *{fragment}* in {reps} calls that "
                           f"launched {launched}; it saw {len(seen)} kernels: {sorted(seen)[:8]} "
                           f"({empty_traces()} empty traces of {len(TRACES)} so far)")
    return us / 1e3 / reps


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    log(f"[build] {os.path.relpath(so)} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(build.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")
    # did each operand type reach wgmma?  HGMMA (bf16, tf32) / IGMMA (int8) and
    # UTMALDG (TMA loads) in the SASS of each wgmma source's kernels
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    functions = sass.split("Function : ")[1:]
    for source, policy in (("decode_wgmma.cu", "Bf16Policy"),
                           ("decode_wgmma_tf32.cu", "Tf32x3Policy"),
                           ("decode_wgmma_s8.cu", "S8Policy")):
        mine = [f for f in functions if policy in f.split("\n", 1)[0]]
        counts = {k: sum(f.count(k) for f in mine) for k in ("HGMMA", "IGMMA", "UTMALDG")}
        log(f"[build] SASS of {source}: {len(mine)} kernels, " +
            ", ".join(f"{v} {k}" for k, v in counts.items()))
        gmma = "IGMMA" if policy == "S8Policy" else "HGMMA"
        if not mine or not counts[gmma] or not counts["UTMALDG"]:
            raise AssertionError(f"{source} holds no {gmma} or no UTMALDG instruction")


def stage_yardsticks(x: torch.Tensor, p, out: torch.Tensor, z=None, refs=()) -> dict:
    """Bound, library time and, on a wgmma route, the time of the kernel the
    shape ran before (bf16: WMMA; f32: FMA, with its error against ``refs``,
    the plain version's out [and z]) of one stage call.  Bound: the conv's
    and the head's FLOPs on the unit the kernel's route uses (bf16 tensor
    cores; f32 on the wgmma route three TF32 tensor-core products per f32
    product, 3 x FLOPs / 495 TFLOP/s, else the FMA pipes) against x, the
    weights, the bias, the head and every output crossing device memory once."""
    bsz, h, w, cin = x.shape
    ops = stage_ops(bsz, h, w, cin, p.c, p.stride, p.c_final)
    moved = nbytes(x, p.w, p.b, p.head_w, p.head_b, out, z)
    old_out, old_z = torch.empty_like(out), None if z is None else torch.empty_like(z)
    if x.dtype == torch.bfloat16:
        row = roofline(ops, moved, "bf16")
        row["library_ms"] = conv_library_ms(x, p)
        if p.route == "wgmma":
            row["wmma_ms"] = cuda_ms(old_kernel_run("wmma", x, p, old_out, old_z))
        return row
    fma = roofline(ops, moved, "f32")
    if p.route == "wgmma_tf32x3":
        row = roofline(3 * ops, moved, "tf32")
        row["bound_fma_ms"] = fma["bound_ms"]
        row["fma_ms"] = cuda_ms(old_kernel_run("fma", x, p, old_out, old_z))
        torch.cuda.synchronize()
        row["fma_max_abs_err"] = max(
            (a - r.to(a.dtype)).abs().max().item() for a, r in zip((old_out, old_z), refs))
    else:
        row = fma
    row["library_ms"] = conv_library_ms(x, p, tf32=False)  # the same function: exact f32
    row["library_tf32_ms"] = conv_library_ms(x, p, tf32=True)
    return row


def yardstick_text(row: dict) -> str:
    text = f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}"
    text += ", 3xTF32" if "bound_fma_ms" in row else ""
    text += f"), F.conv2d {row['library_ms']:.3f} ms"
    if "library_tf32_ms" in row:
        text += f" (TF32 on {row['library_tf32_ms']:.3f})"
    if "wmma_ms" in row:
        text += f", WMMA kernel {row['wmma_ms']:.3f} ms"
    if "fma_ms" in row:
        text += (f", FMA kernel {row['fma_ms']:.3f} ms with max|d|={row['fma_max_abs_err']:.3e} "
                 f"(its bound {row['bound_fma_ms']:.3f})")
    return text


def phase_kernel() -> dict:
    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(dev)

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        rows = []
        for name, h, w, cin, c, s, head in SHAPES:
            cout = c * s * s
            x = torch.randn(SERVE_BATCH, h, w, cin, generator=g).to(dev)
            wt = uniform((3, 3, cin, cout), (9 * cin) ** -0.5)
            b = uniform((cout,), (9 * cin) ** -0.5)
            hw = uniform((1, 1, c, 3), c**-0.5) if head else None
            hb = uniform((3,), c**-0.5) if head else None
            p = dk.pack_weights(wt, b, s, dtype, head_w=hw, head_b=hb)
            xin = x.to(dtype).contiguous()
            out = dk.decode_stage(xin, p, "swish", "tanh")
            ref = dk.decode_stage_reference(xin, p, "swish", "tanh")
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.bfloat16 and not head:
                tol = "|d| <= 2^-7|ref| + 1e-4"
                ok = bool((diff <= BF16_RTOL * ref.float().abs() + 1e-4).all())
            else:
                tol = f"{F32_ATOL:g}"
                ok = err <= F32_ATOL
            ok = ok and bool(torch.isfinite(out).all())
            ms = cuda_ms(lambda: dk.decode_stage(xin, p, "swish", "tanh"))
            plain_ms = cuda_ms(lambda: dk.decode_stage_reference(xin, p, "swish", "tanh"))
            row = {"shape": name, "dtype": dname, "route": p.route, "max_abs_err": err,
                   "tol": tol, "ms": ms, "plain_ms": plain_ms}
            row.update(stage_yardsticks(xin, p, out, refs=(ref,)))
            log(
                f"[kernel] {dname:8s} {name:12s} x[{SERVE_BATCH},{h},{w},{cin}] s={s} "
                f"-> {list(out.shape)}: max|d|={err:.3e} (tol {tol}) {p.route} "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {yardstick_text(row)} "
                f"{'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version at {name} {dname}")
            rows.append(row)
            del x, xin, out, ref, diff
        results[dname] = rows
    torch.cuda.empty_cache()
    return results


def phase_serve(tmp: str) -> dict:
    cfg = ModelConfig(branch_type="ERB")  # Bunny-720p flagship, full width and depth
    gen = Generator(cfg, seed=SEED, device="cpu")
    state = {k: v.detach().numpy() for k, v in gen.state_dict().items()}
    log(f"[serve] flagship ERB generator, seed {SEED}: {param_count(gen)} train-state params")
    del gen
    dev = torch.device("cuda", 0)
    n_batches = SERVE_FRAMES // SERVE_BATCH
    out = {}
    for dtype in ("float32", "bfloat16"):
        path = os.path.join(tmp, f"flagship_{dtype}.rnvb")
        mcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        acct = write_bitstream(path, state, mcfg, quant_bit=8)
        log(f"[serve] wrote {os.path.basename(path)}: {int(acct['file_bytes'])} bytes")

        reset_counts()  # the main path's run starts here
        res = decode_main.main([path, "--frames", str(SERVE_FRAMES), "--batch", str(SERVE_BATCH)])
        launches, routes = dk.LAUNCHES, dict(dk.ROUTE_LAUNCHES)  # ... and ends here
        # the kernels that ran: the warm-up decode's eager first batch and its
        # replays, then a replay a batch of each timed rep (the capture ran none)
        passes = n_batches * (1 + DECODE_REPS)
        expected = 4 * passes
        # blocks 2-4 (Cin 96) on the type's wgmma kernel, block 1 (Cin 26) on WMMA / FMA
        want = dict.fromkeys(dk.ROUTES, 0)
        want.update({"wmma": passes, "wgmma": 3 * passes} if dtype == "bfloat16"
                    else {"fma": passes, "wgmma_tf32x3": 3 * passes})
        log(f"[serve] {dtype}: decode_main -> {res}; kernel launches {launches} (expect "
            f"{expected}), by route {routes} (expect {want})")
        if launches != expected:
            raise AssertionError(f"expected {expected} kernel launches (4 per batch), got {launches}")
        if routes != want:
            raise AssertionError(f"{dtype}: K1 launches by route {routes}, expected {want}")

        st, acfg, _ = read_bitstream(path)
        model = decode_main.serving_model(st, acfg, dev)
        plain_cfg = dataclasses.replace(model.cfg, use_pallas_decode=False)
        plain = decode_main.serving_model(st, dataclasses.replace(acfg, use_pallas_decode=False), dev)
        t = torch.arange(SERVE_BATCH, dtype=torch.float32, device=dev) / SERVE_FRAMES
        frames = make_decode_fn(TrainConfig(model=model.cfg))(model, t)
        ref = make_decode_fn(TrainConfig(model=plain_cfg))(plain, t)
        torch.cuda.synchronize()
        if tuple(frames.shape) != (SERVE_BATCH, 720, 1280, 3) or frames.dtype != torch.float32:
            raise AssertionError(f"frames {tuple(frames.shape)} {frames.dtype}")
        if not bool(torch.isfinite(frames).all()) or frames.min() < 0 or frames.max() > 1:
            raise AssertionError("frames are not finite values in [0, 1]")
        diff = (frames - ref).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        tol = F32_ATOL if dtype == "float32" else SERVE_BF16_ATOL
        log(
            f"[serve] {dtype}: first batch kernel vs plain path max|d|={err:.3e} "
            f"mean|d|={mean_err:.3e} (tol {tol:g}); frames in "
            f"[{frames.min().item():.4f}, {frames.max().item():.4f}]"
        )
        if err > tol:
            raise AssertionError(f"served frames differ from the plain path by {err}")
        del frames, ref, diff
        plain_fps = measure_decode_fps(
            plain, TrainConfig(model=plain_cfg), np.arange(SERVE_FRAMES) / SERVE_FRAMES, SERVE_BATCH
        )
        log(f"[serve] {dtype}: fps kernel path {res['fps']:.2f} ({1e3 * SERVE_BATCH / res['fps']:.3f} "
            f"ms per batch of {SERVE_BATCH}), plain path {plain_fps:.2f}")
        out[dtype] = {
            "launches": launches, "route_launches": routes, "fps": res["fps"],
            "plain_fps": plain_fps, "batch_ms": 1e3 * SERVE_BATCH / res["fps"],
            "graph_vs_eager": serve_graph_vs_eager(model, dtype),
            "frames_max_abs_err": err, "frames_mean_abs_err": mean_err,
        }
        del model, plain
        torch.cuda.empty_cache()
    return out


# (name, H, W, Cin, C, stride, head) of the fused training stages at -b 1
TRAIN_SHAPES = [
    ("block1", 45, 80, 26, 96, 2, False),
    ("block2", 90, 160, 96, 96, 2, False),
    ("block3", 180, 320, 96, 96, 2, False),
    ("block4+head", 360, 640, 96, 96, 2, True),
]
# the K5 calls of one step, (name, [B, H, W, C] images, stats launches, VJP
# launches): the loss's SSIM at 720p (the means with the moments kept, one
# VJP) and the MS-SSIM metric's five levels (the means alone); b = 1, 3
# channels
BLUR_CALLS = [("loss", (1, 720, 1280, 3), 1, 1)] + [
    (f"msssim-l{i}", (1, 720 >> i, 1280 >> i, 3), 1, 0) for i in range(5)
]
# the stats launch sums the plain formula's maps (the same bits) per block
# and then the blocks, in another order than the plain mean's: within this
# of the plain means (O(1) values)
K5_MEAN_TOL = 1e-6
# the fused VJP adds three terms, B(g_mu) + 2 x B(g_xx) + y B(g_xy), in an
# order autograd does not fix: within this share of the plain VJP's largest
# |entry| (a few f32 roundings of O(1) terms)
K5_VJP_RTOL = 1e-6
# the SSIM constants of data range 1 (ops/ssim.py)
SSIM_C1, SSIM_C2 = 0.01**2, 0.03**2


def _bf16_ulp(out, ref):
    """|d| <= 2^-7 |ref| + 1e-4: both round one f32 value (up to summation
    order) to bf16."""
    return bool(((out.float() - ref.float()).abs() <= BF16_RTOL * ref.float().abs() + 1e-4).all())


def stage_train_rows(shapes: list, g: torch.Generator, tag: str) -> dict:
    """K3 and K4 against their plain versions at ``shapes`` ((name, H, W,
    Cin, C, stride, head) of -b 1 stages), f32 and bf16: values, times,
    bounds and the library's conv; the rows of each, logged under ``tag``."""
    dev = torch.device("cuda", 0)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(dev)

    rows = {"K3": [], "K4": []}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, h, w, cin, c, s, head in shapes:
            cout = c * s * s
            x = torch.randn(1, h, w, cin, generator=g).to(dev).to(dtype).contiguous()
            wt = uniform((3, 3, cin, cout), (9 * cin) ** -0.5)
            b = uniform((cout,), (9 * cin) ** -0.5)
            hw = uniform((1, 1, c, 3), c**-0.5) if head else None
            hb = uniform((3,), c**-0.5) if head else None
            p = dk.pack_weights(wt, b, s, dtype, head_w=hw, head_b=hb)
            # K3
            out, z = tt.stage_forward(x, p, "swish", "tanh")
            ref_out, ref_z = tt.stage_forward_reference(x, p, "swish", "tanh")
            torch.cuda.synchronize()
            err = max((out.float() - ref_out.float()).abs().max().item(),
                      (z.float() - ref_z.float()).abs().max().item())
            if dtype == torch.bfloat16:
                tol = "z and no-head out: |d| <= 2^-7|ref| + 1e-4; head out 1e-4"
                ok = _bf16_ulp(z, ref_z) and (
                    (out - ref_out).abs().max().item() <= F32_ATOL if head else _bf16_ulp(out, ref_out))
            else:
                tol, ok = f"{F32_ATOL:g}", err <= F32_ATOL
            ok = ok and bool(torch.isfinite(out).all()) and bool(torch.isfinite(z).all())
            ms = cuda_ms(lambda: tt.stage_forward(x, p, "swish", "tanh"))
            plain_ms = cuda_ms(lambda: tt.stage_forward_reference(x, p, "swish", "tanh"))
            row = {"shape": name, "dtype": dname, "route": p.route, "max_abs_err": err,
                   "tol": tol, "ms": ms, "plain_ms": plain_ms}
            row.update(stage_yardsticks(x, p, out, z, refs=(ref_out, ref_z)))
            log(f"[{tag}] K3 {dname:8s} {name:12s} x[1,{h},{w},{cin}] -> out "
                f"{list(out.shape)} z {list(z.shape)}: max|d|={err:.3e} (tol {tol}) {p.route} "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {yardstick_text(row)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version at {name} {dname}")
            rows["K3"].append(row)
            # K4 on this stage's z and a cotangent of its output
            ct = torch.randn(out.shape, generator=g).to(dev).to(out.dtype).contiguous()
            args = (z, ct, out if head else None, p.head_w, s, "swish", "tanh")
            got = tt.epilogue_backward(*args)
            again = tt.epilogue_backward(*args)
            ref = tt.epilogue_backward_reference(*args)
            torch.cuda.synchronize()
            err = (got[0].float() - ref[0].float()).abs().max().item()
            ok = _bf16_ulp(got[0], ref[0]) if dtype == torch.bfloat16 else err <= 1e-5
            # d_b (PixelShuffle order), d_hw, d_hb: summed in the kernel, in a
            # fixed order over <= 2^20 f32 terms, against one torch sum
            part_rel = 0.0
            for a, r in zip(got[1:], ref[1:]):
                if r is not None:
                    part_rel = max(part_rel, (a - r).abs().max().item() / max(r.abs().max().item(), 1.0))
            ok = ok and part_rel <= 1e-4
            # ... and with the same bits from launch to launch
            same_bits = all(torch.equal(a, b2) for a, b2 in zip(got, again) if a is not None)
            ok = ok and same_bits
            tol = ("d_conv |d| <= 2^-7|ref| + 1e-4" if dtype == torch.bfloat16 else "d_conv 1e-5") + \
                "; sums 1e-4 x max|ref|, equal bits from two launches"
            ms = cuda_ms(lambda: tt.epilogue_backward(*args))
            device_ms = kernel_device_ms(lambda: tt.epilogue_backward(*args), "epilogue_bwd")
            plain_ms = cuda_ms(lambda: tt.epilogue_backward_reference(*args))
            # bound: z, the cotangent and (head) the output and head weight
            # read once, d_conv and the finished gradients written once; per z
            # element ~10 FLOPs of activation derivative and, with a head, 4
            # per head output (d_a and dW products), on the FMA pipes
            k4_bound = roofline(z.numel() * (10.0 + 4 * p.c_final),
                                nbytes(z, ct, out if head else None, p.head_w, *got), "f32")
            log(f"[{tag}] K4 {dname:8s} {name:12s} z {list(z.shape)} -> d_conv "
                f"{list(got[0].shape)}: d_conv max|d|={err:.3e}, sums max|d|/max|ref|="
                f"{part_rel:.3e}, two launches {'equal' if same_bits else 'DIFFER'} (tol {tol}) "
                f"kernel {ms:.3f} ms a call, {device_ms:.3f} ms on the card, "
                f"plain {plain_ms:.3f} ms, "
                f"bound {k4_bound['bound_ms']:.3f} ms ({k4_bound['bound_by']}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version at {name} {dname}")
            rows["K4"].append({"shape": name, "dtype": dname, "max_abs_err": err,
                               "partials_rel_err": part_rel, "tol": tol, "ms": ms,
                               "device_ms": device_ms, "plain_ms": plain_ms, **k4_bound})
            del x, out, z, ref_out, ref_z, ct, got, again, ref, args
            torch.cuda.empty_cache()
    return rows


def phase_train_kernels() -> dict:
    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)
    rows = {**stage_train_rows(TRAIN_SHAPES, g, "train-kernels"), "K5": []}
    win = sb.window_tuple(11, 1.5)

    def blur_ops(n, h, w_in, w_out, h_out, maps):
        # 2 x 11 FLOPs per value of the column pass and of the row pass
        return 22.0 * maps * n * (h_out * w_in + h_out * w_out)

    c1, c2 = SSIM_C1, SSIM_C2
    for name, shape, n_fwd, n_vjp in BLUR_CALLS:
        _, h, w, n = shape  # b = 1: n planes, the channels
        keep = n_vjp > 0  # the loss's term keeps its moments for the VJP, a level none
        x, y = torch.rand(shape, generator=g).to(dev), torch.rand(shape, generator=g).to(dev)
        g_s, g_c = (torch.randn(1, n, generator=g).to(dev) for _ in range(2))
        s, c, moments = sb.stats_forward(x, y, win, c1, c2, keep_moments=keep)
        again = sb.stats_forward(x, y, win, c1, c2, keep_moments=keep)
        ref_s, ref_c = sb.ssim_stats_reference(x, y, win, c1, c2)
        ref_moments = sb.ssim_moments_reference(sb.planes(x), sb.planes(y), win)
        torch.cuda.synchronize()
        # the means: the plain formula's maps to the bit, summed per block
        # and then by blocks; two launches give the same bits
        err = max((s - ref_s).abs().max().item(), (c - ref_c).abs().max().item())
        same_bits = torch.equal(s, again[0]) and torch.equal(c, again[1])
        # the kept moments: the plain blurs' bits
        moments_ok = not keep or all(torch.equal(m, r) for m, r in zip(moments, ref_moments))
        vjp_err = vjp_tol = 0.0
        if n_vjp:
            dx = sb.stats_vjp(moments, g_s, g_c, x, y, win, c1, c2)
            dy = sb.stats_vjp(sb._paired(moments), g_s, g_c, y, x, win, c1, c2)
            refs = (sb.stats_vjp_reference(ref_moments, g_s, g_c, x, y, win, c1, c2),
                    sb.stats_vjp_reference(sb._paired(ref_moments), g_s, g_c, y, x, win, c1, c2))
            torch.cuda.synchronize()
            vjp_err = max((d - r).abs().max().item() for d, r in zip((dx, dy), refs))
            vjp_tol = K5_VJP_RTOL * max(r.abs().max().item() for r in refs)
        ok = err <= K5_MEAN_TOL and same_bits and moments_ok and vjp_err <= vjp_tol
        fwd = lambda: sb.stats_forward(x, y, win, c1, c2, keep_moments=keep)  # noqa: E731
        vjp = lambda: sb.stats_vjp(moments, g_s, g_c, x, y, win, c1, c2)  # noqa: E731
        ms = cuda_ms(fwd)
        device_ms = kernel_device_ms(fwd, "blur_tiles")
        plain_ms = cuda_ms(lambda: sb.ssim_stats_reference(x, y, win, c1, c2))
        vjp_ms = cuda_ms(vjp) if n_vjp else 0.0
        vjp_device_ms = kernel_device_ms(vjp, "blur_tiles") if n_vjp else 0.0
        vjp_plain_ms = (cuda_ms(lambda: sb.stats_vjp_reference(ref_moments, g_s, g_c, x, y, win,
                                                               c1, c2)) if n_vjp else 0.0)
        # the library's one call for the same moments: a depthwise F.conv2d
        # (groups = channels) with the 11 x 11 outer product of the window,
        # VALID, on the five stacked maps x, y, x*x, y*y, x*y of the planes
        # (TF32 off); only the conv is timed, not the stacking, and it forms
        # neither the SSIM formula nor the means
        xp, yp = sb.planes(x), sb.planes(y)
        maps = torch.stack([xp, yp, xp * xp, yp * yp, xp * yp]).reshape(1, 5 * n, h, w)
        taps = torch.tensor(win, dtype=torch.float32, device=dev)
        kernel2d = torch.outer(taps, taps).expand(5 * n, 1, len(win), len(win)).contiguous()
        lib_out = F.conv2d(maps, kernel2d, groups=5 * n).reshape(5, n, h - 10, w - 10)
        lib_err = (lib_out - torch.stack(ref_moments)).abs().max().item()
        lib_ms = cuda_ms(lambda: F.conv2d(maps, kernel2d, groups=5 * n))
        del maps, lib_out, xp, yp
        # bounds on the calls' own bytes: x and y read once, the [2, N, tiles]
        # partial sums written, the five moments written only when kept; for
        # the VJP the five moments, x and y and the two upstream [1, C] read
        # and d_x written.  Operations: the blurs, x*x, y*y, x*y a pixel, the
        # SSIM / cs formula and both sums (19 an output pixel); the VJP's
        # cotangents in its loader (31 a moment pixel) and its combine (5 an
        # image value)
        ho, wo = h - 10, w - 10
        fwd_bytes = nbytes(x, y, *(moments if keep else ())) + 2 * n * sb.stats_tiles(h, w, 11) * 4
        vjp_bytes = nbytes(*ref_moments, g_s, g_c, x, y) + nbytes(x)  # d_x: x's size
        fwd_bound = roofline(blur_ops(n, h, w, wo, ho, 5) + 3.0 * n * h * w + 19.0 * n * ho * wo,
                             fwd_bytes, "f32")
        vjp_bound = roofline(blur_ops(n, h + 10, wo, w, h, 3) + 31.0 * n * ho * wo
                             + 5.0 * n * h * w, vjp_bytes, "f32")
        k5_bound = sum_bounds([fwd_bound] * n_fwd + [vjp_bound] * n_vjp)
        vjp_note = (f"; VJP d_x, d_y max|d|={vjp_err:.3e} (tol {vjp_tol:.3e} = {K5_VJP_RTOL:g} "
                    f"max|ref|), {vjp_ms:.3f} ms a call, {vjp_device_ms:.4f} on the card, plain "
                    f"{vjp_plain_ms:.3f}, bound {vjp_bound['bound_ms']:.4f} "
                    f"({vjp_bound['bound_by']})" if n_vjp else "")
        log(f"[train-kernels] K5 float32  {name:12s} x, y {list(shape)} -> means [1, {n}]"
            f"{' and 5 x ' + str(list(moments[0].shape)) if keep else ''}: means max|d|={err:.3e} "
            f"(tol {K5_MEAN_TOL:g}), two launches {'equal' if same_bits else 'DIFFER'}, moments "
            f"{'bitwise' if keep and moments_ok else 'DIFFER' if keep else 'not written'}; "
            f"kernel {ms:.3f} ms a call, {device_ms:.4f} on the card, plain {plain_ms:.3f} ms, "
            f"bound {fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}), library (depthwise "
            f"F.conv2d on the 5 stacked maps) {lib_ms:.3f} ms, max|d| against the plain moments "
            f"{lib_err:.3e}{vjp_note} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {name}")
        rows["K5"].append({
            "shape": name, "dtype": "float32", "max_abs_err": err, "tol": K5_MEAN_TOL,
            "kept_moments": keep, "two_launches_equal": same_bits,
            "vjp_max_abs_err": vjp_err, "vjp_tol": vjp_tol,
            "ms": ms, "plain_ms": plain_ms, "vjp_ms": vjp_ms, "vjp_plain_ms": vjp_plain_ms,
            # this shape's share of one training step's K5 launches
            "step_ms": n_fwd * ms + n_vjp * vjp_ms,
            "device_ms": device_ms, "vjp_device_ms": vjp_device_ms,
            "step_device_ms": n_fwd * device_ms + n_vjp * vjp_device_ms,
            "step_plain_ms": n_fwd * plain_ms + n_vjp * vjp_plain_ms,
            "calls_per_step": n_fwd + n_vjp,
            "fwd_bytes": fwd_bytes, "vjp_bytes": vjp_bytes if n_vjp else 0,
            **k5_bound,  # of this shape's calls of one step
            # the library call for this shape's moments, once a stats launch
            "library_ms": n_fwd * lib_ms, "library_max_abs_err": lib_err,
            "forward_step_ms": n_fwd * ms,
        })
        del s, c, again, moments, ref_moments
    # the single-map blur (gauss_blur_valid and its VJP), no longer on the
    # step's path: same inner loops, held to the bit at the loss's shape
    ct = torch.randn(3, 710, 1270, generator=g).to(dev)
    x = torch.rand(3, 720, 1280, generator=g).to(dev)
    out, ref = sb.blur_valid(x, win), sb.blur_valid_reference(x, win)
    dx, ref_dx = sb.blur_full(ct, win), sb.blur_full_reference(ct, win)
    torch.cuda.synchronize()
    ok = torch.equal(out, ref) and torch.equal(dx, ref_dx)
    single = {"shape": "single-map", "dtype": "float32", "tol": 0.0, "calls_per_step": 0,
              "max_abs_err": max((out - ref).abs().max().item(), (dx - ref_dx).abs().max().item()),
              "ms": cuda_ms(lambda: sb.blur_valid(x, win)),
              "plain_ms": cuda_ms(lambda: sb.blur_valid_reference(x, win)),
              "vjp_ms": cuda_ms(lambda: sb.blur_full(ct, win)),
              "vjp_plain_ms": cuda_ms(lambda: sb.blur_full_reference(ct, win)),
              **roofline(blur_ops(3, 720, 1280, 1270, 710, 1), nbytes(x, out), "f32")}
    log(f"[train-kernels] K5 float32  gauss_blur_valid [3, 720, 1280]: max|d|="
        f"{single['max_abs_err']:.3e} (tol 0, bitwise, forward and VJP) kernel "
        f"{single['ms']:.3f} ms (VJP {single['vjp_ms']:.3f}), plain {single['plain_ms']:.3f} ms "
        f"(VJP {single['vjp_plain_ms']:.3f}), bound {single['bound_ms']:.4f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the single-map blur disagrees with its plain version")
    rows["K5_single"] = single
    return rows


class _ErbView:
    """What ``reparam.fuse_erb_plain`` reads of an ERB block, over its nine
    branch tensors (``reparam.erb_tensors``' order)."""

    rbr_reparam = None

    def __init__(self, ts):
        def branch(w, b=None):
            return type("Branch", (), {"weight": w, "bias": b})()

        self.rbr_3x3_branch = branch(ts[0], ts[1])
        self.rbr_1x3_branch = branch(ts[2], ts[3])
        self.rbr_3x1_branch = branch(ts[4], ts[5])
        self.rbr_1x1_3x3_1x1_branch_1x1_1 = branch(ts[6])
        self.rbr_1x1_3x3_1x1_branch_3x3 = branch(ts[7])
        self.rbr_1x1_3x3_1x1_branch_1x1_2 = branch(ts[8])


def _fold_with_grads(fold, ts, dk_, db):
    """(K, b, the nine gradients) of ``fold`` over leaves made of ``ts``."""
    leaves = tuple(t.detach().requires_grad_(True) for t in ts)
    k, b = fold(leaves)
    return (k.detach(), b.detach(), *torch.autograd.grad((k, b), leaves, (dk_, db)))


def phase_fold() -> list:
    """Phase 5b: ERB's fusion and its VJP on the card's kernels at every ERB
    block shape of erb-720p and erb-uvg1080p, against the plain fusion in
    f64: each output within twice the plain f32 path's (cuBLAS, TF32 off)
    own error, two launches each way, the same bits twice; the kernel's ms
    and the plain path's (forward; forward and VJP) from the same inputs,
    and its bound in exact f32."""
    names = ("K", "b", "dw3x3", "db3x3", "dw1x3", "db1x3", "dw3x1", "db3x1", "dw1", "dw2", "dw3")
    g = torch.Generator().manual_seed(SEED)
    rows = []
    for shape, o, cin in FOLD_SHAPES:
        m = 2 * cin

        def u(shp, fan_in):
            return ((torch.rand(shp, generator=g, dtype=torch.float64) * 2 - 1)
                    * fan_in ** -0.5).cuda()

        ts64 = (u((o, cin, 3, 3), 9 * cin), u((o,), 9 * cin), u((o, cin, 1, 3), 3 * cin),
                u((o,), 3 * cin), u((o, cin, 3, 1), 3 * cin), u((o,), 3 * cin),
                u((m, cin, 1, 1), cin), u((o, m, 3, 3), 9 * m), u((o, o, 1, 1), o))
        dk64 = torch.randn(o, cin, 3, 3, generator=g, dtype=torch.float64).cuda()
        db64 = torch.randn(o, generator=g, dtype=torch.float64).cuda()

        def plain(leaves):
            return reparam.fuse_erb_plain(_ErbView(leaves))

        def kernel(leaves):
            return rfk.erb_fold(*leaves)

        ref = _fold_with_grads(plain, ts64, dk64, db64)
        ts = tuple(t.float() for t in ts64)
        dk_, db = dk64.float(), db64.float()
        if not rfk.takes(ts):
            raise AssertionError(f"[fold] {shape}: the kernels do not take ERB's f32 tensors")
        plain_out = _fold_with_grads(plain, ts, dk_, db)
        before = launch_counts()
        got = _fold_with_grads(kernel, ts, dk_, db)
        torch.cuda.synchronize()
        launched = {k: launch_counts()[k] - before[k] for k in ("FOLD", "FOLD_VJP")}
        again = _fold_with_grads(kernel, ts, dk_, db)
        err = {n: (x.double() - r).abs().max().item() for n, x, r in zip(names, got, ref)}
        plain_err = {n: (x.double() - r).abs().max().item()
                     for n, x, r in zip(names, plain_out, ref)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        worst = max(names, key=lambda n: err[n] / max(plain_err[n], 1e-300))
        ok = (same and launched == {"FOLD": 2, "FOLD_VJP": 2}
              and all(err[n] <= 2 * plain_err[n] for n in names))
        with torch.no_grad():
            ms = cuda_ms(lambda: kernel(ts))
            plain_ms = cuda_ms(lambda: plain(ts))
        leaves = tuple(t.detach().requires_grad_(True) for t in ts)
        both_ms = cuda_ms(lambda: torch.autograd.grad(kernel(leaves), leaves, (dk_, db)))
        leaves = tuple(t.detach().requires_grad_(True) for t in ts)
        plain_both_ms = cuda_ms(lambda: torch.autograd.grad(plain(leaves), leaves, (dk_, db)))
        # 2 per multiply-add: T = w2 . w1 and w3 . T forward; dw3, dT, dw2, dw1
        fwd_ops = 2.0 * (9 * o * cin * m + o * 9 * cin * o)
        vjp_ops = 2.0 * (o * o * 9 * cin + o * 9 * cin * o + 9 * o * m * cin + m * cin * 9 * o)
        fwd_bytes = nbytes(*ts) + nbytes(got[0], got[1])
        bound = roofline(fwd_ops + vjp_ops, nbytes(*ts, dk_, db, *got), "f32")
        row = {"shape": shape, "dtype": "float32", "o": o, "cin": cin, "m": m,
               "max_abs_err": max(err.values()), "errors": err, "plain_errors": plain_err,
               "worst": worst, "same_bits": same, "launches": launched,
               "ms": both_ms, "plain_ms": plain_both_ms, "forward_ms": ms,
               "forward_plain_ms": plain_ms, "library_ms": plain_both_ms,
               "forward_bound_ms": roofline(fwd_ops, fwd_bytes, "f32")["bound_ms"], **bound}
        rows.append(row)
        log(f"[fold] {shape} (O {o}, I {cin}): worst {worst} max|d| {err[worst]:.3e} against "
            f"the plain f32 path's {plain_err[worst]:.3e} (tol 2x, every output), same bits "
            f"{same}, launches {launched}; forward {ms:.4f} ms (plain {plain_ms:.4f}, bound "
            f"{row['forward_bound_ms']:.4f}); forward and VJP {both_ms:.4f} ms (plain "
            f"{plain_both_ms:.4f}, bound {bound['bound_ms']:.4f} by {bound['bound_by']}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[fold] {shape}: errors {err} against the plain path's "
                                 f"{plain_err}, same bits {same}, launches {launched}")
    return rows


@contextlib.contextmanager
def plain_fold(on: bool = True):
    """ERB's fusion on its plain path (``fuse_erb_plain``, as on a CPU
    tensor) inside the block when ``on``: the plain side of a kernel-vs-plain
    step."""
    takes = rfk.takes
    if on:
        rfk.takes = lambda tensors: False
    try:
        yield
    finally:
        rfk.takes = takes


def check_fold_counts(label: str, epoch_fns: list, eval_counts: dict, n_eval: int) -> None:
    """The fusion's launches in a run's replayed training step (each epoch
    function's replay: one step) and in its eval (the run's own deploy
    snapshots and --eval_fps decodes fold too, outside both)."""
    got = [{k: launches_of(fn.replay_counts)[k] for k in FOLD_PER_STEP} for fn in epoch_fns]
    want_eval = {k: v * n_eval for k, v in FOLD_PER_EVAL_FRAME.items()}
    got_eval = {k: eval_counts.get(k, 0) for k in want_eval}
    log(f"[fold] {label}: fusion launches a replayed step {got} (expect {FOLD_PER_STEP} for "
        f"each epoch function), in the eval of {n_eval} frames {got_eval} (expect {want_eval})")
    if not got or any(r != FOLD_PER_STEP for r in got) or got_eval != want_eval:
        raise AssertionError(f"[fold] {label}: launches a step {got} and {got_eval} in the "
                             f"eval, expected {FOLD_PER_STEP} and {want_eval}")


def fold_main_path(tmp: str) -> dict:
    """Phase 5b's main-path part: train_main on TRAIN_ARGV in bf16, its
    fusion launches in the training steps and in the eval."""
    eval_counts = {}
    evaluate = train_main.evaluate

    def counted_evaluate(*args, **kwargs):
        before = launch_counts()
        out = evaluate(*args, **kwargs)
        for k, v in launch_counts().items():
            eval_counts[k] = eval_counts.get(k, 0) + v - before[k]
        return out

    cwd = os.getcwd()
    train_main.evaluate = counted_evaluate
    os.chdir(tmp)  # train_main writes under result/<outf>
    try:
        reset_counts()  # the main path's run starts here
        with EpochRecorder() as rec:
            train_main.main(TRAIN_ARGV + ["--compute_dtype", "bfloat16", "--outf", "fold"])
        counts = launch_counts()  # ... and ends here
    finally:
        os.chdir(cwd)
        train_main.evaluate = evaluate
    check_fold_counts("train_main bfloat16", rec.epoch_fns(), eval_counts,
                      TRAIN_FRAMES * TRAIN_EPOCHS)
    return {"launches": counts, "eval_launches": eval_counts}


def fold_kernel_row(rows: list, launches: int) -> dict:
    """The ``kernels`` line's row of ERB's fusion: the five ERB blocks of one
    -b 1 erb-720p training step (block 0, block 1, blocks 2-4 three times),
    forward and VJP."""
    step = [r for r in rows if r["shape"] == "erb720.b0"] + [
        r for r in rows if r["shape"] == "erb720.b1"] + 3 * [
        r for r in rows if r["shape"] == "erb720.b2-4"]
    return {"name": "erb_fold[float32]", "route": "cuda",
            "source": "repnerv_tpu_torch/csrc/reparam_fuse.cu",
            "replaces": "repnerv_tpu/models/reparam.py fuse_erb (jnp.einsum; no TPU kernel)",
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in step), "plain_ms": sum(r["plain_ms"] for r in step),
            **sum_bounds(step), "library_ms": sum(r["library_ms"] for r in step),
            "library_note": "the plain path's cuBLAS einsums and autograd's VJP",
            "shapes": rows}


def launch_counts() -> dict:
    return {"K1": dk.LAUNCHES, "K2": k8.LAUNCHES, "K3": tt.FWD_LAUNCHES,
            "K4": tt.BWD_LAUNCHES, "K5": sb.LAUNCHES,
            "FOLD": rfk.FWD_LAUNCHES, "FOLD_VJP": rfk.VJP_LAUNCHES}


def reset_counts() -> None:
    dk.LAUNCHES = k8.LAUNCHES = tt.FWD_LAUNCHES = tt.BWD_LAUNCHES = sb.LAUNCHES = 0
    rfk.FWD_LAUNCHES = rfk.VJP_LAUNCHES = 0
    for routes in (dk.ROUTE_LAUNCHES, tt.FWD_ROUTE_LAUNCHES, k8.ROUTE_LAUNCHES):
        for r in routes:
            routes[r] = 0


def _train_cfg(dtype: str, use_kernel: bool) -> TrainConfig:
    mcfg = ModelConfig(branch_type="ERB", compute_dtype=dtype, use_pallas_train=use_kernel)
    return TrainConfig(model=mcfg, data=DataConfig(batch_size=1), epochs=TRAIN_EPOCHS,
                       lr=5e-4, loss_type="Fusion6")


def _step_setup(dtype: str, use_kernel: bool, store: FrameStore):
    """The seed's state and the eager step (``build_train_step_fn``)."""
    cfg = _train_cfg(dtype, use_kernel)
    state = init_train_state(cfg, "cuda", seed=SEED)
    step = build_train_step_fn(cfg, TRAIN_FRAMES, with_msssim=True)
    t_all = torch.from_numpy(store.t).cuda()
    return state, step, t_all


def step_ms(dtype: str, use_kernel: bool, store: FrameStore) -> float:
    """CUDA-event median of the steps of one epoch after a warm-up step
    (the plain path folds ERB's branches plainly too)."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.arange(TRAIN_FRAMES, device="cuda")
    times = []
    with plain_fold(not use_kernel):
        state, _ = step(state, store.gather(rows[:1]), t_all[:1])
        for i in range(TRAIN_FRAMES):
            r = rows[i : i + 1]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, store.gather(r), t_all[r])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def one_step_grads(dtype: str, use_kernel: bool, store: FrameStore):
    """Loss and gradients of one step from the seed-0 weights on frame 0
    (the plain path folds ERB's branches plainly too)."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.zeros(1, dtype=torch.long, device="cuda")
    with plain_fold(not use_kernel):
        _, aux = step(state, store.gather(rows), t_all[rows])
    grads = {k: p.grad.detach().float().clone() for k, p in state.model.named_parameters()}
    return aux["loss"].item(), grads


# kernel-name fragments -> the group a profiled CUDA kernel counts under
PROFILE_GROUPS = [
    ("K2 int8 stage", ("int8", "s8policy")),
    ("K1/K3 stage forward", ("stage_wgmma", "tensor_core::kernel", "cuda_core::kernel")),
    ("K4 epilogue backward", ("epilogue_bwd",)),
    ("K5 SSIM blur", ("blur_tiles",)),
    ("cuDNN conv (stage 0, dX/dW)", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad",
                                     "dgrad", "sm90_", "cutlass")),
    ("Adam", ("adam", "multi_tensor")),
]


OTHER_TOP = 14  # kernels of the "other" group listed by name


def profile_groups(run, n_iters: int) -> dict:
    """Device time of each kernel group per iteration, from a torch.profiler
    trace of ``n_iters`` calls of ``run(i)``."""
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d, trace(d) as rec:
        for i in range(n_iters):
            run(i)
    prof = rec.profiler
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other (elementwise, SSIM maps, stem, fusion)"] = 0.0
    total, n_kernels = 0.0, 0
    other = []  # (device us, launches, name) of the kernels no group claims
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        total += us
        n_kernels += e.count
        key = e.key.lower()
        for name, frags in PROFILE_GROUPS:
            if any(f.lower() in key for f in frags):
                groups[name] += us
                break
        else:
            groups["other (elementwise, SSIM maps, stem, fusion)"] += us
            other.append((us, e.count, e.key))
    other.sort(reverse=True)
    return {"groups_ms": {k: v / 1e3 / n_iters for k, v in groups.items() if v},
            "device_ms": total / 1e3 / n_iters, "kernels_per_step": n_kernels / n_iters,
            "other_top": [{"ms": us / 1e3 / n_iters, "launches": n / n_iters, "kernel": key[:90]}
                          for us, n, key in other[:OTHER_TOP]]}


def step_breakdown(dtype: str, use_kernel: bool, store: FrameStore, n_steps: int = 3) -> dict:
    """``profile_groups`` of ``n_steps`` training steps after a warm-up step
    (the plain path folds ERB's branches plainly too)."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.zeros(1, dtype=torch.long, device="cuda")

    def run(i):
        nonlocal state
        r = rows + i + 1
        state, _ = step(state, store.gather(r), t_all[r])

    with plain_fold(not use_kernel):
        state, _ = step(state, store.gather(rows), t_all[rows])
        return profile_groups(run, n_steps)


def decode_breakdown(decode_all, model, t_mat: torch.Tensor, label: str,
                     n_windows: int = 2) -> dict:
    """``profile_groups`` of ``n_windows`` decode windows (``decode_all(model,
    t_mat)``: the 32 frames of a throughput rep), the device's idle share
    of a window: 1 - device ms / the window's CUDA-event ms (unprofiled),
    and one more window's ``timeline``: its busy ms over the span from its
    first device event to its last (the card's own gaps, without the host's
    time before the first launch).  Empty when the profiler cannot trace
    the card."""
    decode_all(model, t_mat)
    try:
        bd = profile_groups(lambda i: decode_all(model, t_mat), n_windows)
    except RuntimeError as e:
        log(f"[serve] {label}: decode breakdown not measured ({e})")
        return {}
    if not bd["device_ms"]:
        log(f"[serve] {label}: decode breakdown not measured (no device time)")
        return {}
    bd["window_ms"] = cuda_ms(lambda: decode_all(model, t_mat))
    bd["idle_share"] = max(0.0, 1 - bd["device_ms"] / bd["window_ms"])
    with tempfile.TemporaryDirectory() as d:
        tl = timeline(lambda: decode_all(model, t_mat), d)
    bd["timeline"] = tl
    bd["span_idle_share"] = 1 - tl["busy_ms"] / tl["span_ms"]
    gap_us = 1e3 * (tl["span_ms"] - tl["busy_ms"]) / max(tl["kernels"] - 1, 1)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in bd["groups_ms"].items())
    log(f"[serve] {label}: a window of {t_mat.numel()} frames, device ms from torch.profiler: "
        f"{parts}; device total {bd['device_ms']:.3f} of {bd['window_ms']:.3f} ms (idle share "
        f"{bd['idle_share']:.3f}); {bd['kernels_per_step']:.0f} kernels a window; timeline of "
        f"one window: busy {tl['busy_ms']:.3f} of its {tl['span_ms']:.3f} ms span (idle "
        f"{bd['span_idle_share']:.3f}, {gap_us:.2f} us a gap between {tl['kernels']} kernels)")
    return bd


def single_frame_ms(decode, t_one: torch.Tensor, warmup: int = 5, reps: int = 50) -> float:
    """ms a one-frame decode, each ended by a synchronize after ``warmup``
    decodes (``eval_main.measure_micro_fps``'s protocol)."""
    for _ in range(warmup):
        decode(t_one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        decode(t_one)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _k12_routes(counts) -> dict:
    """{"K1": {route: n}, "K2": {route: n}} of a ``launches`` record, used routes only."""
    out = {}
    for key, mod in (("K1", "decode"), ("K2", "decode_int8")):
        routes = counts[f"repnerv_tpu_torch.kernels.{mod}", "ROUTE_LAUNCHES"]
        out[key] = {r: n for r, n in routes.items() if n}
    return out


def _per_batch(routes: dict, n: int) -> dict:
    return {k: {r: v / n for r, v in d.items()} for k, d in routes.items()}


def serve_graph_vs_eager(model, name: str) -> dict:
    """The graph decode (``make_video_decode_fn``: one CUDA graph replay a
    batch) against the eager one (``decode_video``) on ``model``: frames to
    the bit (cuDNN deterministic), K1 / K2 launches a replayed batch by
    route against an eager batch's, a recapture after a change in place
    (the last block's weight, or under int8 its packed scale) against the eager
    decode of the new weights; then in turns (eager, graph, graph, eager)
    fps of the 32 frames at batch 8 (``time_decode``: the fastest of 3 reps
    after a warm-up), the device's idle share in the decode window
    (torch.profiler through ``trace``, the first turn of each path) and the
    batch-1 latency."""
    cfg = TrainConfig(model=model.cfg)
    dev = torch.device("cuda", 0)
    t_mat = torch.from_numpy(decode_time_batches(np.arange(SERVE_FRAMES) / SERVE_FRAMES,
                                                 SERVE_BATCH)).to(dev)
    n_batches = t_mat.shape[0]
    saved = _deterministic(True)
    try:
        before = kernel_launches.snapshot()
        decode_video(model, cfg, t_mat[:1])
        eager_batch = _k12_routes(kernel_launches.since(before))
        eager = decode_video(model, cfg, t_mat)
        run = make_video_decode_fn(cfg)
        first = run(model, t_mat)  # the eager first batch, the capture, 3 replays
        before = kernel_launches.snapshot()
        again = run(model, t_mat)  # replays only
        replay_batch = _per_batch(_k12_routes(kernel_launches.since(before)), n_batches)
        equal = [torch.equal(first, eager), torch.equal(again, eager)]
        del first, again
        # a change in place of what the last block's kernel reads (its weight,
        # or under int8 its table's packed scale): the key moves, the next
        # decode captures again
        q = model.int8.get(str(len(model.layers) - 1))
        w = model.layers[-1].rbr_reparam.weight if q is None else q.packed.scale
        kept = w.detach().clone()
        with torch.no_grad():
            w.mul_(1.25)
        changed = run(model, t_mat)
        recapture_equal = torch.equal(changed, decode_video(model, cfg, t_mat))
        moved = not torch.equal(changed, eager)
        captures = run.captures
        with torch.no_grad():
            w.copy_(kept)
        del run, changed, eager
    finally:
        _deterministic(saved)
    log(f"[serve-graph] {name}: graph frames vs eager frames equal bits {equal} (two calls of one "
        f"decode, {n_batches} batches of {SERVE_BATCH}); launches an eager batch {eager_batch}, "
        f"a replayed batch {replay_batch}; after a change in place of the last block's "
        f"{'int8 scale' if q is not None else 'weight'}: {captures} captures, frames equal to the "
        f"eager decode of the new weights {recapture_equal} (moved {moved})")
    if not all(equal):
        raise AssertionError(f"{name}: the graph decode's frames differ from the eager decode's")
    if replay_batch != _per_batch(eager_batch, 1):
        raise AssertionError(f"{name}: a replayed batch counted {replay_batch}, an eager batch "
                             f"launched {eager_batch}")
    if captures != 2 or not recapture_equal or not moved:
        raise AssertionError(f"{name}: after a change in place: {captures} captures, equal to "
                             f"the eager decode {recapture_equal}, moved {moved}")

    def eager_all(m, t):
        return decode_video(m, cfg, t, keep_frames=False)

    one = make_decode_fn(cfg)
    turns = {"eager": [], "graph": []}
    for path in ("eager", "graph", "graph", "eager"):
        decode_all = eager_all if path == "eager" else make_video_decode_fn(cfg, keep_frames=False)
        times, sums = time_decode(decode_all, model, t_mat)
        single = (single_frame_ms(lambda t: decode_batch(model, cfg, t), t_mat[0, :1])
                  if path == "eager" else single_frame_ms(lambda t: one(model, t), t_mat[0, :1]))
        row = {"fps": t_mat.numel() / min(times), "window_ms": 1e3 * min(times),
               "single_frame_ms": single}
        if not turns[path]:
            row["profile"] = decode_breakdown(decode_all, model, t_mat, f"{name} {path}")
        turns[path].append(row)
        if not bool(torch.isfinite(sums).all()):
            raise AssertionError(f"{name} {path}: non-finite checksums")
        del decode_all
        torch.cuda.empty_cache()
    res = {"frames_equal_bits": all(equal), "recapture_equal_bits": recapture_equal,
           "eager_batch_launches": eager_batch, "replay_batch_launches": replay_batch}
    for path, rows in turns.items():
        prof = rows[0]["profile"]
        res[path] = {"fps": statistics.mean(r["fps"] for r in rows),
                     "fps_runs": [r["fps"] for r in rows],
                     "single_frame_ms": statistics.mean(r["single_frame_ms"] for r in rows),
                     "single_frame_ms_runs": [r["single_frame_ms"] for r in rows],
                     "idle_share": prof.get("idle_share"), "device_ms": prof.get("device_ms"),
                     "span_idle_share": prof.get("span_idle_share"), "profile": prof}
        idle = ("not measured" if prof.get("idle_share") is None
                else f"{prof['idle_share']:.4f} ({prof['device_ms']:.3f} device ms of "
                     f"{prof['window_ms']:.3f})")
        log(f"[serve-graph] {name} {path}: fps {res[path]['fps']:.2f} ("
            + ", ".join(f"{x:.2f}" for x in res[path]["fps_runs"])
            + f"; {SERVE_FRAMES} frames at batch {SERVE_BATCH}, fastest of {DECODE_REPS} reps); "
            f"idle share of the decode window {idle}; batch-1 latency "
            f"{res[path]['single_frame_ms']:.4f} ms ("
            + ", ".join(f"{x:.4f}" for x in res[path]["single_frame_ms_runs"]) + ")")
    res["graph_over_eager_fps"] = res["graph"]["fps"] / res["eager"]["fps"]
    return res


def phase_train(tmp: str) -> dict:
    eval_counts = {}
    evaluate = train_main.evaluate

    def counted_evaluate(*args, **kwargs):
        # keep the eval's launches apart from the training steps'
        before = launch_counts()
        out = evaluate(*args, **kwargs)
        for k, v in launch_counts().items():
            eval_counts[k] = eval_counts.get(k, 0) + v - before[k]
        return out

    results = {}
    steps = TRAIN_FRAMES * TRAIN_EPOCHS
    cwd = os.getcwd()
    train_main.evaluate = counted_evaluate
    try:
        for dtype in ("bfloat16", "float32", "mixed"):
            per_step = PER_STEP_MIXED if dtype == "mixed" else PER_STEP
            eval_counts.clear()
            os.chdir(tmp)  # train_main writes under result/<outf>
            try:
                reset_counts()  # the main path's run starts here
                t0 = time.perf_counter()
                # the bf16 run also measures the decode fps at every eval (--eval_fps)
                extra = ["--eval_fps"] if dtype == "bfloat16" else []
                with EpochRecorder() as rec:
                    res = train_main.main(TRAIN_ARGV + extra
                                          + ["--compute_dtype", dtype, "--outf", dtype])
                wall = time.perf_counter() - t0
                counts = launch_counts()  # ... and ends here
                routes = dict(tt.FWD_ROUTE_LAUNCHES)
                outf = os.path.abspath(res["outf"])
            finally:
                os.chdir(cwd)
            n_eval = TRAIN_EPOCHS * TRAIN_FRAMES  # every epoch is one of the last 10: all eval
            train_counts = {k: counts[k] - eval_counts.get(k, 0) for k in per_step}
            log(f"[train] {dtype}: train_main {TRAIN_EPOCHS} epochs x {TRAIN_FRAMES} steps in "
                f"{wall:.1f} s; launches {counts}; in the training steps {train_counts} "
                f"(expect {({k: v * steps for k, v in per_step.items()})}), in the eval "
                f"{ {k: eval_counts.get(k, 0) for k in per_step} }")
            for k in per_step:
                if train_counts[k] != per_step[k] * steps:
                    raise AssertionError(f"{k}: {train_counts[k]} launches in {steps} steps, "
                                         f"expected {per_step[k]} per step")
                if eval_counts.get(k, 0) != PER_EVAL_FRAME[k] * n_eval:
                    raise AssertionError(f"{k}: {eval_counts.get(k, 0)} launches in the eval of "
                                         f"{n_eval} frames, expected {PER_EVAL_FRAME[k]} each")
            # blocks 2-4 (Cin 96) on the type's wgmma kernel, block 1 (Cin 26) on WMMA / FMA
            want = dict.fromkeys(dk.ROUTES, 0)
            if dtype != "mixed":
                want.update({"wmma": steps, "wgmma": 3 * steps} if dtype == "bfloat16"
                            else {"fma": steps, "wgmma_tf32x3": 3 * steps})
            log(f"[train] {dtype}: K3 launches by route {routes} (expect {want})")
            if routes != want:
                raise AssertionError(f"{dtype}: K3 launches by route {routes}, expected {want}")
            hist = res["history"]
            for h in hist:
                log(f"[train] {dtype}: epoch {h['epoch']} loss {h['loss']:.6f} lr {h['lr']:.3e} "
                    f"PSNR {h['psnr'][-1]:.4f} MS-SSIM {h['msssim'][-1]:.4f}")
            if not all(np.isfinite(h["loss"]) and np.isfinite(h["psnr"][-1]) for h in hist):
                raise AssertionError("non-finite loss or PSNR")
            if not hist[-1]["psnr"][-1] > hist[0]["psnr"][-1]:
                raise AssertionError("PSNR did not rise from epoch 1 to epoch 2")
            for name in ("model_latest.pth", "model_latest_deploy.pth", "resume_latest.pt"):
                if not os.path.exists(os.path.join(outf, name)):
                    raise AssertionError(f"train_main wrote no {name}")
            with open(os.path.join(outf, "rank0.txt")) as f:
                fps_lines = [float(line.split()[1]) for line in f if line.startswith("FPS: ")]
            want_fps = TRAIN_EPOCHS if dtype == "bfloat16" else 0  # every epoch evaluates
            log(f"[train] {dtype}: rank0.txt FPS lines {fps_lines} (expect {want_fps})")
            if len(fps_lines) != want_fps or not all(np.isfinite(v) and v > 0 for v in fps_lines):
                raise AssertionError(f"{dtype}: --eval_fps wrote {fps_lines} to rank0.txt")
            check_fold_counts(f"train_main {dtype}", rec.epoch_fns(), eval_counts, n_eval)
            results[dtype] = {"launches": counts, "train_launches": train_counts,
                              "eval_fps": fps_lines,
                              "route_launches": routes,
                              "eval_launches": dict(eval_counts), "history": hist,
                              "wall_s": wall}
            del res
            torch.cuda.empty_cache()
    finally:
        train_main.evaluate = evaluate

    video, t = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    store = FrameStore(frames=torch.from_numpy(video).cuda(), t=t)
    for dtype in ("bfloat16", "float32"):
        loss_k, g_k = one_step_grads(dtype, True, store)
        loss_p, g_p = one_step_grads(dtype, False, store)
        rel = {k: ((g_k[k] - g_p[k]).abs().max() / g_p[k].abs().max().clamp_min(1e-30)).item()
               for k in g_p}
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        loss_tol, grad_tol = STEP_TOL[dtype]
        ok = loss_rel <= loss_tol and rel[worst] <= grad_tol and np.isfinite(loss_k)
        log(f"[train] {dtype}: one step kernel path vs --no_pallas_train: loss {loss_k:.7f} vs "
            f"{loss_p:.7f} (rel {loss_rel:.2e}, tol {loss_tol:g}); max relative grad diff "
            f"{rel[worst]:.3e} at {worst} (tol {grad_tol:g}); median over params "
            f"{statistics.median(rel.values()):.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel path and library path differ in one {dtype} step")
        results[dtype].update({"step_loss": loss_k, "step_loss_plain": loss_p,
                               "step_max_rel_grad_diff": rel[worst], "step_worst_param": worst})
        del g_k, g_p
        torch.cuda.empty_cache()
        # plain, kernel, kernel, plain: the two orders' medians
        order = [False, True, True, False]
        ms = {True: [], False: []}
        for use_kernel in order:
            ms[use_kernel].append(step_ms(dtype, use_kernel, store))
            torch.cuda.empty_cache()
        k_ms, p_ms = statistics.mean(ms[True]), statistics.mean(ms[False])
        log(f"[train] {dtype}: ms per -b 1 train step (CUDA-event median of {TRAIN_FRAMES} "
            f"steps after a warm-up, mean of 2 runs): kernel path {k_ms:.3f} "
            f"({', '.join(f'{v:.3f}' for v in ms[True])}), --no_pallas_train {p_ms:.3f} "
            f"({', '.join(f'{v:.3f}' for v in ms[False])})")
        results[dtype].update({"step_ms": k_ms, "step_plain_ms": p_ms})
        for use_kernel, wall in ((True, k_ms), (False, p_ms)):
            path = "kernel path" if use_kernel else "--no_pallas_train"
            try:
                bd = step_breakdown(dtype, use_kernel, store)
            except RuntimeError as e:  # the profiler could not trace the card here
                log(f"[train] {dtype}: {path} step breakdown not measured ({e})")
                continue
            if not bd["device_ms"]:
                log(f"[train] {dtype}: {path} step breakdown not measured (no device time)")
                continue
            # idle share: the device's idle part of the unprofiled step time
            bd["idle_share"] = 1 - bd["device_ms"] / wall
            parts = ", ".join(f"{k} {v:.3f}" for k, v in bd["groups_ms"].items())
            log(f"[train] {dtype}: {path} step, device ms from torch.profiler: {parts}; device "
                f"total {bd['device_ms']:.3f} of {wall:.3f} ms per step (idle share "
                f"{bd['idle_share']:.3f}); {bd['kernels_per_step']:.0f} kernels per step")
            log(f"[train] {dtype}: {path} step, the largest of 'other' (ms, launches a step): "
                + "; ".join(f"{o['ms']:.3f} x{o['launches']:.0f} {o['kernel']}"
                            for o in bd["other_top"]))
            results[dtype]["breakdown" if use_kernel else "breakdown_plain"] = bd
            torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32", "mixed"):
        results[dtype]["graph"] = graph_vs_eager(dtype, store)
        results[dtype]["step_graph"] = step_graph_vs_eager(dtype, store)
    for dtype in ("bfloat16", "float32"):
        # the training model's eval forward stays on the library convs: K5 only
        model = init_train_state(_train_cfg(dtype, True), "cuda", seed=SEED).model
        results[dtype]["eval_graph"] = eval_graph_vs_eager(model, f"train {dtype}", store,
                                                           {**PER_EVAL_FRAME,
                                                            **FOLD_PER_EVAL_FRAME})
        del model
        torch.cuda.empty_cache()
    return results


def eager_losses(cfg: TrainConfig, store: FrameStore, rows: np.ndarray) -> torch.Tensor:
    """Per-step losses of the eager step over ``rows`` from the seed's weights."""
    return step_losses(build_train_step_fn, cfg, store, rows)[0]


def step_losses(make, cfg: TrainConfig, store: FrameStore, rows: np.ndarray):
    """Per-step losses and PSNR rows of ``make``'s step function over ``rows``
    from the seed's weights; and the state and the step function."""
    state = init_train_state(cfg, "cuda", seed=SEED)
    step = make(cfg, TRAIN_FRAMES, with_msssim=True)
    t_all = torch.from_numpy(store.t).cuda()
    losses, psnrs = [], []
    for r in torch.from_numpy(rows).cuda():
        state, aux = step(state, store.gather(r), t_all[r])
        losses.append(aux["loss"])
        psnrs.append(aux["psnr"])
    return torch.stack(losses).cpu(), torch.stack(psnrs).cpu(), state, step


# the training paths that [graph] and [step-graph] time: (what makes the step
# or epoch function, what drives it)
STEP_PATHS = {"eager": (build_train_step_fn, run_epoch),
              "graph": (make_epoch_fn, run_fused_epoch),
              "step-graph": (make_train_step, run_epoch)}


def epoch_step_ms(path: str, cfg: TrainConfig, store: FrameStore, profile: bool) -> dict:
    """ms per step of an epoch of ``STEP_PATHS[path]`` (CUDA events around the
    whole epoch, its metrics fetch included, over the steps) after a first
    epoch (on a graph path: the eager step and the capture); with ``profile``
    also the device time per step of a third epoch from torch.profiler, and
    the idle share."""
    state = init_train_state(cfg, "cuda", seed=SEED)
    make, run = STEP_PATHS[path]
    fn = make(cfg, TRAIN_FRAMES, with_msssim=True)
    state, _ = run(state, fn, store, cfg, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = run(state, fn, store, cfg, 1)
    end.record()
    end.synchronize()
    out = {"ms": start.elapsed_time(end) / TRAIN_FRAMES}
    if profile:
        try:
            bd = profile_groups(lambda i: run(state, fn, store, cfg, 2), 1)
        except RuntimeError as e:  # the profiler could not trace the card here
            log(f"[graph] profile not measured ({e})")
            return out
        out["device_ms"] = bd["device_ms"] / TRAIN_FRAMES
        out["kernels_per_step"] = bd["kernels_per_step"] / TRAIN_FRAMES
        out["idle_share"] = 1 - out["device_ms"] / out["ms"]
    return out


def graph_vs_eager(dtype: str, store: FrameStore) -> dict:
    """The fused epoch (one CUDA graph replay per step) against the eager
    step, on the kernel path from the seed's weights: per-step losses over
    the 16 steps of epoch 1 (graph: the eager first step, the capture, 15
    replays), the launches of an epoch of replays only, and ms per step of
    both, in turns (eager, graph, graph, eager)."""
    cfg = _train_cfg(dtype, True)
    rows = epoch_rows(store, cfg, 0)
    # cuDNN's deterministic dX / dW algorithms for the three trajectories
    # (the capture picks its algorithms under the same flag): eager vs eager
    # is then the same sum order, and graph vs eager tests the graph alone
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = eager_losses(cfg, store, rows)
        again = eager_losses(cfg, store, rows)
        state = init_train_state(cfg, "cuda", seed=SEED)
        epoch_fn = make_epoch_fn(cfg, TRAIN_FRAMES, with_msssim=True)
        state, aux = epoch_fn(state, store, rows, None)
    finally:
        torch.backends.cudnn.deterministic = saved
    graph = aux["loss"].cpu()
    rel = ((graph - eager).abs() / eager.abs()).max().item()
    rel_eager = ((again - eager).abs() / eager.abs()).max().item()
    ok = rel <= GRAPH_TOL[dtype] and bool(torch.isfinite(graph).all())
    log(f"[graph] {dtype}: per-step losses over {TRAIN_FRAMES} steps, graph vs eager: largest "
        f"relative difference {rel:.3e} (tol {GRAPH_TOL[dtype]:g}; eager vs eager {rel_eager:.3e}); "
        f"equal bits {torch.equal(graph, eager)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{dtype}: the graph step and the eager step differ by {rel}")
    reset_counts()  # an epoch of replays only starts here
    state, _ = run_fused_epoch(state, epoch_fn, store, cfg, 1)
    counts = launch_counts()  # ... and ends here
    per_step = PER_STEP_MIXED if dtype == "mixed" else PER_STEP
    want = {k: v * TRAIN_FRAMES for k, v in per_step.items()}
    log(f"[graph] {dtype}: launches in an epoch of {TRAIN_FRAMES} replayed steps "
        f"{ {k: counts[k] for k in want} } (expect {want})")
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{dtype}: {counts} launches in {TRAIN_FRAMES} replays")
    del state, epoch_fn, aux
    torch.cuda.empty_cache()
    runs = {True: [], False: []}
    for graph_path in (False, True, True, False):
        first = not runs[graph_path]
        runs[graph_path].append(epoch_step_ms("graph" if graph_path else "eager", cfg, store,
                                              profile=first))
        torch.cuda.empty_cache()
    res = {"max_rel_loss_diff": rel, "eager_max_rel_loss_diff": rel_eager,
           "equal_bits": torch.equal(graph, eager), "replay_launches": counts}
    for graph_path, name in ((False, "eager"), (True, "graph")):
        r = runs[graph_path]
        res[name] = {"ms": statistics.mean(x["ms"] for x in r), "runs_ms": [x["ms"] for x in r],
                     **{k: v for k, v in r[0].items() if k != "ms"}}
        prof = r[0]
        extra = (f"; device {prof['device_ms']:.3f} ms a step (idle share {prof['idle_share']:.3f}), "
                 f"{prof['kernels_per_step']:.1f} kernels a step (torch.profiler)"
                 if "device_ms" in prof else "; device time not measured")
        log(f"[graph] {dtype}: {name} step {res[name]['ms']:.3f} ms "
            f"({', '.join(f'{x:.3f}' for x in res[name]['runs_ms'])}: CUDA events around an epoch "
            f"of {TRAIN_FRAMES} steps, its metrics fetch included, over the steps){extra}")
    return res


def step_graph_vs_eager(dtype: str, store: FrameStore) -> dict:
    """``make_train_step``'s graph step (one CUDA graph replay a call, as
    ``run_epoch`` drives it in ``train_main --profile`` and the per-step
    path) against the eager step (``build_train_step_fn``) on the kernel
    path from the seed's weights: per-step losses and PSNR rows over the 16
    steps of epoch 1 to the bit (cuDNN deterministic; graph: the eager first
    step, the capture, 15 replays), the launches of an epoch of replays,
    and ms per step of both in turns (eager, graph, graph, eager)."""
    cfg = _train_cfg(dtype, True)
    rows = epoch_rows(store, cfg, 0)
    saved = _deterministic(True)
    try:
        eager, eager_psnr, _, _ = step_losses(build_train_step_fn, cfg, store, rows)
        graph, graph_psnr, state, step = step_losses(make_train_step, cfg, store, rows)
    finally:
        _deterministic(saved)
    equal = torch.equal(graph, eager) and torch.equal(graph_psnr, eager_psnr)
    log(f"[step-graph] {dtype}: per-step losses and PSNR over {TRAIN_FRAMES} steps, "
        f"make_train_step's graph step vs the eager step: equal bits {equal} (largest loss "
        f"difference {(graph - eager).abs().max().item():.3e}); {step.captures} capture")
    if not equal or step.captures != 1:
        raise AssertionError(f"{dtype}: the graph step differs from the eager step "
                             f"({step.captures} captures)")
    reset_counts()  # an epoch of replays only starts here
    state, _ = run_epoch(state, step, store, cfg, 1)
    counts = launch_counts()  # ... and ends here
    per_step = PER_STEP_MIXED if dtype == "mixed" else PER_STEP
    want = {k: v * TRAIN_FRAMES for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    log(f"[step-graph] {dtype}: launches in an epoch of {TRAIN_FRAMES} replayed steps {got} "
        f"(expect {want}: {per_step} a step); captures {step.captures}")
    if got != want or step.captures != 1:
        raise AssertionError(f"{dtype}: {got} launches in {TRAIN_FRAMES} replayed steps, "
                             f"{step.captures} captures")
    del state, step
    torch.cuda.empty_cache()
    runs = {"eager": [], "step-graph": []}
    for path in ("eager", "step-graph", "step-graph", "eager"):
        runs[path].append(epoch_step_ms(path, cfg, store, profile=not runs[path]))
        torch.cuda.empty_cache()
    res = {"equal_bits": equal, "replay_launches": got}
    for path, r in runs.items():
        res[path] = {"ms": statistics.mean([x["ms"] for x in r]), "runs_ms": [x["ms"] for x in r],
                     **{k: v for k, v in r[0].items() if k != "ms"}}
        prof = r[0]
        extra = (f"; device {prof['device_ms']:.3f} ms a step (idle share "
                 f"{prof['idle_share']:.3f}) (torch.profiler)" if "device_ms" in prof
                 else "; device time not measured")
        log(f"[step-graph] {dtype}: {path} step {res[path]['ms']:.3f} ms ("
            + ", ".join(f"{x:.3f}" for x in res[path]["runs_ms"])
            + f": CUDA events around a run_epoch of {TRAIN_FRAMES} steps, over the steps){extra}")
    return res


def eval_graph_vs_eager(model, name: str, store: FrameStore, per_frame: dict) -> dict:
    """``make_eval_step``'s graph (one CUDA graph replay a batch) against the
    eager eval step (``build_eval_step_fn``) on ``model`` over ``store``'s
    frames at -b 1 with MS-SSIM, as train_main's sweep runs them: per-frame
    PSNR and MS-SSIM to the bit (cuDNN deterministic), launches a replayed
    batch against an eager batch's and ``per_frame``, the graph pool's size;
    then seconds of ``evaluate``'s sweep in turns (eager, graph, graph,
    eager), the graph with a fresh step a turn: its first sweep (the eager
    batch, the capture and the replays; train_main captures once a sweep)
    and its second (replays only)."""
    cfg = TrainConfig(model=model.cfg, data=DataConfig(batch_size=1))
    n = store.num_samples
    t_all = torch.from_numpy(np.asarray(store.t, np.float32)).cuda()

    def sweep(fn):
        psnr, msssim = [], []
        for i in range(n):
            r = torch.arange(i, i + 1, device="cuda")
            _, aux = fn(model, store.gather(r), t_all[r])
            psnr.append(aux["psnr"])
            msssim.append(aux["msssim"])
        return torch.cat(psnr).cpu(), torch.cat(msssim).cpu()

    saved = _deterministic(True)
    try:
        eager_fn = build_eval_step_fn(cfg, True)
        before = launch_counts()
        ref = sweep(eager_fn)
        eager_frame = {k: (v - before[k]) / n for k, v in launch_counts().items()}
        step = make_eval_step(cfg, True)
        first = sweep(step)  # the eager first batch, the capture, the replays
        before = launch_counts()
        again = sweep(step)  # replays only
        replay_frame = {k: (v - before[k]) / n for k, v in launch_counts().items()}
    finally:
        _deterministic(saved)
    equal = [all(torch.equal(a, b) for a, b in zip(got, ref)) for got in (first, again)]
    want = {k: float(per_frame.get(k, 0)) for k in eager_frame}
    log(f"[eval-graph] {name}: per-frame PSNR and MS-SSIM of {n} frames at -b 1, graph vs eager "
        f"eval step: equal bits {equal} (two sweeps of one step, {step.captures} capture); "
        f"launches a frame: eager {eager_frame}, replayed {replay_frame} (expect {want}); the "
        f"graph's pool {step.pool_bytes / 2**20:.1f} MiB")
    if not all(equal) or step.captures != 1:
        raise AssertionError(f"{name}: the eval graph's metrics differ from the eager step's "
                             f"({step.captures} captures)")
    if replay_frame != want or eager_frame != want:
        raise AssertionError(f"{name}: launches a frame eager {eager_frame}, replayed "
                             f"{replay_frame}, expected {want}")
    pool = step.pool_bytes
    del step
    torch.cuda.empty_cache()
    turns = {"eager": [], "graph": [], "graph_replays": []}
    for path in ("eager", "graph", "graph", "eager"):
        fn = eager_fn if path == "eager" else make_eval_step(cfg, True)
        for key in (("eager",) if path == "eager" else ("graph", "graph_replays")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            psnr, _ = evaluate(model, fn, store, cfg)  # ends with its one fetch
            turns[key].append(time.perf_counter() - t0)
            if not np.isfinite(psnr).all():
                raise AssertionError(f"{name} {path}: non-finite sweep PSNR {psnr}")
        del fn
    res = {"equal_bits": all(equal), "eager_launches_a_frame": eager_frame,
           "replay_launches_a_frame": replay_frame, "pool_bytes": pool}
    for key, r in turns.items():
        res[key] = {"ms_a_frame": 1e3 * statistics.mean(r) / n, "runs_s": r}
    log(f"[eval-graph] {name}: ms a frame of evaluate's {n}-frame sweep in turns (eager, graph, "
        f"graph, eager): eager {res['eager']['ms_a_frame']:.3f} ("
        + ", ".join(f"{x:.4f} s" for x in turns["eager"])
        + f"), graph with its capture {res['graph']['ms_a_frame']:.3f} ("
        + ", ".join(f"{x:.4f} s" for x in turns["graph"])
        + f"), graph replays only {res['graph_replays']['ms_a_frame']:.3f} ("
        + ", ".join(f"{x:.4f} s" for x in turns["graph_replays"]) + ")")
    return res


# int8 stages of the flagship decode (int8_from_block -2: blocks 3 and 4 +
# head), (name, H, W, Cin, C, stride, head); the stride-5 stage-0 shape
# (Cin 26: byte copies) is checked for the general case
INT8_SHAPES = [
    ("block3", 180, 320, 96, 96, 2, False),
    ("block4+head", 360, 640, 96, 96, 2, True),
    ("stride5", 9, 16, 26, 26, 5, False),
]
INT8_MAIN_PATH_SHAPES = ("block3", "block4+head")
# int8 out: kernel and plain version sum the same integer products exactly
# and run the same f32 epilogue with one rounding per operation; only the
# activation's expf (a few ulps apart) can move a value across a .5
# boundary: within 1 count, under 1e-3 of the values differing.  Head out:
# the 1x1 head sums C = 96 f32 products in another order, the squash's slope
# is <= 1/2: 1e-5.  On an H100 the largest reading over 8 seeds at these
# inputs was 2.98e-7, and 2.3e-6 with head weights sqrt(C) times larger.
INT8_FRAC = 1e-3
INT8_HEAD_ATOL = 1e-5


def int8_wmma_run(x_q: torch.Tensor, p, out: torch.Tensor):
    """A call of the WMMA kernel of csrc/decode_int8.cu (route 0 of the C
    entry) at a shape that the port sends to the wgmma kernel.  A measurement
    of this script only; the port's wrapper takes no route."""
    lib = build.load_library()
    ptr = ctypes.c_void_p
    bsz, h, w, cin = x_q.shape
    args = [k8.ROUTES.index("wmma"), ptr(x_q.data_ptr()), ptr(p.w.data_ptr()), ptr(None),
            ptr(p.scale.data_ptr()), ptr(p.b.data_ptr()),
            ptr(None if p.c_final else p.inv_out.data_ptr()),
            ptr(p.head_w.data_ptr() if p.c_final else None),
            ptr(p.head_b.data_ptr() if p.c_final else None), ptr(out.data_ptr()),
            bsz, h, w, cin, p.c, p.stride, dk.ACT_CODES["swish"], p.c_final, 0]

    def run():
        err = lib.repnerv_fused_conv_ps_act_int8(*args, ptr(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"int8 WMMA kernel launch failed: cudaError {err}")

    return run


def bf16_stage_ms(bsz, h, w, cin, c, s, head, g) -> float:
    """The bf16 stage kernel's time at a shape of the int8 decode, on random
    operands: what the same stage costs without quantization."""
    dev = torch.device("cuda", 0)
    x = torch.randn(bsz, h, w, cin, generator=g).to(dev).bfloat16()
    wt = (torch.randn(3, 3, cin, c * s * s, generator=g) * (9 * cin) ** -0.5).to(dev)
    hw = (torch.randn(1, 1, c, 3, generator=g) * c**-0.5).to(dev) if head else None
    p = dk.pack_weights(wt, None, s, torch.bfloat16, head_w=hw)
    return cuda_ms(lambda: dk.decode_stage(x, p, "swish", "tanh"))


def phase_int8_kernel() -> list:
    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)
    rows = []
    for name, h, w, cin, c, s, head in INT8_SHAPES:
        cout = c * s * s
        # activations and weights quantized by the scheme itself, as a
        # calibration would: the dequantized sums are O(1)
        x = torch.randn(SERVE_BATCH, h, w, cin, generator=g).to(dev)
        wt = (torch.randn(3, 3, cin, cout, generator=g) * (9 * cin) ** -0.5).to(dev)
        b = (torch.randn(cout, generator=g) * 0.1).to(dev)
        sx = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
        x_q = k8.quantize_act_int8(x, sx)
        w_q, sw = k8.quantize_weight_int8(wt)
        if head:
            hw = ((torch.rand(1, 1, c, 3, generator=g) * 2 - 1) * c**-0.5).to(dev)
            hb = ((torch.rand(3, generator=g) * 2 - 1) * c**-0.5).to(dev)
            p = k8.pack_int8_stage(w_q, sx * sw, b, s, head_w=hw, head_b=hb)
        else:
            # swish of an O(1) sum: ~6 is the largest over a batch
            p = k8.pack_int8_stage(w_q, sx * sw, b, s,
                                   out_scale=torch.tensor(6.0 / 127, device=dev))
        del x, wt
        out = k8.decode_stage_int8(x_q, p, "swish", "tanh")
        ref = k8.decode_stage_int8_reference(x_q, p, "swish", "tanh")
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if head:
            frac = 0.0
            tol = f"{INT8_HEAD_ATOL:g}"
            ok = err <= INT8_HEAD_ATOL and bool(torch.isfinite(out).all())
        else:
            frac = (diff > 0).float().mean().item()
            tol = f"1 count, under {INT8_FRAC:g} of values differing"
            ok = err <= 1 and frac < INT8_FRAC
        ms = cuda_ms(lambda: k8.decode_stage_int8(x_q, p, "swish", "tanh"))
        plain_ms = cuda_ms(lambda: k8.decode_stage_int8_reference(x_q, p, "swish", "tanh"))
        beside = {}
        if p.route == "wgmma":
            # the WMMA kernel (this shape's kernel before the wgmma one) and
            # the bf16 wgmma kernel on the same shape, in the same run
            old = torch.empty_like(out)
            beside["wmma_ms"] = cuda_ms(int8_wmma_run(x_q, p, old))
            torch.cuda.synchronize()
            beside["wmma_max_abs_err"] = (old.float() - ref.float()).abs().max().item()
            beside["bf16_kernel_ms"] = bf16_stage_ms(SERVE_BATCH, h, w, cin, c, s, head, g)
        # bound: the conv's operations on the int8 tensor cores (the head's
        # f32 product is 0.3% of them) against the int8 input, the weights
        # and the output crossing device memory once
        bound = roofline(stage_ops(SERVE_BATCH, h, w, cin, c, s, 3 if head else 0),
                         x_q.numel() + 9 * cin * cout + nbytes(out), "int8")
        log(f"[int8-kernel] {name:12s} x_q[{SERVE_BATCH},{h},{w},{cin}] s={s} -> "
            f"{list(out.shape)} {str(out.dtype).replace('torch.', '')}: max|d|={err:.3e}, "
            f"share differing {frac:.3e} (tol {tol}) {p.route} kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']})"
            + (f", WMMA kernel {beside['wmma_ms']:.3f} ms with max|d|="
               f"{beside['wmma_max_abs_err']:.3e}, bf16 wgmma kernel on this shape "
               f"{beside['bf16_kernel_ms']:.3f} ms" if beside else "")
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {name}")
        rows.append({"shape": name, "route": p.route, "in": [SERVE_BATCH, h, w, cin],
                     "out": list(out.shape), "max_abs_err": err, "share_differing": frac,
                     "tol": tol, "ms": ms, "plain_ms": plain_ms, **bound, **beside})
        del x_q, out, ref, diff, p
        torch.cuda.empty_cache()
    return rows


# the compress CLI on phase 6's bf16 run (its flags, its output directory)
EVAL_ARGV = TRAIN_ARGV + ["--compute_dtype", "bfloat16", "--outf", "bfloat16"]
PRUNE, QBIT = 0.2, 8
PATH_B = ["--prune_ratio", str(PRUNE), "--quant_bit", str(QBIT), "--save_bitstream"]
COMPRESS_RUNS = [
    # (name, extra flags, result file, finetune epochs, pruned)
    ("path-b", PATH_B, f"only_prune{PRUNE:.2f}_quant{QBIT}.txt", 0, True),
    ("path-b-int8", PATH_B + ["--decode_int8"], f"only_prune{PRUNE:.2f}_quant{QBIT}.txt", 0, True),
    ("path-a", ["--prune_ratio", str(PRUNE), "--quant_bit", str(QBIT), "--finetune",
                "--finetune_epochs", "1"], f"finetune_e1_pr{PRUNE:.2f}_q{QBIT}.txt", 1, True),
    ("qat", ["--finetune", "--qat", "--finetune_epochs", "1", "--quant_bit", str(QBIT)],
     f"finetune_qat_e1_pr1.00_q{QBIT}.txt", 1, False),
]
# the int8 decode against the bf16 decode of the same weights, in val PSNR
# (dB); the JAX package's record on its trained flagship is -0.36 dB.  On
# the 2-epoch model (~10 dB) this bound cannot catch a wrong int8 path: the
# int8 Generator path is held on the card by the serving check below, which
# compares its frames with the plain versions of K1 and K2 on the same tables.
INT8_PSNR_BOUND = 0.5
# served int8 frames, kernel path vs the plain versions of K1 and K2 with
# the same tables: blocks 1-2 in bf16 differ as phase 4's bf16 frames do
# (the plain path's extra bf16 roundings), which can move a block-3 input
# count across a .5 boundary, and K2's expf ulps can move a requantized
# count; the squash's slope <= 1/2 bounds what a count moves
SERVE_INT8_ATOL = SERVE_BF16_ATOL


def _eval_run(tmp: str, extra: list) -> tuple:
    cwd = os.getcwd()
    os.chdir(tmp)  # eval_main reads and writes under result/<outf>
    try:
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        eval_main.main(EVAL_ARGV + extra)
        wall = time.perf_counter() - t0
        counts = launch_counts()  # ... and ends here
    finally:
        os.chdir(cwd)
    return counts, wall


def phase_compress(tmp: str) -> dict:
    outf = os.path.join(tmp, "result", "bfloat16")
    rnvb = os.path.join(outf, f"model_pr{PRUNE:.2f}_q{QBIT}.rnvb")
    results = {}
    artifact = None
    steps = TRAIN_FRAMES  # -b 1: one step per frame
    for name, extra, fname, ft_epochs, pruned in COMPRESS_RUNS:
        counts, wall = _eval_run(tmp, extra)
        path = os.path.join(outf, fname)
        if not os.path.exists(path):
            raise AssertionError(f"{name}: eval_main wrote no {fname}")
        with open(path) as f:
            res = json.loads(f.read().strip().splitlines()[-1])
        log(f"[compress] {name}: eval_main in {wall:.1f} s; PSNR {res['val_psnr'][-1]:.4f} "
            f"MS-SSIM {res['val_msssim'][-1]:.4f} BPP {res['bpp']:.6f} prune "
            f"{res['prune_ratio']:.4f} efficiency {res['efficiency']:.4f} fps {res['fps']:.2f} "
            f"micro-fps {res['micro_fps']:.2f}; launches {counts}")
        if not all(np.isfinite(v) for v in (res["val_psnr"][-1], res["bpp"], res["fps"])):
            raise AssertionError(f"{name}: non-finite result {res}")
        if pruned and abs(res["prune_ratio"] - PRUNE) > 0.05:
            raise AssertionError(f"{name}: prune ratio {res['prune_ratio']} vs {PRUNE}")
        if "--save_bitstream" in extra:
            # eval_main raises unless the .rnvb decodes to the evaluated weights bit-exactly
            if not os.path.exists(rnvb) or res.get("bitstream_bytes", 0) <= 0:
                raise AssertionError(f"{name}: no .rnvb")
            state = read_bitstream(rnvb)[0]  # the header differs: it records --decode_int8
            if artifact is not None and (list(state) != list(artifact) or not all(
                    np.array_equal(state[k], artifact[k]) for k in state)):
                raise AssertionError("PATH B wrote other weights from the same checkpoint")
            artifact = state
        want = 4 * steps * ft_epochs  # blocks 1-4 of every finetune step
        if counts["K3"] != want or counts["K4"] != want:
            raise AssertionError(f"{name}: K3/K4 launches {counts}, expected {want} each")
        if ft_epochs and counts["K5"] <= 0:
            raise AssertionError(f"{name}: the finetune loss launched no K5")
        if ("--decode_int8" in extra) != (counts["K2"] > 0):
            raise AssertionError(f"{name}: K2 launches {counts['K2']}")
        results[name] = {**res, "launches": counts, "wall_s": wall}
    d_psnr = results["path-b-int8"]["val_psnr"][-1] - results["path-b"]["val_psnr"][-1]
    log(f"[compress] int8 decode vs bf16 decode of the same PATH B weights: val PSNR "
        f"{d_psnr:+.4f} dB (bound {INT8_PSNR_BOUND})")
    if abs(d_psnr) > INT8_PSNR_BOUND:
        raise AssertionError(f"int8 val PSNR moved {d_psnr} dB")
    results["int8_psnr_delta_db"] = d_psnr

    # serve the artifact in int8
    n_batches = SERVE_FRAMES // SERVE_BATCH
    reset_counts()  # the main path's run starts here
    serve = decode_main.main([rnvb, "--frames", str(SERVE_FRAMES), "--batch", str(SERVE_BATCH),
                              "--decode_int8"])
    counts = launch_counts()  # ... and ends here
    k2_routes = dict(k8.ROUTE_LAUNCHES)
    per = 2 * n_batches * (1 + DECODE_REPS)
    log(f"[compress] decode_main --decode_int8 -> {serve}; launches {counts} (expect "
        f"{per} K1 and {per} K2: 2 + 2 per batch), K2 by route {k2_routes} (expect all wgmma)")
    if counts["K1"] != per or counts["K2"] != per:
        raise AssertionError(f"int8 serving launched {counts}, expected {per} K1 and {per} K2")
    if k2_routes != {"wmma": 0, "wgmma": per}:
        raise AssertionError(f"int8 serving: K2 launches by route {k2_routes}")

    dev = torch.device("cuda", 0)
    st, acfg, _ = read_bitstream(rnvb)
    base = decode_main.serving_model(st, acfg, dev)
    calib_t = torch.arange(min(8, SERVE_FRAMES), dtype=torch.float32, device=dev) / SERVE_FRAMES
    icfg = dataclasses.replace(base.cfg, decode_int8=True)
    model = copy.deepcopy(base)
    model.cfg = icfg
    model = calibrate_int8(model, positional_encoding(calib_t, icfg.embed))
    plain = copy.deepcopy(model)  # the same tables through the plain versions
    plain.cfg = dataclasses.replace(icfg, use_pallas_decode=False)
    t = torch.arange(SERVE_BATCH, dtype=torch.float32, device=dev) / SERVE_FRAMES
    frame_t = np.arange(SERVE_FRAMES) / SERVE_FRAMES
    real_stage = k8.decode_stage_int8
    frames = make_decode_fn(TrainConfig(model=icfg))(model, t)
    k8.decode_stage_int8 = k8.decode_stage_int8_reference
    try:
        ref = make_decode_fn(TrainConfig(model=plain.cfg))(plain, t)
        torch.cuda.synchronize()
        plain_fps = measure_decode_fps(plain, TrainConfig(model=plain.cfg), frame_t, SERVE_BATCH)
    finally:
        k8.decode_stage_int8 = real_stage
    if tuple(frames.shape) != (SERVE_BATCH, 720, 1280, 3) or frames.dtype != torch.float32:
        raise AssertionError(f"int8 frames {tuple(frames.shape)} {frames.dtype}")
    if not bool(torch.isfinite(frames).all()) or frames.min() < 0 or frames.max() > 1:
        raise AssertionError("int8 frames are not finite values in [0, 1]")
    diff = (frames - ref).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    log(f"[compress] int8 serving, first batch: kernel path vs plain path max|d|={err:.3e} "
        f"mean|d|={mean_err:.3e} (tol {SERVE_INT8_ATOL:g})")
    if err > SERVE_INT8_ATOL:
        raise AssertionError(f"int8 served frames differ from the plain path by {err}")
    bf16_fps = measure_decode_fps(base, TrainConfig(model=base.cfg), frame_t, SERVE_BATCH)
    log(f"[compress] fps at batch {SERVE_BATCH} ({base.cfg.compute_dtype} artifact): int8 kernel "
        f"path {serve['fps']:.2f}, {base.cfg.compute_dtype} K1 path {bf16_fps:.2f}, int8 plain "
        f"path {plain_fps:.2f}")
    results["serve_int8"] = {
        "launches": counts, "k2_route_launches": k2_routes, "fps": serve["fps"],
        "bf16_fps": bf16_fps, "plain_fps": plain_fps,
        "frames_max_abs_err": err, "frames_mean_abs_err": mean_err,
        "compute_dtype": base.cfg.compute_dtype,
        "graph_vs_eager": serve_graph_vs_eager(model, "int8"),
    }
    # the eval step on the served weights: the deploy model's eval forward is
    # the decode path (4 K1 a frame), the int8 model's 2 K1 + 2 K2
    video, vt = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    vstore = FrameStore(frames=torch.from_numpy(video).to(dev), t=vt)
    results["eval_graph"] = {
        "deploy": eval_graph_vs_eager(base, f"deploy {base.cfg.compute_dtype}", vstore,
                                      {"K1": 4, "K5": 5}),
        "int8": eval_graph_vs_eager(model, "int8", vstore, {"K1": 2, "K2": 2, "K5": 5}),
    }
    del base, model, plain, frames, ref, diff, vstore
    torch.cuda.empty_cache()
    return results


# phase 9, out-of-core: the flagship trained from a video on the host (rung 2)
# and from a frame directory on disk (rung 3).  16 MiB chunks at 2,764,800 B a
# 720p step: 6 steps a chunk, chunks of 6, 6 and 4 an epoch (a ring of 12).
OOC_CHUNK_MB = 16
OOC_CHUNKS = (6, 6, 4)
OOC_ARGV = ["--hbm_budget_mb", "1", "--stream_chunk_mb", str(OOC_CHUNK_MB)]


def _merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(intervals: list, merged: list) -> float:
    """Length of ``intervals`` that lies inside the union ``merged``."""
    total = 0.0
    for a, b in intervals:
        for c, d in merged:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def timeline(run, trace_dir: str) -> dict:
    """torch.profiler timeline of ``run()`` (the chrome trace that
    ``utils/profiling.py::trace`` writes into ``trace_dir``): device busy
    ms (the union of every kernel, copy and set on the card), the span from
    the first such event's start to the last one's end, kernel ms, the
    pinned host-to-device copies' ms and the part of it that lies under
    kernels (the copy engine working while the SMs do)."""
    torch.cuda.synchronize()
    with trace(trace_dir) as rec:
        run()
    with open(rec.path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies, other = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            kernels.append(span)
        elif cat == "gpu_memcpy" and "HtoD" in name and "Pinned" in name:
            copies.append(span)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other.append(span)
    if not kernels:
        raise RuntimeError("the profiler's timeline holds no kernel")
    k_merged = _merged(kernels)
    busy = _merged(kernels + copies + other)
    copy_us = sum(b - a for a, b in copies)
    return {"busy_ms": sum(b - a for a, b in busy) / 1e3,
            "span_ms": (busy[-1][1] - busy[0][0]) / 1e3, "kernels": len(kernels),
            "kernel_ms": sum(b - a for a, b in k_merged) / 1e3,
            "kernel_sum_ms": sum(b - a for a, b in kernels) / 1e3,
            "copies": len(copies), "copy_ms": copy_us / 1e3,
            "copy_under_kernels_ms": _covered(copies, k_merged) / 1e3}


def rung_epoch_ms(streaming: bool, cfg: TrainConfig, store: FrameStore, trace: str = "") -> dict:
    """ms per step of an epoch of the fused epoch (resident) or of the
    streaming epoch (host or disk), CUDA events around the epoch after a first
    epoch (the eager step and the capture); with ``trace`` also the timeline
    of a third epoch: device busy ms a step, idle share, copy overlap."""
    state = init_train_state(cfg, "cuda", seed=SEED)
    maker = make_streaming_epoch_fn if streaming else make_epoch_fn
    fn = maker(cfg, TRAIN_FRAMES, with_msssim=True)
    state, _ = run_fused_epoch(state, fn, store, cfg, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = run_fused_epoch(state, fn, store, cfg, 1)
    end.record()
    end.synchronize()
    out = {"ms": start.elapsed_time(end) / TRAIN_FRAMES}
    if trace:
        try:
            tl = timeline(lambda: run_fused_epoch(state, fn, store, cfg, 2), trace)
        except RuntimeError as e:  # the profiler could not trace the card here
            log(f"[ooc] timeline not measured ({e})")
            return out
        out.update({k: v / TRAIN_FRAMES if k.endswith("_ms") else v for k, v in tl.items()})
        out["idle_share"] = max(0.0, 1 - out["busy_ms"] / out["ms"])
        out["copy_overlap"] = (tl["copy_under_kernels_ms"] / tl["copy_ms"]
                               if tl["copy_ms"] else None)
    return out


def h2d_rate(store: FrameStore, rows: np.ndarray) -> dict:
    """The card's host-to-device rate for one chunk: the frames of ``rows``
    copied from the pinned host video into a device buffer, frame by frame on
    a side stream as the streaming epoch copies them; CUDA events on that
    stream, median of 5 after a warm-up."""
    src = torch.from_numpy(store.frames)
    if not src.is_pinned():
        raise AssertionError("the host store is not in pinned memory")
    dst = torch.empty((len(rows), *src.shape[1:]), dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    times = []
    for rep in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            for j, r in enumerate(rows):
                dst[j].copy_(src[int(r)], non_blocking=True)
            end.record(side)
        end.synchronize()
        if rep:
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    return {"chunk_bytes": dst.numel(), "ms": ms, "gb_s": dst.numel() / ms / 1e6}


def _losses_line(name: str, losses: torch.Tensor) -> str:
    return f"{name} " + " ".join(f"{v:.7f}" for v in losses.tolist())


def phase_outofcore(tmp: str, path_a_counts: dict) -> dict:
    """The flagship from a host-resident video (rung 2, the streaming epoch
    over pinned memory) against the resident one (rung 1), bf16 and f32;
    from a frame directory on disk (rung 3); train_main end to end on rung 2;
    eval_main's PATH A finetune from a host store."""
    cwd = os.getcwd()
    data = DataConfig(dataset="synth", synthetic_frames=TRAIN_FRAMES, synthetic_hw=(720, 1280),
                      hbm_budget_mb=1, stream_chunk_mb=OOC_CHUNK_MB)
    host = make_frame_store(data, "cuda")
    if host.resident or not torch.from_numpy(host.frames).is_pinned():
        raise AssertionError("--hbm_budget_mb 1 did not leave the video in pinned host memory")
    device_store = FrameStore(frames=torch.from_numpy(host.frames).cuda(), t=host.t)
    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(_train_cfg(dtype, True), data=data)
        chunk = stream_chunk_steps(host, cfg)
        rows = epoch_rows(host, cfg, 0)
        a = init_train_state(cfg, "cuda", seed=SEED)
        resident = make_epoch_fn(cfg, TRAIN_FRAMES, with_msssim=True)
        a, aux = resident(a, device_store, rows, None)
        ref = aux["loss"].cpu()
        b = init_train_state(cfg, "cuda", seed=SEED)
        streaming = make_streaming_epoch_fn(cfg, TRAIN_FRAMES, with_msssim=True)
        b, aux = streaming(b, host, rows, None, chunk)
        got = aux["loss"].cpu()
        rel = ((got - ref).abs() / ref.abs()).max().item()
        ok = rel <= GRAPH_TOL[dtype] and bool(torch.isfinite(got).all())
        log(f"[ooc] {dtype}: " + _losses_line("rung 1 per-step losses", ref))
        log(f"[ooc] {dtype}: " + _losses_line("rung 2 per-step losses", got))
        log(f"[ooc] {dtype}: rung 2 (host, chunks of {chunk}) vs rung 1 (resident), from the same "
            f"weights: largest relative difference {rel:.3e} (tol {GRAPH_TOL[dtype]:g}); equal "
            f"bits {torch.equal(got, ref)} {'ok' if ok else 'FAIL'}")
        if not ok or chunk != OOC_CHUNKS[0]:
            raise AssertionError(f"{dtype}: rung 2 differs from rung 1 by {rel} (chunk {chunk})")
        del a, resident
        copies_before, graph = streaming.chunk_copies, streaming.graph
        reset_counts()  # an epoch of rung-2 replays starts here
        b, _ = run_fused_epoch(b, streaming, host, cfg, 1)
        counts = launch_counts()  # ... and ends here
        n_copies = streaming.chunk_copies - copies_before
        if streaming.graph is not graph:
            raise AssertionError(f"{dtype}: the second rung-2 epoch captured its step again")
        want = {k: v * TRAIN_FRAMES for k, v in PER_STEP.items()}
        log(f"[ooc] {dtype}: rung 2 launches in an epoch of {TRAIN_FRAMES} replayed steps "
            f"{ {k: counts[k] for k in want} } (expect {want}); {n_copies} chunk copies "
            f"(expect {len(OOC_CHUNKS)})")
        if any(counts[k] != v for k, v in want.items()) or n_copies != len(OOC_CHUNKS):
            raise AssertionError(f"{dtype}: rung 2 epoch launched {counts}, {n_copies} copies")
        del b, streaming
        torch.cuda.empty_cache()
        runs = {False: [], True: []}
        for stream in (False, True, True, False):  # rung 1, rung 2, rung 2, rung 1
            first = not runs[stream]
            trace = os.path.join(tmp, f"ooc_{dtype}_{int(stream)}") if first else ""
            runs[stream].append(rung_epoch_ms(stream, cfg, host if stream else device_store,
                                              trace))
            torch.cuda.empty_cache()
        res = {"max_rel_loss_diff": rel, "equal_bits": torch.equal(got, ref),
               "losses_rung1": ref.tolist(), "losses_rung2": got.tolist(),
               "replay_launches": counts, "chunk_copies_per_epoch": n_copies,
               "h2d": h2d_rate(host, rows[:chunk].reshape(-1))}
        for stream, name in ((False, "rung1"), (True, "rung2")):
            r = runs[stream]
            res[name] = {"ms": statistics.mean(x["ms"] for x in r), "runs_ms": [x["ms"] for x in r],
                         **{k: v for k, v in r[0].items() if k != "ms"}}
            log(f"[ooc] {dtype}: {name} step {res[name]['ms']:.3f} ms "
                f"({', '.join(f'{x:.3f}' for x in res[name]['runs_ms'])}: CUDA events around an "
                f"epoch of {TRAIN_FRAMES} steps)" + _timeline_text(r[0]))
        h2d = res["h2d"]
        log(f"[ooc] {dtype}: H2D copy of one chunk ({h2d['chunk_bytes']} B, frame by frame from "
            f"pinned memory on a side stream): {h2d['ms']:.3f} ms, {h2d['gb_s']:.2f} GB/s "
            "(CUDA events)")
        results[dtype] = res

    results["rung3"] = _rung3(tmp, host, results)
    results["train_main_rung2"] = _train_main_rung2(tmp, cwd)
    results["path_a_host"] = _path_a_host(tmp, path_a_counts)
    return results


def _timeline_text(r: dict) -> str:
    if "busy_ms" not in r:
        return "; device time not measured"
    text = (f"; device busy {r['busy_ms']:.3f} ms a step (idle share {r['idle_share']:.3f}), "
            f"kernels {r['kernel_ms']:.3f} ms (torch.profiler timeline)")
    if r["copies"]:
        text += (f"; {r['copies']} pinned H2D copies, {r['copy_ms']:.3f} ms a step of copy time, "
                 f"{r['copy_under_kernels_ms']:.3f} ms of it under kernels (overlap "
                 f"{r['copy_overlap']:.3f})")
    return text


def _rung3(tmp: str, host: FrameStore, results: dict) -> dict:
    """Rung 3: the 16 frames as PNGs, trained from disk (DirFrames) by the
    streaming epoch (per-step losses against rung 2's) and by train_main."""
    try:
        from PIL import Image
    except ImportError:
        log("[ooc] rung 3 not run: PIL is not installed on this machine (it writes and reads "
            "the PNG frames)")
        return {"run": False}
    d = os.path.join(tmp, "ooc", "pngs")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    for i, frame in enumerate(host.frames):
        Image.fromarray(frame).save(os.path.join(d, f"f{i:04d}.png"))
    log(f"[ooc] rung 3: wrote {len(host.frames)} PNG frames in {time.perf_counter() - t0:.1f} s")
    data = DataConfig(dataset="pngs", data_dir=os.path.dirname(d), host_budget_mb=1,
                      hbm_budget_mb=1, stream_chunk_mb=OOC_CHUNK_MB)
    disk = make_frame_store(data, "cuda")
    if not isinstance(disk.frames, DirFrames):
        raise AssertionError(f"--host_budget_mb 1 gave a {type(disk.frames).__name__}")
    out = {"run": True}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(_train_cfg(dtype, True), data=data)
        state = init_train_state(cfg, "cuda", seed=SEED)
        fn = make_streaming_epoch_fn(cfg, TRAIN_FRAMES, with_msssim=True)
        state, aux = fn(state, disk, epoch_rows(disk, cfg, 0), None, stream_chunk_steps(disk, cfg))
        got = aux["loss"].cpu()
        ref = torch.tensor(results[dtype]["losses_rung2"])
        rel = ((got - ref).abs() / ref.abs()).max().item()
        log(f"[ooc] {dtype}: " + _losses_line("rung 3 per-step losses", got))
        log(f"[ooc] {dtype}: rung 3 (PNG frames on disk) vs rung 2: largest relative difference "
            f"{rel:.3e} (tol {GRAPH_TOL[dtype]:g}); equal bits {torch.equal(got, ref)}")
        if rel > GRAPH_TOL[dtype]:
            raise AssertionError(f"{dtype}: rung 3 differs from rung 2 by {rel}")
        del state, fn
        timing = rung_epoch_ms(True, cfg, disk, os.path.join(tmp, f"ooc_{dtype}_disk"))
        log(f"[ooc] {dtype}: rung3 step {timing['ms']:.3f} ms (CUDA events around an epoch of "
            f"{TRAIN_FRAMES} steps, PNG decode on the host included)" + _timeline_text(timing))
        out[dtype] = {"max_rel_loss_diff_vs_rung2": rel, "equal_bits_vs_rung2": torch.equal(got, ref),
                      **timing}
        torch.cuda.empty_cache()
    # train_main from the directory: the store it builds is a DirFrames
    made = []
    real = train_main.make_frame_store
    cwd = os.getcwd()

    def spy(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    train_main.make_frame_store = spy
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        res = train_main.main(TRAIN_ARGV + ["--compute_dtype", "bfloat16", "--outf", "ooc_disk",
                                            "--dataset", "pngs", "--data_dir", os.path.dirname(d),
                                            "--synthetic_frames", "0", "--host_budget_mb", "1"]
                              + OOC_ARGV)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        train_main.make_frame_store = real
    if len(made) != 1 or not isinstance(made[0].frames, DirFrames):
        raise AssertionError("train_main did not train from a DirFrames")
    for h in res["history"]:
        log(f"[ooc] train_main rung 3 ({len(made[0].frames)} PNG files, bf16): epoch "
            f"{h['epoch']} loss {h['loss']:.6f} PSNR {h['psnr'][-1]:.4f}")
    log(f"[ooc] train_main rung 3: {wall:.1f} s, val PSNR {res['bests']['val_best_psnr']:.4f}")
    out["train_main"] = {"history": res["history"], "wall_s": wall, "bests": res["bests"]}
    return out


def _train_main_rung2(tmp: str, cwd: str) -> dict:
    """train_main on rung 2, bf16, 2 epochs with --eval_fps: the eval runs from
    the host store.  Launches: 4 K3 + 4 K4 + 7 K5 a step, 5 K5 an eval frame."""
    os.chdir(tmp)
    try:
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        res = train_main.main(TRAIN_ARGV + ["--compute_dtype", "bfloat16", "--eval_fps",
                                            "--outf", "ooc_host"] + OOC_ARGV)
        wall = time.perf_counter() - t0
        counts = launch_counts()  # ... and ends here
        outf = os.path.abspath(res["outf"])
    finally:
        os.chdir(cwd)
    steps = TRAIN_FRAMES * TRAIN_EPOCHS
    want = {k: PER_STEP[k] * steps + PER_EVAL_FRAME[k] * steps for k in PER_STEP}
    log(f"[ooc] train_main on rung 2 (bf16, {TRAIN_EPOCHS} epochs, --eval_fps) in {wall:.1f} s; "
        f"launches { {k: counts[k] for k in want} } (expect {want})")
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"train_main on rung 2 launched {counts}")
    with open(os.path.join(outf, "rank0.txt")) as f:
        log_text = f.read()
    fps = [float(line.split()[1]) for line in log_text.splitlines() if line.startswith("FPS: ")]
    if f"Epoch[{TRAIN_EPOCHS}/{TRAIN_EPOCHS}]" not in log_text or len(fps) != TRAIN_EPOCHS:
        raise AssertionError("train_main on rung 2: no last epoch line or FPS lines in rank0.txt")
    for name in ("model_latest.pth", "model_latest_deploy.pth", "resume_latest.pt"):
        if not os.path.exists(os.path.join(outf, name)):
            raise AssertionError(f"train_main on rung 2 wrote no {name}")
    hist = res["history"]
    if not all(np.isfinite(h["loss"]) for h in hist) or not hist[-1]["psnr"][-1] > hist[0]["psnr"][-1]:
        raise AssertionError("train_main on rung 2: non-finite loss or PSNR not rising")
    for h in hist:
        log(f"[ooc] train_main rung 2: epoch {h['epoch']} loss {h['loss']:.6f} PSNR "
            f"{h['psnr'][-1]:.4f}")
    log(f"[ooc] train_main rung 2: val PSNR {res['bests']['val_best_psnr']:.4f}")
    return {"launches": counts, "wall_s": wall, "history": hist, "eval_fps": fps,
            "bests": res["bests"]}


def _path_a_host(tmp: str, path_a_counts: dict) -> dict:
    """eval_main's PATH A (1 masked finetune epoch) from a host store: the
    streaming finetune launches what phase 8's resident finetune did."""
    extra = ["--prune_ratio", str(PRUNE), "--quant_bit", str(QBIT), "--finetune",
             "--finetune_epochs", "1"] + OOC_ARGV
    counts, wall = _eval_run(tmp, extra)
    log(f"[ooc] eval_main PATH A from a host store in {wall:.1f} s; launches {counts} (phase 8's "
        f"resident PATH A: {path_a_counts})")
    for k in ("K3", "K4", "K5"):
        if counts[k] != path_a_counts[k]:
            raise AssertionError(f"PATH A from a host store launched {counts[k]} {k}, "
                                 f"the resident one {path_a_counts[k]}")
    return {"launches": counts, "wall_s": wall}


# phase 10, the suite and multi-GPU slice: the suite of phase 6's flagship
# (paper flags, 720p ERB, -b 1, bf16) over 2 synthetic videos of 8 frames
SUITE_FRAMES, SUITE_VIDEOS = 8, 2
SUITE_FLAGS = [
    (str(SUITE_FRAMES) if TRAIN_ARGV[i - 1] == "--synthetic_frames" else a)
    for i, a in enumerate(TRAIN_ARGV[:-2])  # without --device cuda
] + ["--compute_dtype", "bfloat16", "--quant_bit", "8", "--save_bitstream"]
SUITE_ARGV = SUITE_FLAGS + ["--device", "cuda", "--n_videos", str(SUITE_VIDEOS)]
# two gloo ranks on the one card (f32, -b 1 each, cuDNN deterministic) over an
# epoch of 8 steps, held against two references from the same weights:
# * one process at -b 2: per-step losses within 1e-5 relative, and the first
#   step's all-reduced gradients within 1e-4 of each tensor's largest |entry|
#   (phase 6's f32 bounds): the all-reduce sums two rank-local gradients of one
#   frame each where the one process sums the two frames' products in its own
#   order.  Its final weights are reported, not bounded: Adam moves an entry
#   whose gradient is below that summation noise by a sign-sized step, so 8
#   steps leave such entries up to 2e-3 of the tensor's largest |entry| apart
#   (2.049e-3 in the first card run, NVIDIA H100 80GB HBM3, 700 W);
# * one process that runs the data-parallel step's own arithmetic (the two
#   frames through the -b 1 step one after the other, their gradients summed
#   and halved, Adam): per-step losses within 1e-6 relative, final weights
#   within 1e-4 of each tensor's largest |entry| (equal bits are expected:
#   the same kernels on the same operands);
# * each other: the ranks' weights equal to the bit
GLOO_LOSS_RTOL, GLOO_GRAD_RTOL, GLOO_WEIGHT_RTOL, GLOO_SAME_LOSS_RTOL = 1e-5, 1e-4, 1e-4, 1e-6
GLOO_STEPS = TRAIN_FRAMES // 2
GLOO_TIMEOUT_S = 600


class EpochRecorder:
    """Records every fused epoch's per-step losses (a device copy at the end
    of the epoch function, on its stream: no host wait), with the epoch
    function and the model it trained: wraps ``FusedEpoch._finish``, which
    every fused, streaming, sharded and suite epoch calls."""

    def __enter__(self):
        from repnerv_tpu_torch.train.loop import FusedEpoch

        self.calls = []
        self._cls, self._orig = FusedEpoch, FusedEpoch._finish
        rec = self

        def _finish(fn, state, buf, n_steps, lrs):
            rec.calls.append((fn, id(state.model), buf.loss[:n_steps].clone()))
            return rec._orig(fn, state, buf, n_steps, lrs)

        FusedEpoch._finish = _finish
        return self

    def __exit__(self, *exc):
        self._cls._finish = self._orig

    def by_model(self) -> list:
        """Per-step losses of each model, in the order the models first
        trained (the suite's video order), concatenated over the epochs."""
        order, out = [], {}
        for _, mid, loss in self.calls:
            if mid not in out:
                order.append(mid)
                out[mid] = []
            out[mid].append(loss.cpu())
        return [torch.cat(out[m]) for m in order]

    def epoch_fns(self) -> list:
        fns = []
        for fn, _, _ in self.calls:
            if all(fn is not f for f in fns):
                fns.append(fn)
        return fns


def _deterministic(on: bool) -> bool:
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    return saved


def _suite_run(tmp: str, mode: str, name: str, record: bool = False) -> dict:
    """suite_main in ``mode`` from ``tmp``; launches of the fit apart from
    those of the eval; with ``record`` the per-step losses by video, the
    epoch functions, and each .rnvb against the weights it was written from."""
    from repnerv_tpu_torch.cli import suite_main

    eval_counts = {}
    evaluate, compress = suite_main.evaluate, suite_main.compress
    written = {}

    def counted_evaluate(*args, **kwargs):
        before = launch_counts()
        out = evaluate(*args, **kwargs)
        for k, v in launch_counts().items():
            eval_counts[k] = eval_counts.get(k, 0) + v - before[k]
        return out

    def recorded_compress(model, cfg, store, **kw):
        out, report = compress(model, cfg, store, **kw)
        written[kw["bitstream_path"]] = {k: v.detach().cpu() for k, v in out.state_dict().items()}
        return out, report

    cwd = os.getcwd()
    suite_main.evaluate, suite_main.compress = counted_evaluate, recorded_compress
    os.chdir(tmp)
    rec = EpochRecorder()
    try:
        with rec if record else contextlib.nullcontext():
            reset_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            res = suite_main.main(SUITE_ARGV + ["--suite_mode", mode, "--outf", name,
                                                "--suite_out", f"{name}.json"])
            wall = time.perf_counter() - t0
            counts = launch_counts()  # ... and ends here
        with open(f"{name}.json") as f:
            saved = json.load(f)
    finally:
        os.chdir(cwd)
        suite_main.evaluate, suite_main.compress = evaluate, compress
    rows = res["videos"]
    if saved != res or len(rows) != SUITE_VIDEOS or not all(
            np.isfinite(r[k]) for r in rows for k in ("psnr", "msssim", "bpp")):
        raise AssertionError(f"suite {mode}: table {res}")
    steps = SUITE_VIDEOS * SUITE_FRAMES * TRAIN_EPOCHS
    fit = {k: counts[k] - eval_counts.get(k, 0) for k in PER_STEP}
    want = {k: v * steps for k, v in PER_STEP.items()}
    if fit != want:
        raise AssertionError(f"suite {mode}: the fits launched {fit}, expected {want}")
    out = {"table": res, "wall_s": wall, "launches": counts, "fit_launches": fit,
           "eval_launches": eval_counts}
    for path, state in written.items():
        back = read_bitstream(os.path.join(tmp, path))[0]
        if list(back) != list(state) or not all(
                torch.equal(torch.from_numpy(np.asarray(back[k])), state[k]) for k in state):
            raise AssertionError(f"suite {mode}: {path} does not decode to the evaluated weights")
    if len(written) != SUITE_VIDEOS:
        raise AssertionError(f"suite {mode}: {len(written)} .rnvb files")
    if record:
        fns = rec.epoch_fns()
        models = {mid for _, mid, _ in rec.calls}
        captures = sum(fn.captures for fn in fns)
        replay = [{k: launches_of(fn.replay_counts)[k] for k in PER_STEP} for fn in fns]
        if captures != len(models) or len(models) != SUITE_VIDEOS or any(
                r != PER_STEP for r in replay):
            raise AssertionError(f"suite {mode}: {captures} captures for {len(models)} videos, "
                                 f"a replayed step launches {replay}")
        out.update(losses=rec.by_model(), captures=captures, epoch_fns=len(fns),
                   replay_launches=replay[0])
    return out


def launches_of(counts) -> dict:
    """K1..K5 and the fusion's launches of a ``kernels/launches.py`` record
    (a replay's counts)."""
    names = {"K1": (dk, "LAUNCHES"), "K2": (k8, "LAUNCHES"), "K3": (tt, "FWD_LAUNCHES"),
             "K4": (tt, "BWD_LAUNCHES"), "K5": (sb, "LAUNCHES"),
             "FOLD": (rfk, "FWD_LAUNCHES"), "FOLD_VJP": (rfk, "VJP_LAUNCHES")}
    return {k: counts.get((mod.__name__, attr), 0) for k, (mod, attr) in names.items()}


def _suite_epoch_timeline(tmp: str, mode: str) -> dict:
    """One steady suite epoch in ``mode`` (after the epoch that captures):
    ms of the epoch (CUDA events, its metric fetches included), then the
    torch.profiler timeline of the next: its ms, device busy ms (busy share:
    of the same profiled epoch), the kernels' union and their summed time
    (above the union where two videos' kernels ran at once on the card)."""
    from repnerv_tpu_torch.cli import suite_main
    from repnerv_tpu_torch.parallel import suite as psuite

    cfg = suite_main.args_to_config(suite_main.build_parser(eval_mode=False).parse_args(SUITE_FLAGS))
    stores = suite_main._suite_stores(cfg, SUITE_VIDEOS, "cuda")
    states = psuite.init_suite_states(cfg, SUITE_VIDEOS, "cuda")
    steps = SUITE_FRAMES  # -b 1
    if mode == "parallel":
        suite_fn = psuite.make_suite_epoch_fn(cfg, steps, SUITE_VIDEOS, with_msssim=True)

        def epoch(e):
            psuite.run_suite_epoch(states, suite_fn, stores, cfg, e, steps)
    else:
        fns = [make_epoch_fn(cfg, steps, with_msssim=True) for _ in range(SUITE_VIDEOS)]

        def epoch(e):
            for v in range(SUITE_VIDEOS):
                vcfg = dataclasses.replace(cfg, manual_seed=cfg.manual_seed + v)
                states[v], _ = run_fused_epoch(states[v], fns[v], stores[v], vcfg, e)
    epoch(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    epoch(1)
    end.record()
    end.synchronize()
    out = {"epoch_ms": start.elapsed_time(end)}

    def profiled():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        epoch(2)
        b.record()
        b.synchronize()
        out["profiled_epoch_ms"] = a.elapsed_time(b)

    try:
        out.update(timeline(profiled, os.path.join(tmp, f"suite_{mode}")))
    except RuntimeError as e:  # the profiler could not trace the card here
        log(f"[suite] {mode}: timeline not measured ({e})")
    return out


def phase_suite(tmp: str) -> dict:
    """(a) the sequential and (b) the parallel suite through suite_main: the
    tables, the .rnvb files, launches, one capture a video, per-step losses
    equal to the bit; fit seconds in turns and the device busy share."""
    saved = _deterministic(True)
    try:
        seq = _suite_run(tmp, "sequential", "suite_seq", record=True)
        par = _suite_run(tmp, "parallel", "suite_par", record=True)
    finally:
        _deterministic(saved)
    for mode, r in (("sequential", seq), ("parallel", par)):
        log(f"[suite] {mode}: suite_main ({SUITE_VIDEOS} videos x {SUITE_FRAMES} frames, 720p, "
            f"-b 1, bf16, {TRAIN_EPOCHS} epochs, 8-bit .rnvb) in {r['wall_s']:.1f} s; fit "
            f"{r['table']['fit_seconds']:.3f} s; fit launches {r['fit_launches']} (expect "
            f"{ {k: v * SUITE_VIDEOS * SUITE_FRAMES * TRAIN_EPOCHS for k, v in PER_STEP.items()} }), "
            f"eval launches {r['eval_launches']}; a replayed step {r['replay_launches']}; "
            f"{r['captures']} captures in {r['epoch_fns']} epoch functions; each .rnvb decodes to "
            "the evaluated weights bit for bit")
        for row in r["table"]["videos"]:
            log(f"[suite] {mode}: video {row['video']} PSNR {row['psnr']:.4f} MS-SSIM "
                f"{row['msssim']:.4f} BPP {row['bpp']:.6f} .rnvb {row['rnvb_bytes']} B")
    equal = [torch.equal(a, b) for a, b in zip(seq["losses"], par["losses"])]
    for v, (a, b) in enumerate(zip(seq["losses"], par["losses"])):
        log(f"[suite] video {v}: " + _losses_line("sequential per-step losses", a))
        log(f"[suite] video {v}: " + _losses_line("parallel per-step losses  ", b))
    def rows(r):  # each row but the .rnvb's path (under the run's --outf)
        return [{k: v for k, v in row.items() if k != "rnvb"} for row in r["table"]["videos"]]

    same_table = rows(par) == rows(seq)
    log(f"[suite] parallel vs sequential per-step losses, cuDNN deterministic: equal bits "
        f"{equal}; the tables equal (but the .rnvb paths) {same_table}")
    if not all(equal) or len(equal) != SUITE_VIDEOS:
        raise AssertionError("the parallel suite's per-step losses differ from the sequential's")
    if not same_table:
        raise AssertionError("the parallel suite's table differs from the sequential's")
    fits = {"sequential": [], "parallel": []}
    for mode in ("sequential", "parallel", "parallel", "sequential"):
        fits[mode].append(_suite_run(tmp, mode, f"suite_{mode[:3]}_t")["table"]["fit_seconds"])
        torch.cuda.empty_cache()
    out = {"sequential": {k: v for k, v in seq.items() if k != "losses"},
           "parallel": {k: v for k, v in par.items() if k != "losses"},
           "losses_equal_bits": equal}
    for mode in ("sequential", "parallel"):
        fit_s = statistics.mean(fits[mode])
        tl = _suite_epoch_timeline(tmp, mode)
        torch.cuda.empty_cache()
        entry = {"fit_s": fit_s, "fit_runs_s": fits[mode], "steady_epoch": tl}
        text = (f"a steady epoch of both videos {tl['epoch_ms']:.3f} ms "
                f"({tl['epoch_ms'] / (SUITE_VIDEOS * SUITE_FRAMES):.3f} ms a video-step, CUDA "
                "events)")
        if "busy_ms" in tl:
            tl["busy_share"] = tl["busy_ms"] / tl["profiled_epoch_ms"]
            tl["kernel_overlap"] = tl["kernel_sum_ms"] / tl["kernel_ms"]
            text += (f"; the next epoch under torch.profiler {tl['profiled_epoch_ms']:.3f} ms, "
                     f"device busy {tl['busy_ms']:.3f} ms of it (busy share "
                     f"{tl['busy_share']:.3f}), kernel time summed {tl['kernel_sum_ms']:.3f} ms "
                     f"over a union of {tl['kernel_ms']:.3f} ms (x{tl['kernel_overlap']:.3f}; its "
                     "timeline)")
        out[mode].update(entry)
        log(f"[suite] {mode}: fit {fit_s:.3f} s ({', '.join(f'{x:.3f}' for x in fits[mode])}: "
            f"suite_main's fit_seconds, in turns seq, par, par, seq); {text}")
    return out


def _mesh_epoch_ms(sharded: bool, cfg: TrainConfig, store: FrameStore, mesh,
                   profile: bool) -> dict:
    """ms per step of an epoch of the plain or the sharded fused epoch (CUDA
    events around an epoch after a first one); with ``profile`` the device
    ms a step of every kernel and copy, and of NCCL's kernels
    (torch.profiler over a third epoch)."""
    from repnerv_tpu_torch.parallel import sharding

    state = init_train_state(cfg, "cuda", seed=SEED)
    fn = (sharding.make_sharded_epoch_fn(cfg, TRAIN_FRAMES, mesh, with_msssim=True) if sharded
          else make_epoch_fn(cfg, TRAIN_FRAMES, with_msssim=True))
    state, _ = run_fused_epoch(state, fn, store, cfg, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = run_fused_epoch(state, fn, store, cfg, 1)
    end.record()
    end.synchronize()
    out = {"ms": start.elapsed_time(end) / TRAIN_FRAMES}
    if profile:
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d, trace(d) as rec:
            run_fused_epoch(state, fn, store, cfg, 2)
        total = nccl = 0.0
        for key, us in device_us(rec.profiler).items():
            total += us
            if "nccl" in key.lower():
                nccl += us
        if total:
            out.update(device_ms=total / 1e3 / TRAIN_FRAMES, nccl_ms=nccl / 1e3 / TRAIN_FRAMES)
            out["idle_share"] = 1 - out["device_ms"] / out["ms"]
    return out


def phase_mesh_train(tmp: str) -> dict:
    """(c) train_main --mesh_shape 1 (an NCCL world of one) against the run
    without the flag, bf16 and f32: per-step losses to the bit (cuDNN
    deterministic), launches of a replayed step; ms a step of the sharded
    and the plain graph step in turns, the all-reduce's device ms."""
    from repnerv_tpu_torch.parallel import sharding

    video, t = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    store = FrameStore(frames=torch.from_numpy(video).cuda(), t=t)
    cwd = os.getcwd()
    results = {}
    for dtype in ("bfloat16", "float32"):
        runs = {}
        saved = _deterministic(True)
        os.chdir(tmp)
        try:
            for name, extra in (("plain", []), ("mesh1", ["--mesh_shape", "1"])):
                with EpochRecorder() as rec:
                    reset_counts()  # the main path's run starts here
                    t0 = time.perf_counter()
                    res = train_main.main(TRAIN_ARGV + ["--compute_dtype", dtype, "--outf",
                                                        f"mesh_{dtype}_{name}"] + extra)
                    wall = time.perf_counter() - t0
                    counts = launch_counts()  # ... and ends here
                fn, = rec.epoch_fns()
                runs[name] = {"losses": torch.cat([c[2].cpu() for c in rec.calls]),
                              "replay": {k: launches_of(fn.replay_counts)[k] for k in PER_STEP},
                              "type": type(fn).__name__, "captures": fn.captures,
                              "history": res["history"], "launches": counts, "wall_s": wall}
        finally:
            os.chdir(cwd)
            _deterministic(saved)
        a, b = runs["plain"], runs["mesh1"]
        equal = torch.equal(a["losses"], b["losses"])
        log(f"[mesh] {dtype}: " + _losses_line("train_main per-step losses          ", a["losses"]))
        log(f"[mesh] {dtype}: " + _losses_line("train_main --mesh_shape 1 per-step", b["losses"]))
        log(f"[mesh] {dtype}: --mesh_shape 1 ({b['type']}, NCCL world of one) vs without "
            f"({a['type']}): per-step losses over {len(a['losses'])} steps equal bits {equal}; "
            f"a replayed step launches {b['replay']} vs {a['replay']}; captures {b['captures']} vs "
            f"{a['captures']}; whole runs {b['wall_s']:.1f} / {a['wall_s']:.1f} s, launches "
            f"{b['launches']} vs {a['launches']}")
        same_history = [(h["loss"], h["lr"]) for h in b["history"]] == [
            (h["loss"], h["lr"]) for h in a["history"]]
        if (not equal or b["replay"] != a["replay"] or a["replay"] != PER_STEP
                or b["type"] != "ShardedEpoch" or b["launches"] != a["launches"]
                or not same_history or b["captures"] != 1):
            raise AssertionError(f"{dtype}: train_main --mesh_shape 1 differs from the plain run")
        cfg = _train_cfg(dtype, True)
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        try:
            if torch.distributed.get_backend() != "nccl":
                raise AssertionError("the world of one on the card is not NCCL")
            times = {False: [], True: []}
            for sharded in (False, True, True, False):
                first = not times[sharded]
                times[sharded].append(_mesh_epoch_ms(sharded, cfg, store, mesh, profile=first))
                torch.cuda.empty_cache()
        finally:
            sharding.close_mesh(mesh)
        res = {"losses_equal_bits": equal, "steps": len(a["losses"]),
               "replay_launches": b["replay"], "launches": b["launches"]}
        for sharded, name in ((False, "plain"), (True, "mesh1")):
            r = times[sharded]
            res[name] = {"ms": statistics.mean(x["ms"] for x in r), "runs_ms": [x["ms"] for x in r],
                         "wall_s": runs[name]["wall_s"]}
        for sharded, name in ((False, "plain"), (True, "mesh1")):
            prof = times[sharded][0]
            res[name].update({k: prof[k] for k in ("device_ms", "nccl_ms", "idle_share")
                              if k in prof})

        def prof_text(r):
            if "device_ms" not in r:
                return "device time not measured"
            return (f"device {r['device_ms']:.3f} ms a step (idle share {r['idle_share']:.3f}), "
                    f"NCCL kernels {r['nccl_ms']:.4f} ms a step")

        log(f"[mesh] {dtype}: ms a graph step, plain {res['plain']['ms']:.3f} "
            f"({', '.join(f'{x:.3f}' for x in res['plain']['runs_ms'])}; "
            f"{prof_text(res['plain'])}), sharded over a world of one {res['mesh1']['ms']:.3f} "
            f"({', '.join(f'{x:.3f}' for x in res['mesh1']['runs_ms'])}; "
            f"{prof_text(res['mesh1'])}) (CUDA events around an epoch of {TRAIN_FRAMES} steps, "
            "in turns; torch.profiler over a third epoch)")
        results[dtype] = res
    return results


def gloo_rank_main(rank: int, init_file: str, out_path: str) -> None:
    """One of two gloo ranks on the one card (phase 10 (d)): the f32
    flagship's sharded fused epoch at a local batch of 1 from the seed's
    weights over the 8 steps of epoch 0, then the ms a step of epoch 1."""
    from repnerv_tpu_torch.parallel import sharding

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as the one process it is held against
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                         world_size=2)
    mesh = sharding.make_mesh((2,), ("data",), "cuda")
    cfg = dataclasses.replace(_train_cfg("float32", True), data=DataConfig(batch_size=2))
    video, t = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    store = FrameStore(frames=torch.from_numpy(video).cuda(), t=t)
    rows = epoch_rows(store, cfg, 0)
    # the first step's all-reduced, averaged gradients (no update)
    probe = init_train_state(cfg, "cuda", seed=SEED)
    dp = sharding.DataParallelUpdate(cfg, True, None, mesh)
    local = torch.from_numpy(rows[0][sharding.local_batch(rows.shape[1], mesh)]).cuda()
    dp.forward_backward(probe, store.gather(local),
                        torch.from_numpy(store.t.astype(np.float32)).cuda()[local])
    dp.reduce()
    grads = {k: (p.grad / mesh.world_size).cpu() for k, p in probe.model.named_parameters()}
    del probe, dp
    state = init_train_state(cfg, "cuda", seed=SEED)
    fn = sharding.make_sharded_epoch_fn(cfg, GLOO_STEPS, mesh, with_msssim=True)
    reset_counts()
    state, aux = fn(state, store, rows, None)
    losses = aux["loss"].cpu().clone()
    counts = launch_counts()
    weights = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = run_fused_epoch(state, fn, store, cfg, 1)
    end.record()
    end.synchronize()
    torch.save({"losses": losses, "weights": weights, "launches": counts, "grads": grads,
                "replay": {k: launches_of(fn.replay_counts)[k] for k in PER_STEP},
                "ms": start.elapsed_time(end) / GLOO_STEPS, "backend": torch.distributed.get_backend(),
                "device": str(mesh.device)}, out_path)
    torch.distributed.destroy_process_group()


def phase_gloo(tmp: str) -> dict:
    """(d) two gloo ranks on the one card, f32, -b 1 each, over 8 steps from
    the seed's weights, against one process at -b 2 and against one process
    running the data-parallel step's arithmetic (``GLOO_*`` above)."""
    init = os.path.join(tmp, "gloo_init")
    outs = [os.path.join(tmp, f"gloo_rank{r}.pt") for r in range(2)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
                               init, outs[r]], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GLOO_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n{text[-4000:]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    a, b = ranks
    cfg = dataclasses.replace(_train_cfg("float32", True), data=DataConfig(batch_size=2))
    video, t = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    store = FrameStore(frames=torch.from_numpy(video).cuda(), t=t)
    rows = epoch_rows(store, cfg, 0)
    saved = _deterministic(True)
    try:
        one = _one_process_b2(cfg, store, rows)
        same = _accumulated_steps(cfg, store, rows)
    finally:
        _deterministic(saved)
    ranks_equal = torch.equal(a["losses"], b["losses"]) and all(
        torch.equal(a["weights"][k], b["weights"][k]) for k in a["weights"])
    res = {"ranks_equal": ranks_equal, "ms": [a["ms"], b["ms"]], "replay_launches": a["replay"],
           "wall_s": wall, "launches": [a["launches"], b["launches"]],
           "losses": a["losses"].tolist()}
    for name, ref in (("one_process_b2", one), ("same_arithmetic", same)):
        loss_rel = ((a["losses"] - ref["losses"]).abs() / ref["losses"].abs()).max().item()
        w_rel, over = _rel_by_tensor(a["weights"], ref["weights"], GLOO_WEIGHT_RTOL)
        worst = max(w_rel, key=w_rel.get)
        res[name] = {"loss_max_rel": loss_rel, "weight_max_rel": w_rel[worst],
                     "weight_worst": worst, "entries_over_1e-4": over,
                     "losses_equal_bits": torch.equal(a["losses"], ref["losses"]),
                     "weights_equal_bits": all(torch.equal(a["weights"][k], v)
                                               for k, v in ref["weights"].items()),
                     "losses": ref["losses"].tolist()}
        log(f"[gloo] " + _losses_line(f"{name} per-step losses", ref["losses"]))
    log(f"[gloo] " + _losses_line("2 ranks (-b 1 each) per-step losses", a["losses"]))
    g_rel, g_over = _rel_by_tensor(a["grads"], one["grads"], GLOO_GRAD_RTOL)
    g_worst = max(g_rel, key=g_rel.get)
    res["one_process_b2"].update(grad_max_rel=g_rel[g_worst], grad_worst=g_worst)
    o, m = res["one_process_b2"], res["same_arithmetic"]
    ok = (ranks_equal and a["replay"] == PER_STEP and o["loss_max_rel"] <= GLOO_LOSS_RTOL
          and o["grad_max_rel"] <= GLOO_GRAD_RTOL and m["loss_max_rel"] <= GLOO_SAME_LOSS_RTOL
          and m["weight_max_rel"] <= GLOO_WEIGHT_RTOL)
    log(f"[gloo] two gloo ranks on {a['device']} ({a['backend']}), f32, {GLOO_STEPS} steps, -b 1 "
        f"each; vs one process at -b 2: losses max rel {o['loss_max_rel']:.3e} (tol "
        f"{GLOO_LOSS_RTOL:g}), first-step gradients max |d|/max|ref| {o['grad_max_rel']:.3e} at "
        f"{g_worst} (tol {GLOO_GRAD_RTOL:g}), final weights max |d|/max|ref| "
        f"{o['weight_max_rel']:.3e} at {o['weight_worst']} (reported; entries over 1e-4 by "
        f"tensor {o['entries_over_1e-4']}); vs one process running the step's own arithmetic: "
        f"losses max rel {m['loss_max_rel']:.3e} (tol {GLOO_SAME_LOSS_RTOL:g}, equal bits "
        f"{m['losses_equal_bits']}), weights max |d|/max|ref| {m['weight_max_rel']:.3e} (tol "
        f"{GLOO_WEIGHT_RTOL:g}, equal bits {m['weights_equal_bits']}); the ranks equal to the "
        f"bit {ranks_equal}; a replayed step launches {a['replay']} a rank; {a['ms']:.3f} / "
        f"{b['ms']:.3f} ms a step (ranks 0 / 1, CUDA events, epoch 1: gloo copies the bucket "
        f"through host memory); both processes {wall:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("two gloo ranks differ from one process at the global batch")
    return res


def _rel_by_tensor(got: dict, ref: dict, bound: float):
    """max |got - ref| / max |ref| per tensor, and the entries over ``bound``
    of it by tensor."""
    rel, over = {}, {}
    for k, v in ref.items():
        if not v.numel():
            continue
        scale = v.abs().max().clamp_min(1e-30)
        d = (got[k] - v).abs()
        rel[k] = (d.max() / scale).item()
        if rel[k] > bound:
            over[k] = int((d > bound * scale).sum())
    return rel, over


def _one_process_b2(cfg: TrainConfig, store: FrameStore, rows: np.ndarray) -> dict:
    """One process at -b 2 from the seed's weights: the first step's
    gradients (no update), then the fused epoch over ``rows``."""
    from repnerv_tpu_torch.train.loop import _make_forward_backward

    state = init_train_state(cfg, "cuda", seed=SEED)
    t_all = torch.from_numpy(store.t.astype(np.float32)).cuda()
    idx = torch.from_numpy(rows[0]).cuda()
    _make_forward_backward(cfg, None)(state, store.gather(idx), t_all[idx])
    grads = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
    state = init_train_state(cfg, "cuda", seed=SEED)
    state, aux = make_epoch_fn(cfg, GLOO_STEPS, with_msssim=True)(state, store, rows, None)
    return {"losses": aux["loss"].cpu().clone(), "grads": grads,
            "weights": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def _accumulated_steps(cfg: TrainConfig, store: FrameStore, rows: np.ndarray) -> dict:
    """One process doing the data-parallel step's arithmetic: per step, the
    two frames of ``rows`` through the -b 1 forward and backward one after the
    other (rank 0's, then rank 1's), their gradients summed and halved and the
    losses so (the all-reduce and the division), then Adam at the step's
    rate; eager."""
    from repnerv_tpu_torch.train.loop import _make_forward_backward, _schedule, apply_update
    from repnerv_tpu_torch.train.schedule import lr_table

    state = init_train_state(cfg, "cuda", seed=SEED)
    fb = _make_forward_backward(dataclasses.replace(cfg, data=DataConfig(batch_size=1)), None)
    lrs = lr_table(0, len(rows), **_schedule(cfg, GLOO_STEPS))
    t_all = torch.from_numpy(store.t.astype(np.float32)).cuda()
    params = list(state.model.parameters())
    losses = []
    for k, pair in enumerate(rows):
        grads, frame_losses = [], []
        for r in pair:
            idx = torch.tensor([int(r)], device="cuda")
            _, _, loss = fb(state, store.gather(idx), t_all[idx])
            grads.append([p.grad.clone() for p in params])
            frame_losses.append(loss)
        for p, g0, g1 in zip(params, *grads):
            p.grad = (g0 + g1) / 2
        apply_update(state, None, float(lrs[k]))
        losses.append((frame_losses[0] + frame_losses[1]) / 2)
    state.step += len(rows)
    return {"losses": torch.stack(losses).cpu(),
            "weights": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def phase_mesh_decode(rnvb: str) -> dict:
    """(e) decode_main --mesh_shape 1 on phase 8's .rnvb, bf16 and int8:
    frames of the sharded graph decode equal the plain graph decode's and
    the eager batch's to the bit;
    launches per batch; fps beside the run without the flag, in turns."""
    from repnerv_tpu_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    n_batches = SERVE_FRAMES // SERVE_BATCH
    passes = n_batches * (1 + DECODE_REPS)
    results = {}
    for int8 in (False, True):
        name = "int8" if int8 else "bfloat16"
        extra = ["--decode_int8"] if int8 else []
        per_batch = {"K1": 2, "K2": 2} if int8 else {"K1": 4, "K2": 0}
        fps = {False: [], True: []}
        counts = {}
        for mesh1 in (False, True, True, False):
            reset_counts()  # the main path's run starts here
            res = decode_main.main([rnvb, "--frames", str(SERVE_FRAMES), "--batch",
                                    str(SERVE_BATCH)] + extra + (["--mesh_shape", "1"] if mesh1
                                                                 else []))
            counts[mesh1] = launch_counts()  # ... and ends here
            fps[mesh1].append(res["fps"])
            if res["batch"] != SERVE_BATCH:
                raise AssertionError(f"decode_main --mesh_shape 1 took batch {res['batch']}")
        for mesh1 in (False, True):
            got = {k: counts[mesh1][k] for k in per_batch}
            if got != {k: v * passes for k, v in per_batch.items()}:
                raise AssertionError(f"{name}: decode launched {got} over {passes} batches")
        # the run without the flag again, with a world of one alive in the
        # process (what --mesh_shape 1 adds besides its decode path)
        group_fps = []
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        try:
            for _ in range(2):
                group_fps.append(decode_main.main([rnvb, "--frames", str(SERVE_FRAMES),
                                                   "--batch", str(SERVE_BATCH)] + extra)["fps"])
        finally:
            sharding.close_mesh(mesh)
        st, acfg, _ = read_bitstream(rnvb)
        model = decode_main.serving_model(st, dataclasses.replace(acfg, decode_int8=int8), dev)
        if int8:
            calib = torch.arange(min(8, SERVE_FRAMES), dtype=torch.float32, device=dev) / SERVE_FRAMES
            model = calibrate_int8(model, positional_encoding(calib, model.cfg.embed))
        cfg = TrainConfig(model=model.cfg)
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        saved = _deterministic(True)
        try:
            # both one graph replay a batch; the eager batch beside them
            plain, shard = make_decode_fn(cfg), sharding.make_sharded_decode(cfg, mesh)
            equal, equal_eager = [], []
            for i in range(n_batches):
                t = torch.arange(i * SERVE_BATCH, (i + 1) * SERVE_BATCH, dtype=torch.float32,
                                 device=dev) / SERVE_FRAMES
                got = shard(model, t)
                equal.append(torch.equal(plain(model, t), got))
                equal_eager.append(torch.equal(decode_batch(model, cfg, t), got))
        finally:
            _deterministic(saved)
            sharding.close_mesh(mesh)
        res = {"frames_equal_bits": all(equal), "eager_frames_equal_bits": all(equal_eager),
               "launches_per_batch": per_batch,
               "fps": statistics.mean(fps[False]), "fps_runs": fps[False],
               "mesh1_fps": statistics.mean(fps[True]), "mesh1_fps_runs": fps[True],
               "group_alive_fps_runs": group_fps}
        log(f"[mesh] decode {name}: {SERVE_FRAMES} frames, batch {SERVE_BATCH}: --mesh_shape 1 "
            f"graph frames vs the plain graph decode equal bits {equal}, vs the eager batch "
            f"{equal_eager}; launches {per_batch} a batch on "
            f"both; fps {res['mesh1_fps']:.2f} ({', '.join(f'{x:.2f}' for x in fps[True])}) with "
            f"the flag, {res['fps']:.2f} ({', '.join(f'{x:.2f}' for x in fps[False])}) without "
            f"(decode_main, in turns), then without the flag but with an NCCL world of one alive "
            f"in the process {', '.join(f'{x:.2f}' for x in group_fps)}")
        if not all(equal) or not all(equal_eager):
            raise AssertionError(f"{name}: the sharded decode's frames differ from the plain ones")
        results[name] = res
        del model
        torch.cuda.empty_cache()
    return results


def phase_multi(tmp: str, rnvb: str) -> dict:
    """Phase 10: the suite and multi-GPU slice."""
    return {"suite": phase_suite(tmp), "mesh_train": phase_mesh_train(tmp),
            "gloo": phase_gloo(tmp), "mesh_decode": phase_mesh_decode(rnvb)}


# phase 11, tensor parallelism over a "model" axis and --norm bn over data
# ranks, on the paper flagship (720p ERB, Fusion6, MS-SSIM every step) from
# the seed's weights.  The one card holds every rank: gloo processes (this
# script with --tp-rank) on cuda:0, as phase 10 (d).  Per rank and step, the
# model axis of 2 runs 4 K3 (blocks 1-4 on 48-channel shards: bf16 3 wgmma +
# 1 wmma, f32 3 wgmma_tf32x3 + 1 fma), 4 K4 (block 4 without its head: the
# head runs row parallel outside the kernel) and 7 K5 (loss and metrics on
# the whole output, on every rank).  Against one process's eager step at the
# global batch from the same weights: the phase 6 bounds (STEP_TOL) on the
# per-step losses and the first step's gradients (all-reduced over the data
# group, gathered over the model group, / the data axis); the final weights
# are reported, not bounded (PERF.md: Adam amplifies summation noise).
TP_JOBS = [  # (name, mesh shape, axes, compute dtype, global batch, norm, steps)
    ("tp_bf16", (1, 2), ("data", "model"), "bfloat16", 1, "none", 8),
    ("tp_f32", (1, 2), ("data", "model"), "float32", 1, "none", 8),
    ("bn_data", (2,), ("data",), "float32", 2, "bn", 4),
]
TP_JOBS_4 = [("tp_2x2", (2, 2), ("data", "model"), "float32", 2, "none", 4)]
TP_TIME_STEPS = 4  # steps of a second epoch under CUDA events, then 2 under torch.profiler
TP_TIMEOUT_S = 900
BN_PER_STEP = {"K3": 0, "K4": 0, "K5": 7}  # the K3 gate needs norm none
TP_ROUTES = {"bfloat16": {"wgmma": 3, "wmma": 1}, "float32": {"wgmma_tf32x3": 3, "fma": 1}}
# one model rank's stages at M = 2 (Cout 384 -> 192: c = 48), -b 1
TP_SHAPES = [
    ("block1/2", 45, 80, 26, 48, 2, False),
    ("block2/2", 90, 160, 96, 48, 2, False),
    ("block3/2", 180, 320, 96, 48, 2, False),
    ("block4/2", 360, 640, 96, 48, 2, False),
]


def _tp_cfg(dtype: str, batch: int, norm: str) -> TrainConfig:
    cfg = _train_cfg(dtype, True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, norm=norm),
                               data=DataConfig(batch_size=batch))


def _tp_store() -> FrameStore:
    video, t = synthetic_video(TRAIN_FRAMES, 720, 1280, seed=0)
    return FrameStore(frames=torch.from_numpy(video).cuda(), t=t)


def tp_rank_main(rank: int, world: int, init_file: str, out_path: str, names: str) -> None:
    """One gloo rank of phase 11 on cuda:0: for each job named, the sharded
    step's first-step gradients (no update), then ``steps`` steps of
    ``make_sharded_epoch_fn`` from the seed's weights (counts, collective
    bytes, losses, the gathered weights), then ms a step of a second epoch
    (CUDA events) and the device ms of two more steps (torch.profiler)."""
    from repnerv_tpu_torch.parallel import collectives, sharding

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as the one process it is held against
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                         world_size=world)
    store = _tp_store()
    t_all = torch.from_numpy(store.t.astype(np.float32)).cuda()
    jobs = {j[0]: j for j in TP_JOBS + TP_JOBS_4}
    out = {}
    for name in names.split(","):
        _, shape, axes, dtype, batch, norm, steps = jobs[name]
        mesh = sharding.make_mesh(shape, axes, "cuda")
        cfg = _tp_cfg(dtype, batch, norm)
        rows = epoch_rows(store, cfg, 0)[:steps]
        probe = sharding.shard_train_state(init_train_state(cfg, "cuda", seed=SEED), mesh)
        dp = sharding.DataParallelUpdate(cfg, True, None, mesh)
        local = torch.from_numpy(rows[0][sharding.local_batch(rows.shape[1], mesh)]).cuda()
        dp.forward_backward(probe, store.gather(local), t_all[local])
        dp.reduce()
        grads = {k: p.grad / mesh.data_size for k, p in probe.model.named_parameters()}
        if probe.model.shard_specs is not None:
            grads = sharding.gather_state_dict(grads, probe.model.shard_specs, mesh)
        grads = {k: v.float().cpu() for k, v in grads.items()}
        del probe, dp
        state = sharding.shard_train_state(init_train_state(cfg, "cuda", seed=SEED), mesh)
        fn = sharding.make_sharded_epoch_fn(cfg, steps, mesh, with_msssim=True)
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        for k in collectives.BYTES:
            collectives.BYTES[k] = 0
        t0 = time.perf_counter()
        state, aux = fn(state, store, rows, None)
        losses = aux["loss"].cpu().clone()
        wall = time.perf_counter() - t0
        counts, routes = launch_counts(), dict(tt.FWD_ROUTE_LAUNCHES)  # ... and ends here
        moved = dict(collectives.BYTES)
        whole = sharding.gather_train_state(state, mesh)
        weights = {k: v.detach().float().cpu().clone() for k, v in whole.model.state_dict().items()}
        del whole
        rows1 = epoch_rows(store, cfg, 1)[:TP_TIME_STEPS]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = fn(state, store, rows1, None)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / TP_TIME_STEPS
        ms = start.elapsed_time(end) / TP_TIME_STEPS
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d, trace(d) as rec:
            t0 = time.perf_counter()
            state, _ = fn(state, store, epoch_rows(store, cfg, 2)[:2], None)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / 2
        events = [(k.lower(), us) for k, us in device_us(rec.profiler).items()]
        device_ms = sum(us for _, us in events) / 1e3 / 2
        # gloo's copies of the collectives' tensors between the card and the host
        copy_ms = sum(us for key, us in events if "memcpy" in key) / 1e3 / 2
        out[name] = {"losses": losses, "grads": grads, "weights": weights, "launches": counts,
                     "routes": routes, "bytes": moved, "wall_s": wall, "ms": ms,
                     "host_ms": host_ms, "profiled_ms": prof_ms, "device_ms": device_ms,
                     "copy_ms": copy_ms,
                     "rank": mesh.rank, "data_index": mesh.data_index,
                     "model_index": mesh.model_index, "type": type(fn).__name__,
                     "captures": fn.captures, "backend": torch.distributed.get_backend()}
        del state, fn
        torch.cuda.empty_cache()
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


def _spawn_tp(tmp: str, world: int, jobs: list, tag: str) -> list:
    init = os.path.join(tmp, f"{tag}_init")
    outs = [os.path.join(tmp, f"{tag}_rank{r}.pt") for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    names = ",".join(j[0] for j in jobs)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               str(world), init, outs[r], names], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag} rank {r} exited {p.returncode}:\n{text[-4000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def _one_process(cfg: TrainConfig, store: FrameStore, rows: np.ndarray) -> dict:
    """One process at the global batch from the seed's weights, eager: the
    first step's gradients (no update), then the steps over ``rows``."""
    from repnerv_tpu_torch.train.loop import _make_forward_backward

    state = init_train_state(cfg, "cuda", seed=SEED)
    t_all = torch.from_numpy(store.t.astype(np.float32)).cuda()
    idx = torch.from_numpy(rows[0]).cuda()
    _make_forward_backward(cfg, None)(state, store.gather(idx), t_all[idx])
    grads = {k: p.grad.float().cpu() for k, p in state.model.named_parameters()}
    state = init_train_state(cfg, "cuda", seed=SEED)
    step = build_train_step_fn(cfg, len(rows), with_msssim=True)
    losses = []
    for r in torch.from_numpy(rows).cuda():
        state, aux = step(state, store.gather(r), t_all[r])
        losses.append(aux["loss"])
    return {"losses": torch.stack(losses).float().cpu(), "grads": grads,
            "weights": {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}}


def _tp_check(job: tuple, ranks: list, store: FrameStore, smi: str) -> dict:
    """Each rank of ``job`` against one process at the global batch."""
    name, shape, axes, dtype, batch, norm, steps = job
    cfg = _tp_cfg(dtype, batch, norm)
    saved = _deterministic(True)
    try:
        one = _one_process(cfg, store, epoch_rows(store, cfg, 0)[:steps])
    finally:
        _deterministic(saved)
    loss_tol, grad_tol = STEP_TOL[dtype]
    per_step = BN_PER_STEP if norm == "bn" else PER_STEP
    want_routes = dict.fromkeys(dk.ROUTES, 0)
    if norm != "bn":
        want_routes.update({k: v * steps for k, v in TP_ROUTES[dtype].items()})
    res = {"ranks": []}
    ok = True
    for r in ranks:
        got = r[name]
        loss_rel = ((got["losses"] - one["losses"]).abs() / one["losses"].abs()).max().item()
        g_rel, _ = _rel_by_tensor(got["grads"], one["grads"], grad_tol)
        w_rel, w_over = _rel_by_tensor(got["weights"], one["weights"], GLOO_WEIGHT_RTOL)
        g_worst, w_worst = max(g_rel, key=g_rel.get), max(w_rel, key=w_rel.get)
        launches = {k: got["launches"][k] for k in per_step}
        want = {k: v * steps for k, v in per_step.items()}
        rank_ok = (loss_rel <= loss_tol and g_rel[g_worst] <= grad_tol and launches == want
                   and got["routes"] == want_routes and got["type"] == "ShardedEpoch"
                   and got["captures"] == 0 and bool(torch.isfinite(got["losses"]).all()))
        ok = ok and rank_ok
        idle = 1 - got["device_ms"] / got["profiled_ms"] if got["profiled_ms"] else None
        row = {"rank": got["rank"], "data_index": got["data_index"],
               "model_index": got["model_index"], "loss_max_rel": loss_rel,
               "grad_max_rel": g_rel[g_worst], "grad_worst": g_worst,
               "weight_max_rel": w_rel[w_worst], "weight_worst": w_worst,
               "weight_entries_over_1e-4": w_over, "launches": launches, "routes": got["routes"],
               "bytes_per_step": {k: v / steps for k, v in got["bytes"].items()},
               "ms": got["ms"], "host_ms": got["host_ms"], "profiled_ms": got["profiled_ms"],
               "device_ms": got["device_ms"], "copy_ms": got["copy_ms"], "idle_share": idle,
               "wall_s": got["wall_s"],
               "losses": got["losses"].tolist(), "ok": rank_ok}
        res["ranks"].append(row)
        log(f"[tp] {name}: rank {row['rank']} (data {row['data_index']}, model "
            f"{row['model_index']}, {got['backend']}) " + _losses_line("per-step losses",
                                                                       got["losses"]))
        log(f"[tp] {name}: rank {row['rank']} vs one process at -b {batch}: losses max rel "
            f"{loss_rel:.3e} (tol {loss_tol:g}); first-step gradients max |d|/max|ref| "
            f"{g_rel[g_worst]:.3e} at {g_worst} (tol {grad_tol:g}); final weights max "
            f"|d|/max|ref| {w_rel[w_worst]:.3e} at {w_worst} (reported); launches "
            f"{launches} (expect {want}), K3 by route "
            f"{ {k: v for k, v in got['routes'].items() if v} }; collectives move "
            f"{ {k: round(v / steps / 2**20, 3) for k, v in got['bytes'].items()} } MiB a step; "
            f"{got['ms']:.3f} ms a step (CUDA events over {TP_TIME_STEPS} steps; host "
            f"{got['host_ms']:.3f}), device {got['device_ms']:.3f} ms (copies to and from the "
            f"host {got['copy_ms']:.3f}) of {got['profiled_ms']:.3f} ms a profiled step (idle "
            f"share {idle if idle is None else round(idle, 3)}) "
            f"[{smi}] {'ok' if rank_ok else 'FAIL'}")
    log(f"[tp] {name}: " + _losses_line(f"one process at -b {batch} per-step losses",
                                        one["losses"]))
    res.update(ok=ok, losses=one["losses"].tolist(), mesh=list(shape), axes=list(axes),
               dtype=dtype, batch=batch, norm=norm, steps=steps)
    if not ok:
        raise AssertionError(f"phase 11 {name}: the ranks differ from one process")
    return res


def _tp_train_main(tmp: str, smi: str) -> dict:
    """(c) train_main --mesh_shape 1 1 --mesh_axes data model (an NCCL world
    of one through the CUDA graph) against the run without the flag, f32, one
    epoch: per-step losses to the bit, launches of a replayed step."""
    runs = {}
    cwd = os.getcwd()
    saved = _deterministic(True)
    os.chdir(tmp)
    try:
        for name, extra in (("plain", []), ("mesh11", ["--mesh_shape", "1", "1",
                                                        "--mesh_axes", "data", "model"])):
            argv = [a if TRAIN_ARGV[i - 1] != "-e" else "1" for i, a in enumerate(TRAIN_ARGV)]
            with EpochRecorder() as rec:
                reset_counts()  # the main path's run starts here
                res = train_main.main(argv + ["--compute_dtype", "float32", "--outf",
                                              f"tp_{name}"] + extra)
                counts = launch_counts()  # ... and ends here
            fn, = rec.epoch_fns()
            runs[name] = {"losses": torch.cat([c[2].cpu() for c in rec.calls]),
                          "replay": {k: launches_of(fn.replay_counts)[k] for k in PER_STEP},
                          "type": type(fn).__name__, "captures": fn.captures,
                          "launches": counts, "history": res["history"]}
    finally:
        os.chdir(cwd)
        _deterministic(saved)
    a, b = runs["plain"], runs["mesh11"]
    equal = torch.equal(a["losses"], b["losses"])
    ok = (equal and b["replay"] == a["replay"] == PER_STEP and b["type"] == "ShardedEpoch"
          and b["captures"] == 1 and b["launches"] == a["launches"])
    log(f"[tp] train_main --mesh_shape 1 1 --mesh_axes data model ({b['type']}, NCCL world of "
        f"one) vs without ({a['type']}), f32, {len(a['losses'])} steps: per-step losses equal "
        f"bits {equal}; a replayed step launches {b['replay']} vs {a['replay']}; captures "
        f"{b['captures']}; launches {b['launches']} vs {a['launches']} [{smi}] "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_main over a (1, 1) data x model mesh differs from the plain run")
    return {"losses_equal_bits": equal, "replay_launches": b["replay"],
            "launches": b["launches"], "steps": len(a["losses"])}


def phase_tp_kernels() -> dict:
    """Phase 11 (e): K3 / K4 at a model rank's shard shapes, beside phase 5
    (run there: a bare torch.profiler session lost the kernels of short
    traces after phase 10, ROADMAP C24)."""
    return stage_train_rows(TP_SHAPES, torch.Generator().manual_seed(SEED + 11), "tp-kernels")


def phase_profiler_probe() -> dict:
    """After phase 10: K4 and K5 once more under torch.profiler at phase 11
    (e)'s block-4 shard (f32), and whether the wrappers launched and the
    profiler saw their kernels (ROADMAP C24: short traces lost them here
    before ``utils/profiling.py::trace`` primed and padded its window);
    launches that moved with no kernel seen point at the profiler, launches
    that did not move at the path (which fails here).  ``TRACES`` holds
    every trace of the run."""
    g = torch.Generator().manual_seed(SEED + 12)
    dev = torch.device("cuda", 0)
    _, h, w, cin, c, s, _ = TP_SHAPES[-1]
    x = torch.randn(1, h, w, cin, generator=g).to(dev)
    wt = ((torch.rand(3, 3, cin, c * s * s, generator=g) * 2 - 1) * (9 * cin) ** -0.5).to(dev)
    p = dk.pack_weights(wt, torch.zeros(c * s * s, device=dev), s, torch.float32)
    out, z = tt.stage_forward(x, p, "swish", "tanh")
    ct = torch.randn(out.shape, generator=g).to(dev)
    img = torch.rand(1, 720, 1280, 1, generator=g).to(dev)
    win = sb.window_tuple(11, 1.5)
    probes = {"K4": (lambda: tt.epilogue_backward(z, ct, None, None, s, "swish", "tanh"),
                     "epilogue_bwd"),
              "K5": (lambda: sb.stats_forward(img, img, win, SSIM_C1, SSIM_C2, False),
                     "blur_tiles")}
    out_rows = {}
    for name, (fn, fragment) in probes.items():
        launched, seen = profile_kernels(fn, fragment)
        us = sum(v for k, v in seen.items() if fragment in k.lower())
        log(f"[profiler-probe] {name} after phase 10: 5 calls launched {launched}; the profiler "
            f"saw {len(seen)} kernels, *{fragment}* {us / 1e3 / 5:.4f} ms a call on the card"
            + ("" if us else f" (none: it saw {sorted(seen)[:8]})")
            + f"; {empty_traces()} empty and {short_traces()} short traces of {len(TRACES)} "
            "in the run so far")
        if launched < 5:
            raise AssertionError(f"{name}: 5 calls launched {launched} kernels")
        out_rows[name] = {"launched": launched, "kernels_seen": len(seen),
                          "device_ms": us / 1e3 / 5 if us else None}
    del x, out, z, ct, img
    torch.cuda.empty_cache()
    return out_rows


def phase_tp(tmp: str, smi: str, kernel_rows: dict) -> dict:
    """Phase 11: (a) two gloo ranks over a (1, 2) data x model mesh, bf16
    and f32, and (d) --norm bn over two data ranks, in one world; (b) four
    ranks over (2, 2); (c) train_main over a (1, 1) data x model mesh; with
    (e)'s ``kernel_rows``."""
    out = {"kernels": kernel_rows}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks2 = _spawn_tp(tmp, 2, TP_JOBS, "tp2")
    ranks4 = _spawn_tp(tmp, 4, TP_JOBS_4, "tp4")
    out["ranks_wall_s"] = time.perf_counter() - t0
    store = _tp_store()
    for job in TP_JOBS:
        out[job[0]] = _tp_check(job, ranks2, store, smi)
    out[TP_JOBS_4[0][0]] = _tp_check(TP_JOBS_4[0], ranks4, store, smi)
    del store
    torch.cuda.empty_cache()
    out["train_main"] = _tp_train_main(tmp, smi)
    return out


# phase 12, the quality check of ROADMAP C14: the first QUALITY_EPOCHS epochs
# of the paper recipe (repnerv_tpu_torch/tools/quality.py RECIPE: the ERB
# flagship on the 132-frame synthetic 720p video, bf16, -b 1, seed 1, the
# cosine schedule of -e 300) through train_main --stop_epoch, on the kernel
# path (the CUDA-graph step through K3 / K4 / K5) and with --no_pallas_train.
QUALITY_EPOCHS = 10
# train PSNR of epoch 10 (its rank0.txt line, 2 decimals) of the whole
# 300-epoch run (a) that PERF.md's "Quality on the card" reports: seed 1,
# `python -m repnerv_tpu_torch.tools.quality --work c14`, NVIDIA H100 80GB
# HBM3, 700.00 W; val PSNR 31.33 dB at epoch 300
QUALITY_EPOCH10_PSNR = 14.60
# two repeats of the check on each path, in the same call, logged the same
# epoch-10 PSNR to the log's 2 decimals (kernel path 14.60 and 14.60,
# --no_pallas_train 14.75 and 14.75): a spread under 0.005 dB, so the bound
# is max(0.3, 3 x 0.005) dB
QUALITY_SPREAD_DB = 0.005
QUALITY_BOUND_DB = max(0.3, 3 * QUALITY_SPREAD_DB)


def phase_quality(tmp: str) -> dict:
    """Phase 12: train_main on the first QUALITY_EPOCHS epochs of the C14
    recipe, kernel path then --no_pallas_train: launches a step, PSNR
    rising, the two paths' epoch-10 train PSNR within QUALITY_BOUND_DB of
    each other and of the 300-epoch run's."""
    from repnerv_tpu_torch.tools.quality import RECIPE

    steps = 132 * QUALITY_EPOCHS
    recipe = RECIPE + ["--branch_type", "ERB", "--manualSeed", "1"]
    argv = recipe + ["--stop_epoch", str(QUALITY_EPOCHS), "--device", "cuda"]
    cwd, out = os.getcwd(), {}
    for use_kernel in (True, False):
        name = "kernel" if use_kernel else "library"
        per_step = PER_STEP if use_kernel else PER_STEP_MIXED  # the library path: K5 only
        os.chdir(tmp)  # train_main writes under result/<outf>
        try:
            reset_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            with plain_fold(not use_kernel):
                res = train_main.main(argv + ["--outf", f"quality_{name}"]
                                      + ([] if use_kernel else ["--no_pallas_train"]))
            wall = time.perf_counter() - t0
            counts = launch_counts()  # ... and ends here
        finally:
            os.chdir(cwd)
        psnr = [h["psnr"][-1] for h in res["history"]]
        want = {k: v * steps for k, v in per_step.items()}
        got = {k: counts[k] for k in per_step}
        log(f"[quality] {name} path: train_main {QUALITY_EPOCHS} epochs x 132 steps of the C14 "
            f"recipe in {wall:.1f} s; launches {got} (expect {want}); train PSNR by epoch "
            + ", ".join(f"{p:.4f}" for p in psnr))
        if got != want:
            raise AssertionError(f"[quality] {name}: launches {got}, expected {want}")
        if not all(np.isfinite(psnr)) or not psnr[-1] > psnr[0]:
            raise AssertionError(f"[quality] {name}: PSNR did not rise: {psnr}")
        out[name] = {"psnr": psnr, "wall_s": wall, "launches": got}
        if use_kernel:
            out["val_sweep"] = val_sweep_turns(res["state"].model, recipe)
        del res
        torch.cuda.empty_cache()
    k10, l10 = out["kernel"]["psnr"][-1], out["library"]["psnr"][-1]
    log(f"[quality] epoch {QUALITY_EPOCHS} train PSNR: kernel path {k10:.4f}, --no_pallas_train "
        f"{l10:.4f} (|d| {abs(k10 - l10):.4f}), the 300-epoch run {QUALITY_EPOCH10_PSNR:.4f} "
        f"(|d| {abs(k10 - QUALITY_EPOCH10_PSNR):.4f}); bound {QUALITY_BOUND_DB} dB "
        f"(max of 0.3 and 3x the repeats' spread {QUALITY_SPREAD_DB})")
    if abs(k10 - l10) > QUALITY_BOUND_DB:
        raise AssertionError(f"[quality] the kernel path's epoch-{QUALITY_EPOCHS} PSNR {k10:.4f} "
                             f"is more than {QUALITY_BOUND_DB} dB from the library path's "
                             f"{l10:.4f}: run the ladder of PERF.md 'Quality on the card'")
    if abs(k10 - QUALITY_EPOCH10_PSNR) > QUALITY_BOUND_DB:
        raise AssertionError(f"[quality] the kernel path's epoch-{QUALITY_EPOCHS} PSNR {k10:.4f} "
                             f"is more than {QUALITY_BOUND_DB} dB from the 300-epoch run's "
                             f"{QUALITY_EPOCH10_PSNR:.4f}: run the ladder of PERF.md 'Quality "
                             f"on the card'")
    return out


def val_sweep_turns(model, recipe: list) -> dict:
    """The val sweep of train_main's evaluation (the recipe's 132 frames,
    -b 1, MS-SSIM on) on ``model``, the eager eval step
    (``build_eval_step_fn``) against the graph (``make_eval_step``, a fresh
    one a turn: the eager first batch, the capture and 131 replays, as each
    of train_main's sweeps), in turns (eager, graph, graph, eager), with
    cuDNN as train_main leaves it: seconds a sweep (``evaluate`` ends with its
    one fetch), and every turn's PSNR / MS-SSIM equal to the bit."""
    cfg = train_main.args_to_config(train_main.build_parser(eval_mode=False).parse_args(recipe),
                                    eval_mode=False)
    store = make_frame_store(cfg.data, torch.device("cuda", 0), split="train")
    val = dataclasses.replace(store, frame_gap=cfg.data.test_gap)
    with_msssim = min(val.hw) > 160
    turns, metrics = {"eager": [], "graph": []}, []
    for path in ("eager", "graph", "graph", "eager"):
        fn = (build_eval_step_fn(cfg, with_msssim) if path == "eager"
              else make_eval_step(cfg, with_msssim))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(evaluate(model, fn, val, cfg))
        turns[path].append(time.perf_counter() - t0)
        del fn
    equal = all(np.array_equal(m[0], metrics[0][0]) and np.array_equal(m[1], metrics[0][1])
                for m in metrics)
    res = {path: {"s": statistics.mean(r), "runs_s": r} for path, r in turns.items()}
    log(f"[quality] val sweep of the epoch-{QUALITY_EPOCHS} model ({val.num_samples} frames, -b "
        f"1, MS-SSIM {with_msssim}) in turns (eager, graph, graph, eager): eager "
        f"{res['eager']['s']:.4f} s ({', '.join(f'{x:.4f}' for x in turns['eager'])}), graph "
        f"{res['graph']['s']:.4f} s ({', '.join(f'{x:.4f}' for x in turns['graph'])}; each "
        f"with its capture); PSNR {metrics[0][0][-1]:.4f} MS-SSIM {metrics[0][1][-1]:.4f}, "
        f"equal bits in every turn {equal}")
    if not equal or not np.isfinite(metrics[0][0]).all():
        raise AssertionError(f"[quality] the val sweeps differ: {metrics}")
    res.update(equal_bits=equal, psnr=metrics[0][0].tolist(), msssim=metrics[0][1].tolist(),
               frames=val.num_samples)
    return res


# phase 13, train_main --profile: the flagship's first epoch traced (its
# first PROFILE_STEPS eager steps) and read back from the trace file
PROFILE_STEPS = 3
# kernel-name fragments of K3 (the stage forward of blocks 1-4: WMMA / FMA in
# decode.cu, the wgmma kernels), K4 and K5 in a training step's trace
PROFILE_KERNELS = {"K3": ("stage_wgmma", "tensor_core::kernel", "cuda_core::kernel"),
                   "K4": ("epilogue_bwd",), "K5": ("blur_tiles",)}
PROFILE_TOP = 10  # device ops listed by name


class TimedStep:
    """A train step that records two CUDA events around each call."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def trace_kernels(path: str) -> dict:
    """Kernel events of a chrome trace: count and device ms by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            n, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, us + float(e["dur"]))
    return out


def phase_profile(tmp: str, smi: str, phase6_ms: dict = None) -> dict:
    """Phase 13: train_main --profile on the flagship (bf16, -b 1, 16 720p
    frames, -e 2): the traced first epoch's launches, and its trace file read
    back: K3 / K4 / K5 kernel events equal to the launches (4 / 4 / 7 a step),
    the top device ops; ms of the traced steps (the graph step's eager first
    step with its capture, then replays) beside the untraced graph steps of
    epoch 2 (CUDA events around each step, the same process), and beside
    ``phase6_ms``, phase 6's bf16 graph steps of the same run."""
    made, traced = [], {}
    real_make, real_trace = train_main.make_train_step, train_main.trace

    def timed_make(*args, **kwargs):
        made.append(TimedStep(real_make(*args, **kwargs)))
        return made[-1]

    @contextlib.contextmanager
    def counted_trace(log_dir, device):
        before = launch_counts()
        with real_trace(log_dir, device) as rec:
            yield rec
        traced.update(launches={k: v - before[k] for k, v in launch_counts().items()},
                      launched=rec.launched, path=rec.path)

    argv = TRAIN_ARGV + ["--compute_dtype", "bfloat16", "--profile", "--outf", "profile"]
    cwd = os.getcwd()
    os.chdir(tmp)  # train_main writes under result/<outf>
    train_main.make_train_step, train_main.trace = timed_make, counted_trace
    try:
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        res = train_main.main(argv)
        wall = time.perf_counter() - t0
        counts = launch_counts()  # ... and ends here
        outf = os.path.abspath(res["outf"])
    finally:
        train_main.make_train_step, train_main.trace = real_make, real_trace
        os.chdir(cwd)
    files = sorted(glob.glob(os.path.join(outf, "profile", "*.pt.trace.json")))
    with open(os.path.join(outf, "rank0.txt")) as f:
        logged = f.read()
    if len(files) != 1 or os.path.basename(traced.get("path", "")) != os.path.basename(files[0]):
        raise AssertionError(f"[profile] trace files {files}, the trace wrote {traced}")
    if "profiler trace written to" not in logged or [h["epoch"] for h in res["history"]] != [2]:
        raise AssertionError("[profile] epoch 1 is not the traced epoch alone")
    steps = PROFILE_STEPS + TRAIN_FRAMES
    if res["state"].step != steps:
        raise AssertionError(f"[profile] step counter {res['state'].step}, expected {steps}")
    kernels = trace_kernels(files[0])
    in_file = {k: sum(n for name, (n, _) in kernels.items() if any(f in name for f in frags))
               for k, frags in PROFILE_KERNELS.items()}
    want = {k: PER_STEP[k] * PROFILE_STEPS for k in PROFILE_KERNELS}
    launched = {k: traced["launches"][k] for k in PROFILE_KERNELS}
    whole = {k: PER_STEP[k] * steps + PER_EVAL_FRAME[k] * TRAIN_FRAMES for k in PROFILE_KERNELS}
    got_whole = {k: counts[k] for k in PROFILE_KERNELS}
    log(f"[profile] train_main --profile (bf16, -b 1, 720p, -e 2) in {wall:.1f} s; the traced "
        f"epoch's {PROFILE_STEPS} steps: kernel events in {os.path.basename(files[0])} "
        f"{in_file}, launches {launched} (expect {want}); the whole run's launches {got_whole} "
        f"(expect {whole}: {steps} steps, 16 eval frames)")
    if in_file != want or launched != want or got_whole != whole:
        raise AssertionError(f"[profile] kernel events {in_file}, launches {launched}, whole run "
                             f"{got_whole}; expected {want} and {whole}")
    busy = sum(us for _, us in kernels.values()) / 1e3 / PROFILE_STEPS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:PROFILE_TOP]
    log(f"[profile] top device ops of the traced steps (ms a step, events a step): "
        + "; ".join(f"{us / 1e3 / PROFILE_STEPS:.3f} x{n / PROFILE_STEPS:g} {name[:80]}"
                    for name, (n, us) in top)
        + f"; all kernels {busy:.3f} ms a step, {len(kernels)} names")
    ms = made[0].ms()
    traced_ms, graph_ms = ms[:PROFILE_STEPS], ms[PROFILE_STEPS:]
    captures = made[0].step.captures
    beside = ("" if not phase6_ms else "; phase 6's bf16 graph steps in this run: "
              + ", ".join(f"{k} {v:.3f}" for k, v in phase6_ms.items()))
    log(f"[profile] ms a step (CUDA events around each step): traced "
        + ", ".join(f"{v:.3f}" for v in traced_ms)
        + f" (the first with its capture); untraced graph steps of epoch 2: median "
        f"{statistics.median(graph_ms):.3f}, min {min(graph_ms):.3f}, max {max(graph_ms):.3f} "
        f"({len(graph_ms)} steps); {captures} capture in the run{beside}; {smi}")
    if captures != 1:
        raise AssertionError(f"[profile] the graph step captured {captures} times")
    return {"launches": launched, "whole_run_launches": got_whole, "kernel_events": in_file,
            "traced_ms": traced_ms, "graph_ms": graph_ms, "captures": captures,
            "phase6_ms": phase6_ms, "kernel_ms_a_step": busy,
            "top": [{"kernel": name, "ms": us / 1e3 / PROFILE_STEPS, "events": n}
                    for name, (n, us) in top],
            "wall_s": wall, "trace_bytes": os.path.getsize(files[0])}


def main() -> None:
    device = phase_device()
    phase_build()
    kernel_rows = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        train_rows = phase_train_kernels()
        fold_rows = phase_fold()
        tp_rows = phase_tp_kernels()
        train = phase_train(tmp)
        int8_rows = phase_int8_kernel()
        compress = phase_compress(tmp)
        ooc = phase_outofcore(tmp, compress["path-a"]["launches"])
        multi = phase_multi(tmp, os.path.join(tmp, "result", "bfloat16",
                                              f"model_pr{PRUNE:.2f}_q{QBIT}.rnvb"))
        probe = phase_profiler_probe()
        tp = phase_tp(tmp, device["smi"], tp_rows)
        quality = phase_quality(tmp)
        profile = phase_profile(tmp, device["smi"], {
            "fused epoch": train["bfloat16"]["graph"]["graph"]["ms"],
            "make_train_step": train["bfloat16"]["step_graph"]["step-graph"]["ms"]})
    for name in sys.modules:
        if name.split(".")[0] in ("jax", "jaxlib", "repnerv_tpu"):
            raise AssertionError(f"the port imported {name}")

    def yardsticks(rows: list) -> dict:
        """bound_ms / bound_by / library_ms of a kernel over its main-path
        rows, and over its rows on a wgmma route their time beside the time
        of the kernel that ran them before (WMMA, or FMA in f32)."""
        out = sum_bounds(rows)
        for key in ("library_ms", "library_tf32_ms", "bf16_kernel_ms"):
            have = [r[key] for r in rows if key in r]
            if have:
                out[key] = sum(have)
        out.setdefault("library_ms", None)
        for old in ("wmma", "fma"):
            mine = [r for r in rows if f"{old}_ms" in r]
            if mine:
                out["wgmma_rows_ms"] = sum(r["ms"] for r in mine)
                out[f"wgmma_rows_{old}_ms"] = sum(r[f"{old}_ms"] for r in mine)
                if old == "fma":  # what bounded those rows on the FMA pipes
                    out["wgmma_rows_bound_fma_ms"] = sum(r["bound_fma_ms"] for r in mine)
                    out["wgmma_rows_fma_max_abs_err"] = max(r["fma_max_abs_err"] for r in mine)
                    out["wgmma_rows_max_abs_err"] = max(r["max_abs_err"] for r in mine)
        return out

    def stage_sources(dname: str) -> dict:
        # blocks 2-4 run the type's wgmma kernel, block 1 (Cin 26) decode.cu's WMMA / FMA kernel
        wgmma = "decode_wgmma.cu" if dname == "bfloat16" else "decode_wgmma_tf32.cu"
        return {"source": f"repnerv_tpu_torch/csrc/{wgmma}",
                "other_sources": ["repnerv_tpu_torch/csrc/stage_wgmma.cuh",
                                  "repnerv_tpu_torch/csrc/decode.cu"]}

    kernels = []
    for dname, rows in kernel_rows.items():
        main_rows = [r for r in rows if r["shape"] in MAIN_PATH_SHAPES]
        kernels.append({
            "name": f"fused_conv_ps_act[{dname}]",
            "route": "cuda",
            **stage_sources(dname),
            "replaces": "repnerv_tpu/pallas_kernels/decode.py:79",
            "launches": serve[dname]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one batch of 8 frames through blocks 1-4 of the flagship
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            **yardsticks(main_rows),
            "shape_routes": {r["shape"]: r["route"] for r in rows},
            "shapes": rows,
            "serve": serve[dname],
        })
    sources = {
        "K3": ("stage_forward", None,  # stage_sources
               "repnerv_tpu/pallas_kernels/train_tail.py:83"),
        "K4": ("epilogue_backward", "repnerv_tpu_torch/csrc/train_tail.cu",
               "repnerv_tpu/pallas_kernels/train_tail.py:263"),
    }
    for key, (fn, src, replaces) in sources.items():
        for dname in ("float32", "bfloat16"):
            rows = [r for r in train_rows[key] if r["dtype"] == dname]
            srcs = stage_sources(dname) if key == "K3" else {"source": src}
            kernels.append({
                "name": f"{fn}[{dname}]", "route": "cuda", **srcs, "replaces": replaces,
                "launches": train[dname]["launches"][key],
                # the traced epoch of train_main --profile (phase 13, bf16)
                **({"profile_launches": profile["launches"][key]} if dname == "bfloat16"
                   else {}),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # blocks 1-4 of one -b 1 flagship training step
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **yardsticks(rows),
                **({"device_ms": sum(r["device_ms"] for r in rows),
                    "library_note": "no single PyTorch call computes the epilogue backward "
                                    "(squash and activation VJPs, the head's dW / db, the "
                                    "shuffle-major relayout and the bias sums)"}
                   if key == "K4" else {}),
                "shapes": rows,
            })
        # the same kernels at one model rank's shard shapes (phase 11 (e)), with
        # the launches of rank 0's steps over the (1, 2) mesh (phase 11 (a))
        for dname in ("float32", "bfloat16"):
            rows = [r for r in tp["kernels"][key] if r["dtype"] == dname]
            srcs = stage_sources(dname) if key == "K3" else {"source": src}
            job = "tp_f32" if dname == "float32" else "tp_bf16"
            kernels.append({
                "name": f"{fn}[{dname}, model shard 1/2]", "route": "cuda", **srcs,
                "replaces": replaces,
                "launches": tp[job]["ranks"][0]["launches"][key],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # blocks 1-4 of one rank's -b 1 step over a model axis of 2 (c = 48)
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **yardsticks(rows),
                **({"device_ms": sum(r["device_ms"] for r in rows),
                    "library_note": "no single PyTorch call computes the epilogue backward"}
                   if key == "K4" else {}),
                "shapes": rows,
            })
    rows = train_rows["K5"]
    kernels.append({
        "name": "ssim_stats[float32]", "route": "cuda",
        "source": "repnerv_tpu_torch/csrc/ssim_blur.cu",
        "replaces": "repnerv_tpu/pallas_kernels/ssim_blur.py:43",
        "launches": sum(train[d]["launches"]["K5"] for d in ("bfloat16", "float32", "mixed")),
        "profile_launches": profile["launches"]["K5"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # the 7 launches of one training step (the loss's means with the
        # moments kept and their VJP, the MS-SSIM metric's five levels)
        "ms": sum(r["step_ms"] for r in rows),
        "plain_ms": sum(r["step_plain_ms"] for r in rows),
        **yardsticks(rows),
        "device_ms": sum(r["step_device_ms"] for r in rows),
        "vjp_max_abs_err": max(r["vjp_max_abs_err"] for r in rows),
        # library_ms is the depthwise F.conv2d of the moments of each of the 6
        # stats launches of a step (the loss's and the 5 MS-SSIM levels');
        # forward_ms the kernel's time for the same 6; the VJP launch has no
        # library call
        "forward_ms": sum(r["forward_step_ms"] for r in rows),
        "library_max_abs_err": max(r["library_max_abs_err"] for r in rows),
        "shapes": rows,
        # gauss_blur_valid, the one-map entry of the same source (not on the step's path)
        "single_map": train_rows["K5_single"],
    })
    kernels.append(fold_kernel_row(fold_rows, sum(
        train[d]["launches"]["FOLD"] + train[d]["launches"]["FOLD_VJP"]
        for d in ("bfloat16", "float32", "mixed"))))
    main_rows = [r for r in int8_rows if r["shape"] in INT8_MAIN_PATH_SHAPES]
    kernels.append({
        "name": "fused_conv_ps_act_int8[int8]", "route": "cuda",
        # blocks 3-4 run the wgmma s8 kernel; decode_int8.cu's WMMA kernel keeps the other shapes
        "source": "repnerv_tpu_torch/csrc/decode_wgmma_s8.cu",
        "other_sources": ["repnerv_tpu_torch/csrc/stage_wgmma.cuh",
                          "repnerv_tpu_torch/csrc/decode_int8.cu"],
        "replaces": "repnerv_tpu/pallas_kernels/decode_int8.py:78",
        "launches": compress["serve_int8"]["launches"]["K2"],
        # int8 outputs in counts, the head's in f32
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        # one batch of 8 frames through blocks 3-4 + head of the flagship
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        **yardsticks(main_rows),
        "shape_routes": {r["shape"]: r["route"] for r in int8_rows},
        "library_note": "no single PyTorch call computes it: torch has no int8 x int8 -> int32 "
                        "convolution on CUDA, and none with the per-channel dequant, activation, "
                        "PixelShuffle and requantization",
        "shapes": int8_rows,
        "serve": compress["serve_int8"],
    })
    for k in kernels:
        share = k["bound_ms"] / k["ms"]
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.3f} ms"
        log(f"[kernels] {k['name']}: {k['ms']:.3f} ms, bound {k['bound_ms']:.3f} ms by "
            f"{k['bound_by']} ({share:.1%} of it reached), plain {k['plain_ms']:.3f} ms, "
            f"library {lib}, launches {k['launches']}"
            + (f"; the kernels alone {k['device_ms']:.3f} ms on the card (torch.profiler: "
               f"{k['bound_ms'] / k['device_ms']:.1%} of the bound)" if "device_ms" in k else "")
            + "".join(f"; rows on the wgmma route {k['wgmma_rows_ms']:.3f} ms, the "
                      f"{old.upper()} kernel on the same rows {k[f'wgmma_rows_{old}_ms']:.3f} ms"
                      for old in ("wmma", "fma") if f"wgmma_rows_{old}_ms" in k)
            + (f" (max|d| {k['wgmma_rows_max_abs_err']:.3e} against the FMA kernel's "
               f"{k['wgmma_rows_fma_max_abs_err']:.3e})" if "wgmma_rows_fma_ms" in k else "")
            + (f", the bf16 wgmma kernel {k['bf16_kernel_ms']:.3f} ms" if "bf16_kernel_ms" in k
               else "")
            + (f"; library ms of the {k['forward_ms']:.3f} ms of stats launches (max|d| "
               f"{k['library_max_abs_err']:.3e})" if "forward_ms" in k else ""))
    log("[train] summary " + json.dumps(train))
    log("[compress] summary " + json.dumps(compress))
    log("[ooc] summary " + json.dumps(ooc))
    log("[multi] summary " + json.dumps(multi))
    log("[tp] summary " + json.dumps(tp))
    log("[quality] summary " + json.dumps(quality))
    log("[profile] summary " + json.dumps(profile))
    log("[profiler-probe] summary " + json.dumps(
        {**probe, "traces": len(TRACES), "empty_traces": empty_traces(),
         "short_traces": short_traces()}))
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps(
        {"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}
    ))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:  # one rank of phase 10 (d), started by phase_gloo
        gloo_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase 11, started by _spawn_tp
        tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--profile"]:  # phases 1, 2 and 13 alone
        device = phase_device()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            log("[profile] summary " + json.dumps(phase_profile(tmp, device["smi"])))
        print(device["smi"])
    elif sys.argv[1:2] == ["--fold"]:  # phases 1, 2 and 5b alone
        device = phase_device()
        phase_build()
        rows = phase_fold()
        with tempfile.TemporaryDirectory() as tmp:
            main_path = fold_main_path(tmp)
        row = fold_kernel_row(rows, main_path["launches"]["FOLD"]
                              + main_path["launches"]["FOLD_VJP"])
        log(f"[kernels] {row['name']}: {row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']} ({row['bound_ms'] / row['ms']:.1%} of it reached), plain "
            f"{row['plain_ms']:.3f} ms, launches {row['launches']}")
        print(json.dumps({"kernels": [row], "fold_main_path": main_path}))
        print(device["smi"])
    elif sys.argv[1:2] == ["--quality"]:  # phases 1, 2 and 12 alone
        device = phase_device()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            log("[quality] summary " + json.dumps(phase_quality(tmp)))
        print(device["smi"])
    else:
        main()
