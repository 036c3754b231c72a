#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repnerv_tpu_torch``) on one
NVIDIA GPU: build the hand-written kernels, hold each against its plain
PyTorch version at the flagship shapes, serve a flagship-width ``.rnvb``
artifact through ``repnerv_tpu_torch.cli.decode_main``, and train the
flagship through ``repnerv_tpu_torch.cli.train_main``, compress that
training run through ``repnerv_tpu_torch.cli.eval_main`` and serve its
``.rnvb`` in int8, checking that every main path went through the kernels
and matches its plain path.

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
               (32 frames, batch 8) in f32 and bf16; launch count, frames vs
               the plain path, fps of both paths
  5. train-kernels — K3 (training stage forward) and K4 (its epilogue
               backward, with the bias and head gradients it sums itself:
               values, and equal bits from two launches) at the four fused
               block shapes of a -b 1 flagship step, f32 and bf16; K5 (SSIM
               blur) at the loss's and the MS-SSIM levels' shapes: the five
               moments in one launch (bitwise), their fused VJP (stated
               bound), and the single-map blur; each vs its plain version,
               with times
  6. train   — train_main on the flagship (16 synthetic 720p frames, -b 1,
               Fusion6, 2 epochs) in bf16 (with --eval_fps: the FPS lines of
               its rank0.txt) and f32: launches per step, finite
               losses, PSNR rising, the .pth files; one step of the kernel
               path vs --no_pallas_train (loss, gradients); ms per step of
               both paths; where a step's time goes (torch.profiler)
  7. int8-kernel — K2 (int8 decode stage) vs plain version at the flagship's
               int8 blocks 3 and 4 + head (batch 8, the wgmma s8 kernel; beside
               it the WMMA kernel's and the bf16 kernel's time on the same
               shape) and the stride-5 stage (the WMMA kernel)
  8. compress — eval_main on phase 6's bf16 run: PATH B (prune 0.2, 8 bits,
               .rnvb) without and with --decode_int8, PATH A (1 masked
               finetune epoch), QAT (1 epoch); then decode_main --decode_int8
               serves the .rnvb: 2 K1 + 2 K2 launches per batch (both K2 on
               the wgmma route), frames vs the plain path, fps of the int8,
               bf16 and plain paths
Every kernel's row of the ``kernels`` line carries ``bound_ms`` / ``bound_by``
and ``library_ms`` (null where no single PyTorch call computes the kernel's
heavy part).  The last line is {"ok": true, "device": {...}}.  Needs no
network; imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
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
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.kernels import build
from repnerv_tpu_torch.kernels import decode as dk
from repnerv_tpu_torch.kernels import decode_int8 as k8
from repnerv_tpu_torch.kernels import ssim_blur as sb
from repnerv_tpu_torch.kernels import train_tail as tt
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, param_count
from repnerv_tpu_torch.train.loop import (
    DECODE_REPS,
    init_train_state,
    make_decode_fn,
    make_train_step,
    measure_decode_fps,
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
# launches per training step: K3 and K4 on blocks 1-4; K5 once for the five
# moments of the Fusion6 SSIM term, once for their VJP (the target needs
# none) and once per level of the MS-SSIM metric.  Per frame of the eval: 5 K5.
PER_STEP = {"K3": 4, "K4": 4, "K5": 1 + 1 + 5}
PER_EVAL_FRAME = {"K3": 0, "K4": 0, "K5": 5}
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


def kernel_device_ms(fn, fragment: str, reps: int = 5) -> float:
    """The card's own time for the kernels of one ``fn()`` whose name holds
    ``fragment``, from a torch.profiler trace of ``reps`` calls.  ``cuda_ms``
    of a call that is shorter than the host takes to launch it (K4 and K5 at
    the small stages: tens of microseconds) reads the host instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if fragment in e.key.lower())
    if not us:
        raise RuntimeError(f"the profiler saw no kernel named *{fragment}*")
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
            "breakdown": decode_breakdown(model, t),
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
# the K5 calls of one step, (name, shape, moments launches, VJP launches): the
# loss's SSIM at 720p (the five moments, their VJP) and the MS-SSIM metric's
# five levels (the moments); N = 3 channels, b = 1
BLUR_CALLS = [("loss", (3, 720, 1280), 1, 1)] + [
    (f"msssim-l{i}", (3, 720 >> i, 1280 >> i), 1, 0) for i in range(5)
]
# the fused VJP adds three terms, B(g_mu) + 2 x B(g_xx) + y B(g_xy), in an
# order autograd does not fix: within this share of the plain VJP's largest
# |entry| (a few f32 roundings of O(1) terms)
K5_VJP_RTOL = 1e-6


def _bf16_ulp(out, ref):
    """|d| <= 2^-7 |ref| + 1e-4: both round one f32 value (up to summation
    order) to bf16."""
    return bool(((out.float() - ref.float()).abs() <= BF16_RTOL * ref.float().abs() + 1e-4).all())


def phase_train_kernels() -> dict:
    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda", 0)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(dev)

    rows = {"K3": [], "K4": [], "K5": []}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, h, w, cin, c, s, head in TRAIN_SHAPES:
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
            log(f"[train-kernels] K3 {dname:8s} {name:12s} x[1,{h},{w},{cin}] -> out "
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
            log(f"[train-kernels] K4 {dname:8s} {name:12s} z {list(z.shape)} -> d_conv "
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
    win = sb.window_tuple(11, 1.5)

    def blur_ops(n, h, w_in, w_out, h_out, maps):
        # 2 x 11 FLOPs per value of the column pass and of the row pass
        return 22.0 * maps * n * (h_out * w_in + h_out * w_out)

    for name, shape, n_fwd, n_vjp in BLUR_CALLS:
        n, h, w = shape
        x, y = torch.rand(shape, generator=g).to(dev), torch.rand(shape, generator=g).to(dev)
        cts = [torch.randn(n, h - 10, w - 10, generator=g).to(dev) for _ in range(3)]
        out, ref = sb.moments_forward(x, y, win), sb.ssim_moments_reference(x, y, win)
        dx, ref_dx = sb.moments_vjp(*cts, x, y, win), sb.moments_vjp_reference(*cts, x, y, win)
        torch.cuda.synchronize()
        # forward: the kernel runs the plain version's rounded multiplies and
        # adds in its order, the products x*x, y*y, x*y included: equal bits
        err = max((a - r).abs().max().item() for a, r in zip(out, ref))
        vjp_err = (dx - ref_dx).abs().max().item()
        vjp_tol = K5_VJP_RTOL * ref_dx.abs().max().item()
        ok = all(torch.equal(a, r) for a, r in zip(out, ref)) and vjp_err <= vjp_tol
        ms = cuda_ms(lambda: sb.moments_forward(x, y, win))
        device_ms = kernel_device_ms(lambda: sb.moments_forward(x, y, win), "blur_tiles")
        plain_ms = cuda_ms(lambda: sb.ssim_moments_reference(x, y, win))
        vjp_ms = cuda_ms(lambda: sb.moments_vjp(*cts, x, y, win)) if n_vjp else 0.0
        vjp_device_ms = (kernel_device_ms(lambda: sb.moments_vjp(*cts, x, y, win), "blur_tiles")
                         if n_vjp else 0.0)
        vjp_plain_ms = (cuda_ms(lambda: sb.moments_vjp_reference(*cts, x, y, win))
                        if n_vjp else 0.0)
        # bounds on the fused calls' own bytes: x and y read once and five maps
        # written; the three cotangents, x and y read and d_x written
        fwd_bound = roofline(blur_ops(n, h, w, w - 10, h - 10, 5), nbytes(x, y, *out), "f32")
        vjp_bound = roofline(blur_ops(n, h + 10, w - 10, w, h, 3), nbytes(*cts, x, y, dx), "f32")
        k5_bound = sum_bounds([fwd_bound] * n_fwd + [vjp_bound] * n_vjp)
        log(f"[train-kernels] K5 float32  {name:12s} x, y {list(shape)} -> 5 x {list(out[0].shape)}"
            f": max|d|={err:.3e} (tol 0, bitwise), VJP max|d|={vjp_err:.3e} (tol {vjp_tol:.3e} = "
            f"{K5_VJP_RTOL:g} max|ref|) kernel {ms:.3f} ms a call (VJP {vjp_ms:.3f}), {device_ms:.3f} "
            f"(VJP {vjp_device_ms:.3f}) on the card, plain "
            f"{plain_ms:.3f} ms (VJP {vjp_plain_ms:.3f}), bound {fwd_bound['bound_ms']:.4f} ms "
            f"({fwd_bound['bound_by']}; VJP {vjp_bound['bound_ms']:.4f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {name}")
        rows["K5"].append({
            "shape": name, "dtype": "float32", "max_abs_err": err, "tol": 0.0,
            "vjp_max_abs_err": vjp_err, "vjp_tol": vjp_tol,
            "ms": ms, "plain_ms": plain_ms, "vjp_ms": vjp_ms, "vjp_plain_ms": vjp_plain_ms,
            # this shape's share of one training step's blurs
            "step_ms": n_fwd * ms + n_vjp * vjp_ms,
            "device_ms": device_ms, "vjp_device_ms": vjp_device_ms,
            "step_device_ms": n_fwd * device_ms + n_vjp * vjp_device_ms,
            "step_plain_ms": n_fwd * plain_ms + n_vjp * vjp_plain_ms,
            "calls_per_step": n_fwd + n_vjp,
            **k5_bound,  # of this shape's calls of one step
        })
        del out, ref, dx, ref_dx, cts
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


def launch_counts() -> dict:
    return {"K1": dk.LAUNCHES, "K2": k8.LAUNCHES, "K3": tt.FWD_LAUNCHES,
            "K4": tt.BWD_LAUNCHES, "K5": sb.LAUNCHES}


def reset_counts() -> None:
    dk.LAUNCHES = k8.LAUNCHES = tt.FWD_LAUNCHES = tt.BWD_LAUNCHES = sb.LAUNCHES = 0
    for routes in (dk.ROUTE_LAUNCHES, tt.FWD_ROUTE_LAUNCHES, k8.ROUTE_LAUNCHES):
        for r in routes:
            routes[r] = 0


def _train_cfg(dtype: str, use_kernel: bool) -> TrainConfig:
    mcfg = ModelConfig(branch_type="ERB", compute_dtype=dtype, use_pallas_train=use_kernel)
    return TrainConfig(model=mcfg, data=DataConfig(batch_size=1), epochs=TRAIN_EPOCHS,
                       lr=5e-4, loss_type="Fusion6")


def _step_setup(dtype: str, use_kernel: bool, store: FrameStore):
    cfg = _train_cfg(dtype, use_kernel)
    state = init_train_state(cfg, "cuda", seed=SEED)
    step = make_train_step(cfg, TRAIN_FRAMES, with_msssim=True)
    t_all = torch.from_numpy(store.t).cuda()
    return state, step, t_all


def step_ms(dtype: str, use_kernel: bool, store: FrameStore) -> float:
    """CUDA-event median of the steps of one epoch after a warm-up step."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.arange(TRAIN_FRAMES, device="cuda")
    state, _ = step(state, store.gather(rows[:1]), t_all[:1])
    times = []
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
    """Loss and gradients of one step from the seed-0 weights on frame 0."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.zeros(1, dtype=torch.long, device="cuda")
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_iters):
            run(i)
        torch.cuda.synchronize()
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
    """``profile_groups`` of ``n_steps`` training steps after a warm-up step."""
    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.zeros(1, dtype=torch.long, device="cuda")
    state, _ = step(state, store.gather(rows), t_all[rows])

    def run(i):
        nonlocal state
        r = rows + i + 1
        state, _ = step(state, store.gather(r), t_all[r])

    return profile_groups(run, n_steps)


def decode_breakdown(model, t: torch.Tensor, n_batches: int = 3) -> dict:
    """``profile_groups`` of ``n_batches`` decoded batches, and the device's
    idle share of a batch (CUDA-event time of the same batches, unprofiled).
    Empty when the profiler cannot trace the card."""
    decode = make_decode_fn(TrainConfig(model=model.cfg))
    decode(model, t)
    try:
        bd = profile_groups(lambda i: decode(model, t), n_batches)
    except RuntimeError as e:
        log(f"[serve] decode breakdown not measured ({e})")
        return {}
    if not bd["device_ms"]:
        log("[serve] decode breakdown not measured (no device time)")
        return {}
    bd["batch_ms"] = cuda_ms(lambda: decode(model, t))
    bd["idle_share"] = max(0.0, 1 - bd["device_ms"] / bd["batch_ms"])
    parts = ", ".join(f"{k} {v:.3f}" for k, v in bd["groups_ms"].items())
    log(f"[serve] {model.cfg.compute_dtype}: one batch of {t.numel()} frames, device ms from "
        f"torch.profiler: {parts}; device total {bd['device_ms']:.3f} of {bd['batch_ms']:.3f} ms "
        f"(idle share {bd['idle_share']:.3f}); {bd['kernels_per_step']:.0f} kernels per batch")
    return bd


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
        for dtype in ("bfloat16", "float32"):
            eval_counts.clear()
            os.chdir(tmp)  # train_main writes under result/<outf>
            try:
                reset_counts()  # the main path's run starts here
                t0 = time.perf_counter()
                # the bf16 run also measures the decode fps at every eval (--eval_fps)
                extra = ["--eval_fps"] if dtype == "bfloat16" else []
                res = train_main.main(TRAIN_ARGV + extra
                                      + ["--compute_dtype", dtype, "--outf", dtype])
                wall = time.perf_counter() - t0
                counts = launch_counts()  # ... and ends here
                routes = dict(tt.FWD_ROUTE_LAUNCHES)
                outf = os.path.abspath(res["outf"])
            finally:
                os.chdir(cwd)
            n_eval = TRAIN_EPOCHS * TRAIN_FRAMES  # every epoch is one of the last 10: all eval
            train_counts = {k: counts[k] - eval_counts.get(k, 0) for k in PER_STEP}
            log(f"[train] {dtype}: train_main {TRAIN_EPOCHS} epochs x {TRAIN_FRAMES} steps in "
                f"{wall:.1f} s; launches {counts}; in the training steps {train_counts} "
                f"(expect {({k: v * steps for k, v in PER_STEP.items()})}), in the eval "
                f"{ {k: eval_counts.get(k, 0) for k in PER_STEP} }")
            for k in PER_STEP:
                if train_counts[k] != PER_STEP[k] * steps:
                    raise AssertionError(f"{k}: {train_counts[k]} launches in {steps} steps, "
                                         f"expected {PER_STEP[k]} per step")
                if eval_counts.get(k, 0) != PER_EVAL_FRAME[k] * n_eval:
                    raise AssertionError(f"{k}: {eval_counts.get(k, 0)} launches in the eval of "
                                         f"{n_eval} frames, expected {PER_EVAL_FRAME[k]} each")
            # blocks 2-4 (Cin 96) on the type's wgmma kernel, block 1 (Cin 26) on WMMA / FMA
            want = dict.fromkeys(dk.ROUTES, 0)
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
    return results


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
    }
    del base, model, plain, frames, ref, diff
    torch.cuda.empty_cache()
    return results


def main() -> None:
    device = phase_device()
    phase_build()
    kernel_rows = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        train_rows = phase_train_kernels()
        train = phase_train(tmp)
        int8_rows = phase_int8_kernel()
        compress = phase_compress(tmp)
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
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # blocks 1-4 of one -b 1 flagship training step
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                **yardsticks(rows),
                **({"device_ms": sum(r["device_ms"] for r in rows)} if key == "K4" else {}),
                "shapes": rows,
            })
    rows = train_rows["K5"]
    kernels.append({
        "name": "ssim_moments[float32]", "route": "cuda",
        "source": "repnerv_tpu_torch/csrc/ssim_blur.cu",
        "replaces": "repnerv_tpu/pallas_kernels/ssim_blur.py:43",
        "launches": sum(train[d]["launches"]["K5"] for d in ("bfloat16", "float32")),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # the 7 launches of one training step (the loss's moments and their
        # VJP, the MS-SSIM metric's five levels)
        "ms": sum(r["step_ms"] for r in rows),
        "plain_ms": sum(r["step_plain_ms"] for r in rows),
        **yardsticks(rows),
        "device_ms": sum(r["step_device_ms"] for r in rows),
        "vjp_max_abs_err": max(r["vjp_max_abs_err"] for r in rows),
        "shapes": rows,
        # gauss_blur_valid, the one-map entry of the same source (not on the step's path)
        "single_map": train_rows["K5_single"],
    })
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
               else ""))
    log("[train] summary " + json.dumps(train))
    log("[compress] summary " + json.dumps(compress))
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps(
        {"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}
    ))


if __name__ == "__main__":
    main()
