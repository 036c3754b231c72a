#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repnerv_tpu_torch``) on one
NVIDIA GPU: build the hand-written kernels, hold each against its plain
PyTorch version at the flagship shapes, serve a flagship-width ``.rnvb``
artifact through ``repnerv_tpu_torch.cli.decode_main``, and train the
flagship through ``repnerv_tpu_torch.cli.train_main``, checking that both
main paths went through the kernels and match their plain paths.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — a CUDA device is required; its name and power limit
  2. build   — nvcc builds csrc/*.cu from the checkout, one process per source
  3. kernel  — K1 (decode stage) vs plain version, f32 and bf16, at the shapes
               the serve phase gives it (Bunny-720p ERB flagship, batch 8)
  4. serve   — flagship ERB generator from seed 0 -> 8-bit .rnvb -> decode_main
               (32 frames, batch 8) in f32 and bf16; launch count, frames vs
               the plain path, fps of both paths
  5. train-kernels — K3 (training stage forward) and K4 (its epilogue
               backward) at the four fused block shapes of a -b 1 flagship
               step, f32 and bf16; K5 (SSIM blur) at the loss's and the
               MS-SSIM levels' shapes, forward and VJP; each vs its plain
               version, with times
  6. train   — train_main on the flagship (16 synthetic 720p frames, -b 1,
               Fusion6, 2 epochs) in bf16 and f32: launches per step, finite
               losses, PSNR rising, the .pth files; one step of the kernel
               path vs --no_pallas_train (loss, gradients); ms per step of
               both paths; where a step's time goes (torch.profiler)
The last line is {"ok": true, "device": {...}}.  Needs no network; imports
no JAX.
"""

from __future__ import annotations

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

from repnerv_tpu_torch.cli import decode_main, train_main
from repnerv_tpu_torch.compress.bitstream import read_bitstream, write_state_bitstream
from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.kernels import build
from repnerv_tpu_torch.kernels import decode as dk
from repnerv_tpu_torch.kernels import ssim_blur as sb
from repnerv_tpu_torch.kernels import train_tail as tt
from repnerv_tpu_torch.models.generator import Generator, param_count
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
# f32: the kernel and cuDNN (TF32 off) sum K = 9*Cin <= 864 exact f32
# products in different orders, ~sqrt(K) * 2^-24 * sum|terms| << 1e-4
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
# launches per training step: K3 and K4 on blocks 1-4; K5 5 blurs in the
# Fusion6 SSIM forward, 3 in its VJP (the target's two blurs need none) and
# 5 levels x 5 blurs in the MS-SSIM metric.  Per frame of the eval: 25 K5.
PER_STEP = {"K3": 4, "K4": 4, "K5": 5 + 3 + 25}
PER_EVAL_FRAME = {"K3": 0, "K4": 0, "K5": 25}
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
            log(
                f"[kernel] {dname:8s} {name:12s} x[{SERVE_BATCH},{h},{w},{cin}] s={s} "
                f"-> {list(out.shape)}: max|d|={err:.3e} (tol {tol}) "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version at {name} {dname}")
            rows.append(
                {"shape": name, "dtype": dname, "max_abs_err": err, "tol": tol,
                 "ms": ms, "plain_ms": plain_ms}
            )
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
        acct = write_state_bitstream(path, state, mcfg, quant_bit=8)
        log(f"[serve] wrote {os.path.basename(path)}: {int(acct['file_bytes'])} bytes")

        dk.LAUNCHES = 0  # the main path's run starts here
        res = decode_main.main([path, "--frames", str(SERVE_FRAMES), "--batch", str(SERVE_BATCH)])
        launches = dk.LAUNCHES  # ... and ends here
        expected = 4 * n_batches * (1 + DECODE_REPS)
        log(f"[serve] {dtype}: decode_main -> {res}; kernel launches {launches} (expect {expected})")
        if launches != expected:
            raise AssertionError(f"expected {expected} kernel launches (4 per batch), got {launches}")

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
        log(f"[serve] {dtype}: fps kernel path {res['fps']:.2f}, plain path {plain_fps:.2f}")
        out[dtype] = {
            "launches": launches, "fps": res["fps"], "plain_fps": plain_fps,
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
# the K5 calls of one step: the loss's SSIM at 720p (forward x5, VJP x3) and
# the MS-SSIM metric's five levels (forward x5 each); N = 3 channels, b = 1
BLUR_CALLS = [("loss", (3, 720, 1280), 5, 3)] + [
    (f"msssim-l{i}", (3, 720 >> i, 1280 >> i), 5, 0) for i in range(5)
]


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
            log(f"[train-kernels] K3 {dname:8s} {name:12s} x[1,{h},{w},{cin}] -> out "
                f"{list(out.shape)} z {list(z.shape)}: max|d|={err:.3e} (tol {tol}) "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version at {name} {dname}")
            rows["K3"].append({"shape": name, "dtype": dname, "max_abs_err": err, "tol": tol,
                               "ms": ms, "plain_ms": plain_ms})
            # K4 on this stage's z and a cotangent of its output
            ct = torch.randn(out.shape, generator=g).to(dev).to(out.dtype).contiguous()
            args = (z, ct, out if head else None, p.head_w, s, "swish", "tanh")
            got = tt.epilogue_backward(*args)
            ref = tt.epilogue_backward_reference(*args)
            torch.cuda.synchronize()
            err = (got[0].float() - ref[0].float()).abs().max().item()
            ok = _bf16_ulp(got[0], ref[0]) if dtype == torch.bfloat16 else err <= 1e-5
            part_rel = 0.0  # per-block partial sums vs one sum: f32 order over <= 2^20 terms
            for a, r in zip(got[1:], ref[1:]):
                if r is not None:
                    part_rel = max(part_rel, (a - r).abs().max().item() / max(r.abs().max().item(), 1.0))
            ok = ok and part_rel <= 1e-4
            tol = ("d_conv |d| <= 2^-7|ref| + 1e-4" if dtype == torch.bfloat16 else "d_conv 1e-5") + \
                "; partials 1e-4 x max|ref|"
            ms = cuda_ms(lambda: tt.epilogue_backward(*args))
            plain_ms = cuda_ms(lambda: tt.epilogue_backward_reference(*args))
            log(f"[train-kernels] K4 {dname:8s} {name:12s} z {list(z.shape)} -> d_conv "
                f"{list(got[0].shape)}: d_conv max|d|={err:.3e}, partials max|d|/max|ref|="
                f"{part_rel:.3e} (tol {tol}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version at {name} {dname}")
            rows["K4"].append({"shape": name, "dtype": dname, "max_abs_err": err,
                               "partials_rel_err": part_rel, "tol": tol, "ms": ms,
                               "plain_ms": plain_ms})
            del x, out, z, ref_out, ref_z, ct, got, ref, args
            torch.cuda.empty_cache()
    win = sb.window_tuple(11, 1.5)
    for name, shape, n_fwd, n_vjp in BLUR_CALLS:
        x = torch.rand(shape, generator=g).to(dev)
        ct = torch.randn(shape[0], shape[1] - 10, shape[2] - 10, generator=g).to(dev)
        ctp = F.pad(ct, (10,) * 4).contiguous()
        out, ref = sb.blur_valid(x, win), sb.blur_valid_reference(x, win)
        dx, ref_dx = sb.blur_valid(ctp, win), sb.blur_valid_reference(ctp, win)
        torch.cuda.synchronize()
        # the kernel runs the plain version's rounded multiplies and adds in
        # its order: the results are equal to the bit
        err = max((out - ref).abs().max().item(), (dx - ref_dx).abs().max().item())
        ok = torch.equal(out, ref) and torch.equal(dx, ref_dx)
        ms = cuda_ms(lambda: sb.blur_valid(x, win))
        plain_ms = cuda_ms(lambda: sb.blur_valid_reference(x, win))
        vjp_ms = cuda_ms(lambda: sb.blur_valid(ctp, win)) if n_vjp else 0.0
        vjp_plain_ms = cuda_ms(lambda: sb.blur_valid_reference(ctp, win)) if n_vjp else 0.0
        log(f"[train-kernels] K5 float32  {name:12s} {list(shape)} -> {list(out.shape)}: "
            f"max|d|={err:.3e} (tol 0, bitwise) kernel {ms:.3f} ms (VJP {vjp_ms:.3f}), plain "
            f"{plain_ms:.3f} ms (VJP {vjp_plain_ms:.3f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {name}")
        rows["K5"].append({
            "shape": name, "dtype": "float32", "max_abs_err": err, "tol": 0.0,
            "ms": ms, "plain_ms": plain_ms, "vjp_ms": vjp_ms, "vjp_plain_ms": vjp_plain_ms,
            # this shape's share of one training step's blurs
            "step_ms": n_fwd * ms + n_vjp * vjp_ms,
            "step_plain_ms": n_fwd * plain_ms + n_vjp * vjp_plain_ms,
        })
    return rows


def launch_counts() -> dict:
    return {"K1": dk.LAUNCHES, "K3": tt.FWD_LAUNCHES, "K4": tt.BWD_LAUNCHES, "K5": sb.LAUNCHES}


def reset_counts() -> None:
    dk.LAUNCHES = tt.FWD_LAUNCHES = tt.BWD_LAUNCHES = sb.LAUNCHES = 0


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
    ("K3 stage forward", ("tensor_core::kernel", "cuda_core::kernel")),
    ("K4 epilogue backward", ("epilogue_bwd",)),
    ("K5 SSIM blur", ("blur_valid",)),
    ("cuDNN conv (stage 0, dX/dW)", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad",
                                     "dgrad", "sm90_", "cutlass")),
    ("Adam", ("adam", "multi_tensor")),
]


def step_breakdown(dtype: str, use_kernel: bool, store: FrameStore, n_steps: int = 3) -> dict:
    """Device time of each kernel group per step, from a torch.profiler
    trace of ``n_steps`` steps after a warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    state, step, t_all = _step_setup(dtype, use_kernel, store)
    rows = torch.zeros(1, dtype=torch.long, device="cuda")
    state, _ = step(state, store.gather(rows), t_all[rows])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            r = rows + i + 1
            state, _ = step(state, store.gather(r), t_all[r])
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other (elementwise, SSIM maps, stem, fusion)"] = 0.0
    total, n_kernels = 0.0, 0
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
    return {"groups_ms": {k: v / 1e3 / n_steps for k, v in groups.items()},
            "device_ms": total / 1e3 / n_steps, "kernels_per_step": n_kernels / n_steps}


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
                res = train_main.main(TRAIN_ARGV + ["--compute_dtype", dtype, "--outf", dtype])
                wall = time.perf_counter() - t0
                counts = launch_counts()  # ... and ends here
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
            results[dtype] = {"launches": counts, "train_launches": train_counts,
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
            results[dtype]["breakdown" if use_kernel else "breakdown_plain"] = bd
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
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")

    kernels = []
    for dname, rows in kernel_rows.items():
        main_rows = [r for r in rows if r["shape"] in MAIN_PATH_SHAPES]
        kernels.append({
            "name": f"fused_conv_ps_act[{dname}]",
            "route": "cuda",
            "source": "repnerv_tpu_torch/csrc/decode.cu",
            "replaces": "repnerv_tpu/pallas_kernels/decode.py:79",
            "launches": serve[dname]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one batch of 8 frames through blocks 1-4 of the flagship
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "shapes": rows,
            "serve": serve[dname],
        })
    sources = {
        "K3": ("stage_forward", "repnerv_tpu_torch/csrc/decode.cu",
               "repnerv_tpu/pallas_kernels/train_tail.py:83"),
        "K4": ("epilogue_backward", "repnerv_tpu_torch/csrc/train_tail.cu",
               "repnerv_tpu/pallas_kernels/train_tail.py:263"),
    }
    for key, (fn, src, replaces) in sources.items():
        for dname in ("float32", "bfloat16"):
            rows = [r for r in train_rows[key] if r["dtype"] == dname]
            kernels.append({
                "name": f"{fn}[{dname}]", "route": "cuda", "source": src, "replaces": replaces,
                "launches": train[dname]["launches"][key],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # blocks 1-4 of one -b 1 flagship training step
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "shapes": rows,
            })
    rows = train_rows["K5"]
    kernels.append({
        "name": "gauss_blur_valid[float32]", "route": "cuda",
        "source": "repnerv_tpu_torch/csrc/ssim_blur.cu",
        "replaces": "repnerv_tpu/pallas_kernels/ssim_blur.py:43",
        "launches": sum(train[d]["launches"]["K5"] for d in ("bfloat16", "float32")),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # the 33 blurs of one training step (loss forward + VJP, MS-SSIM metric)
        "ms": sum(r["step_ms"] for r in rows),
        "plain_ms": sum(r["step_plain_ms"] for r in rows),
        "shapes": rows,
    })
    log("[train] summary " + json.dumps(train))
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps(
        {"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}
    ))


if __name__ == "__main__":
    main()
