#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repnerv_tpu_torch``) on one
NVIDIA GPU: build the hand-written decode kernel, hold it against its plain
PyTorch version at the flagship shapes, then serve a flagship-width ``.rnvb``
artifact through ``repnerv_tpu_torch.cli.decode_main`` and check that the
decode went through the kernel and matches the plain path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — a CUDA device is required; its name and power limit
  2. build   — nvcc builds csrc/*.cu from the checkout
  3. kernel  — kernel vs plain version, f32 and bf16, at the shapes the
               serve phase gives the kernel (Bunny-720p ERB flagship, batch 8),
               with times
  4. serve   — flagship ERB generator from seed 0 -> 8-bit .rnvb -> decode_main
               (32 frames, batch 8) in f32 and bf16; launch count, frames vs
               the plain path, fps of both paths
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

from repnerv_tpu_torch.cli import decode_main
from repnerv_tpu_torch.compress.bitstream import read_bitstream, write_state_bitstream
from repnerv_tpu_torch.config import ModelConfig, TrainConfig
from repnerv_tpu_torch.kernels import build
from repnerv_tpu_torch.kernels import decode as dk
from repnerv_tpu_torch.models.generator import Generator, param_count
from repnerv_tpu_torch.train.loop import DECODE_REPS, make_decode_fn, measure_decode_fps

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


def main() -> None:
    device = phase_device()
    phase_build()
    kernel_rows = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
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
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps(
        {"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}
    ))


if __name__ == "__main__":
    main()
