"""Where a wgmma + TMA stage kernel's time goes: build one of
``csrc/decode_wgmma.cu`` (bf16), ``csrc/decode_wgmma_tf32.cu`` (f32) and
``csrc/decode_wgmma_s8.cu`` (int8) alone in several variants (the
``REPNERV_PROBE_*`` macros of ``csrc/stage_wgmma.cuh`` take a part out or
change a design choice) and time each at the flagship's shapes on one NVIDIA
GPU.

    python -m repnerv_tpu_torch.kernels.probe_wgmma [bf16|f32|int8] [variant ...]

Variants:
  kernel        the kernel as the port runs it (swish)
  relu          the same with the cheapest activation (the activation is chosen
                once per work item)
  gelu          ... and with the dearest (erff)
  no_epilogue   loads and products only
  no_products   loads only (with no_epilogue: the ring and the barriers)
  no_loads      products only, on whatever the ring holds
  one_item      one work item per block instead of the persistent grid
  nsub1         bf16, int8: one sub-pixel per work item (N = 96) instead of two
  stages10      bf16: a ring of 10 slots instead of 6
  stages4       f32, int8: a ring of 4 slots instead of 8 / 5
  exact_act     int8: swish through expf and a division instead of __expf and
                __fdividef
  bounded_spin  the kernel with barrier waits that trap after about two seconds
                instead of hanging the card: for trying a change to the
                protocol; only run when named
One line per shape and variant: ms (CUDA-event median of 10 after a warm-up)
and the conv's TOP/s (2 per multiply-add; f32: of f32-grade work, a third of
what the tensor cores do); bf16, at the smallest training shape, also what one
launch costs the host (it encodes the tensor maps per launch); the last line
is the card's name and power limit.  A measurement tool: nothing in the port
imports it.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch

from .build import ARCH, BUILD_DIR, CSRC, find_nvcc
from .decode import ACT_CODES, split_tf32

NO_EPILOGUE = "-DREPNERV_PROBE_NO_EPILOGUE"
# variant -> (nvcc flags, activation, operand types it exists for)
VARIANTS = {
    "kernel": ([], "swish", ("bf16", "f32", "int8")),
    "relu": ([], "relu", ("bf16", "f32", "int8")),
    "gelu": ([], "gelu", ("bf16", "f32", "int8")),
    "no_epilogue": ([NO_EPILOGUE], "swish", ("bf16", "f32", "int8")),
    "no_products": ([NO_EPILOGUE, "-DREPNERV_PROBE_NO_PRODUCTS"], "swish", ("bf16", "f32", "int8")),
    "no_loads": ([NO_EPILOGUE, "-DREPNERV_PROBE_NO_LOADS"], "swish", ("bf16", "f32", "int8")),
    "one_item": (["-DREPNERV_PROBE_ONE_ITEM_PER_BLOCK"], "swish", ("bf16", "f32", "int8")),
    "nsub1": (["-DREPNERV_PROBE_NSUB=1"], "swish", ("bf16", "int8")),
    "stages10": (["-DREPNERV_PROBE_STAGES=10"], "swish", ("bf16",)),
    "stages4": (["-DREPNERV_PROBE_STAGES=4"], "swish", ("f32", "int8")),
    "exact_act": (["-DREPNERV_PROBE_EXACT_ACT"], "swish", ("int8",)),
    "bounded_spin": (["-DREPNERV_PROBE_BOUNDED_SPIN"], "swish", ("bf16", "f32", "int8")),
}
SOURCES = {"bf16": "decode_wgmma.cu", "f32": "decode_wgmma_tf32.cu", "int8": "decode_wgmma_s8.cu"}
HOST_CALLS = 50  # few enough that the launch queue never fills and blocks the host
# (name, B, H, W, Cin, C, stride, head width, with z): K1 / K2 at 8 frames, K3 at -b 1
SHAPES = [
    ("block2 b8", 8, 90, 160, 96, 96, 2, 0, False),
    ("block3 b8", 8, 180, 320, 96, 96, 2, 0, False),
    ("block4+head b8", 8, 360, 640, 96, 96, 2, 3, False),
    ("K3 block2 b1", 1, 90, 160, 96, 96, 2, 0, True),
    ("K3 block3 b1", 1, 180, 320, 96, 96, 2, 0, True),
    ("K3 block4+head b1", 1, 360, 640, 96, 96, 2, 3, True),
]


def build_variants(kind: str, names) -> dict:
    """One nvcc per variant, all started together; name -> loaded library."""
    out_dir = os.path.join(BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    jobs = {}
    for name in names:
        so = os.path.join(out_dir, f"libprobe_{kind}_{name}.so")
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-DREPNERV_PROBE", *VARIANTS[name][0], "-o", so, os.path.join(CSRC, SOURCES[kind])]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines() if "Used " in ln})
        print(f"[probe] built {kind} {name}; registers: {regs}; spills: {spills or 'none'}",
              flush=True)
        lib = ctypes.CDLL(so)
        # x, wt, wt2, b, scale, inv_out, head_w, head_b, out, z, B, H, W, Cin, C,
        # s, act, c_final, sigmoid_squash, stream
        lib.repnerv_probe_stage.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.repnerv_probe_stage.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(kind: str, gen: torch.Generator, bsz, h, w, cin, cout) -> tuple:
    """x, the K-major weights, their second part (f32) and the scale (int8) on
    the card, in the kernel's types."""
    x = torch.randn(bsz, h, w, cin, generator=gen).cuda()
    wt = (torch.randn(cout, 9 * cin, generator=gen) * (9 * cin) ** -0.5).cuda()
    if kind == "bf16":
        return x.bfloat16(), wt.bfloat16(), None, None
    if kind == "f32":
        hi, lo = split_tf32(wt)
        return x, hi, lo, None
    x_q = torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8)
    w_q = torch.clamp(torch.round(wt * 2000), -127, 127).to(torch.int8)
    return x_q, w_q, None, torch.full((cout,), 1.0 / (32 * 2000), device="cuda")


def main(argv=None) -> None:
    args = list(argv if argv is not None else sys.argv[1:])
    kind = args.pop(0) if args and args[0] in SOURCES else "bf16"
    names = args or [n for n, v in VARIANTS.items() if kind in v[2] and n != "bounded_spin"]
    for n in names:
        if n not in VARIANTS or kind not in VARIANTS[n][2]:
            raise SystemExit(f"probe_wgmma: no variant {n!r} for {kind}")
    if not torch.cuda.is_available():
        raise SystemExit("probe_wgmma: needs an NVIDIA GPU")
    libs = build_variants(kind, names)
    gen = torch.Generator().manual_seed(0)
    ptr = ctypes.c_void_p
    out_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[kind]

    def addr(t):
        return ptr(t.data_ptr() if t is not None else None)

    for sname, bsz, h, w, cin, c, s, c_final, with_z in SHAPES:
        if with_z and kind == "int8":
            continue  # no training forward in int8
        cout = s * s * c
        x, wt, wt2, scale = operands(kind, gen, bsz, h, w, cin, cout)
        b = torch.randn(cout, generator=gen).cuda()
        inv_out = torch.full((1,), 127.0 / 6, device="cuda") if kind == "int8" else None
        hw = torch.randn(c, 3, generator=gen).cuda() * c**-0.5 if c_final else None
        hb = torch.randn(3, generator=gen).cuda() if c_final else None
        out = torch.empty(bsz, h * s, w * s, c_final or c, device="cuda",
                          dtype=torch.float32 if c_final else out_dtype)
        z = torch.empty(bsz, h * s, w * s, c, device="cuda", dtype=out_dtype) if with_z else None
        ops = 2.0 * bsz * h * w * 9 * cin * cout
        for name, lib in libs.items():
            act = ACT_CODES[VARIANTS[name][1]]

            def run():
                err = lib.repnerv_probe_stage(
                    addr(x), addr(wt), addr(wt2), addr(b), addr(scale), addr(inv_out), addr(hw),
                    addr(hb), addr(out), addr(z), bsz, h, w, cin, c, s, act, c_final, 0,
                    ptr(torch.cuda.current_stream().cuda_stream))
                if err != 0:
                    raise RuntimeError(f"{name}: launch failed, cudaError {err}")

            ms = cuda_ms(run)
            print(f"[probe] {kind:4s} {sname:18s} {name:12s} {ms:8.3f} ms "
                  f"{ops / ms / 1e9:7.1f} TOP/s", flush=True)
            if kind == "bf16" and name == "kernel" and sname == "K3 block2 b1":
                # what the host pays per launch, the tensor-map encodes
                # included: calls made back to back, the card not waited for
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    run()
                host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
                torch.cuda.synchronize()
                print(f"[probe] {sname:18s} host time per launch call {host_us:.2f} us "
                      f"(ctypes call, 2 cuTensorMapEncodeTiled, 1 launch; mean of {HOST_CALLS})",
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
