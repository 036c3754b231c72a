"""Where the wgmma + TMA stage kernel's time goes: build
``csrc/decode_wgmma.cu`` alone in several variants (its ``REPNERV_PROBE_*``
macros take a part out or change a design choice) and time each at the
flagship's bf16 shapes on one NVIDIA GPU.

    python -m repnerv_tpu_torch.kernels.probe_wgmma [variant ...]

Variants:
  kernel        the kernel as the port runs it (swish compiled in)
  relu          the same with the cheapest activation (the activation is chosen
                once per work item; swish costs 2 MUFU operations a value)
  gelu          ... and with the dearest (erff)
  no_epilogue   loads and products only
  no_products   loads only (with no_epilogue: the ring and the barriers)
  no_loads      products only, on whatever the ring holds
  one_item      one work item per block instead of the persistent grid
  nsub1         one sub-pixel per work item (N = 96) instead of two
  stages10      a ring of 10 slots instead of 6
One line per shape and variant: ms (CUDA-event median of 10 after a warm-up)
and the conv's TFLOP/s; at the smallest training shape also what one launch
costs the host (it encodes two tensor maps per launch); the last line is the
card's name and power limit.
A measurement tool: nothing in the port imports it.
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
from .decode import ACT_CODES

VARIANTS = {
    "kernel": ([], "swish"),
    "relu": ([], "relu"),
    "gelu": ([], "gelu"),
    "no_epilogue": (["-DREPNERV_PROBE_NO_EPILOGUE"], "swish"),
    "no_products": (["-DREPNERV_PROBE_NO_EPILOGUE", "-DREPNERV_PROBE_NO_PRODUCTS"], "swish"),
    "no_loads": (["-DREPNERV_PROBE_NO_EPILOGUE", "-DREPNERV_PROBE_NO_LOADS"], "swish"),
    "one_item": (["-DREPNERV_PROBE_ONE_ITEM_PER_BLOCK"], "swish"),
    "nsub1": (["-DREPNERV_PROBE_NSUB=1"], "swish"),
    "stages10": (["-DREPNERV_PROBE_STAGES=10"], "swish"),
}
HOST_CALLS = 50  # few enough that the launch queue never fills and blocks the host
# (name, B, H, W, Cin, C, stride, head width, with z): K1 at 8 frames, K3 at -b 1
SHAPES = [
    ("K1 block2 b8", 8, 90, 160, 96, 96, 2, 0, False),
    ("K1 block3 b8", 8, 180, 320, 96, 96, 2, 0, False),
    ("K1 block4+head b8", 8, 360, 640, 96, 96, 2, 3, False),
    ("K3 block2 b1", 1, 90, 160, 96, 96, 2, 0, True),
    ("K3 block3 b1", 1, 180, 320, 96, 96, 2, 0, True),
    ("K3 block4+head b1", 1, 360, 640, 96, 96, 2, 3, True),
]


def build_variants(names) -> dict:
    """One nvcc per variant, all started together; name -> loaded library."""
    out_dir = os.path.join(BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    jobs = {}
    for name in names:
        so = os.path.join(out_dir, f"libprobe_{name}.so")
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-DREPNERV_PROBE", *VARIANTS[name][0], "-o", so,
               os.path.join(CSRC, "decode_wgmma.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"[probe] built {name}; spills: {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(so)
        lib.repnerv_probe_stage_wgmma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.repnerv_probe_stage_wgmma.restype = ctypes.c_int
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


def main(argv=None) -> None:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("probe_wgmma: needs an NVIDIA GPU")
    libs = build_variants(names)
    gen = torch.Generator().manual_seed(0)
    ptr = ctypes.c_void_p
    for sname, bsz, h, w, cin, c, s, c_final, with_z in SHAPES:
        x = torch.randn(bsz, h, w, cin, generator=gen).cuda().bfloat16()
        wt = (torch.randn(s * s * c, 9 * cin, generator=gen) * (9 * cin) ** -0.5).cuda().bfloat16()
        b = torch.randn(s * s * c, generator=gen).cuda()
        hw = torch.randn(c, 3, generator=gen).cuda() * c**-0.5
        hb = torch.randn(3, generator=gen).cuda()
        out = torch.empty(bsz, h * s, w * s, c_final or c, device="cuda",
                          dtype=torch.float32 if c_final else torch.bfloat16)
        z = torch.empty(bsz, h * s, w * s, c, device="cuda", dtype=torch.bfloat16) if with_z else None
        flops = 2.0 * bsz * h * w * 9 * cin * s * s * c
        for name, lib in libs.items():
            act = ACT_CODES[VARIANTS[name][1]]

            def run():
                err = lib.repnerv_probe_stage_wgmma(
                    ptr(x.data_ptr()), ptr(wt.data_ptr()), ptr(b.data_ptr()),
                    ptr(hw.data_ptr() if c_final else None), ptr(hb.data_ptr() if c_final else None),
                    ptr(out.data_ptr()), ptr(z.data_ptr() if with_z else None),
                    bsz, h, w, cin, c, s, act, c_final, 0,
                    ptr(torch.cuda.current_stream().cuda_stream))
                if err != 0:
                    raise RuntimeError(f"{name}: launch failed, cudaError {err}")

            ms = cuda_ms(run)
            print(f"[probe] {sname:18s} {name:12s} {ms:8.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s",
                  flush=True)
            if name == "kernel" and with_z and sname.endswith("block2 b1"):
                # what the host pays per launch, the two tensor-map encodes
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
