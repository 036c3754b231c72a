"""Where the time of the training-side kernels goes: build
``csrc/train_tail.cu`` (K4, the epilogue backward) or ``csrc/ssim_blur.cu``
(K5, the SSIM blur) alone in several variants (their ``REPNERV_PROBE_*``
macros take a part out or change a design choice) and time each at the
flagship's ``-b 1`` shapes on one NVIDIA GPU.

    python -m repnerv_tpu_torch.kernels.probe_train [k4|k5] [variant ...]

Variants of k4 (each in bf16 and f32, swish, blocks 1-4, block 4 with the head):
  kernel     the kernel as the port runs it
  fast_act   swish' through __expf and __fdividef in f32 too (bf16 takes them)
  exact_act  swish' through expf and a division in bf16 too (f32 takes them)
  no_act     loads, stores and sums only (act' = 1)
  u2, u8     2 / 8 vectors a thread in flight instead of 4
  bps1, bps4 1 / 4 blocks per SM in the persistent grid instead of 2
  no_tail    without the last block's sum of the blocks' rows (wrong sums)
Variants of k5 (the loss's image [1, 720, 1280, 3]: the SSIM means alone, the
means with the moments kept, their VJP, and one map):
  kernel         the kernel as the port runs it
  no_horizontal  the column pass and the stores only
  no_loads       values made up in registers instead of loaded: the arithmetic,
                 the shared memory and the stores only
  cols64         tiles of 64 input columns and 128 threads, 4 blocks an SM
                 instead of 128 columns, 256 threads, 2 blocks
One line per shape and variant: ms a launch (CUDA-event median of 10 timings
of 20 launches back to back, after a warm-up: the host's time per call, which
is longer than the small kernels, stays outside), GB/s of the bytes the call
must move and, for k4 fast_act and exact_act, the largest difference of d_conv
from the kernel's; the last line is the card's name and power limit.  A measurement
tool: nothing in the port imports it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from .build import ARCH, BUILD_DIR, CSRC, find_nvcc
from .decode import ACT_CODES
from .probe_wgmma import cuda_ms as cuda_ms_of_one_call

LAUNCHES_PER_TIMING = 20

VARIANTS = {
    "k4": {
        "kernel": [],
        "fast_act": ["-DREPNERV_PROBE_FAST_ACT"],
        "exact_act": ["-DREPNERV_PROBE_EXACT_ACT"],
        "no_act": ["-DREPNERV_PROBE_NO_ACT"],
        "u2": ["-DREPNERV_PROBE_U=2"],
        "u8": ["-DREPNERV_PROBE_U=8"],
        "bps1": ["-DREPNERV_PROBE_BLOCKS_PER_SM=1"],
        "bps4": ["-DREPNERV_PROBE_BLOCKS_PER_SM=4"],
        "no_tail": ["-DREPNERV_PROBE_NO_TAIL"],
    },
    "k5": {"kernel": [], "no_horizontal": ["-DREPNERV_PROBE_NO_HORIZONTAL"],
           "no_loads": ["-DREPNERV_PROBE_NO_LOADS"],
           "cols64": ["-DREPNERV_PROBE_COLS=64"]},
}
SOURCES = {"k4": "train_tail.cu", "k5": "ssim_blur.cu"}
# (name, H, W, C, stride, head width) of the fused stages at -b 1
K4_SHAPES = [("block1", 45, 80, 96, 2, 0), ("block2", 90, 160, 96, 2, 0),
             ("block3", 180, 320, 96, 2, 0), ("block4+head", 360, 640, 96, 2, 3)]
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_variants(kind: str, names) -> dict:
    """One nvcc per variant, all started together; name -> loaded library."""
    out_dir = os.path.join(BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    jobs = {}
    for name in names:
        so = os.path.join(out_dir, f"libprobe_{kind}_{name}.so")
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *VARIANTS[kind][name], "-o", so, os.path.join(CSRC, SOURCES[kind])]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"[probe] built {kind} {name}; spills: {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(so)
        if kind == "k4":
            lib.repnerv_train_stage_bwd.argtypes = [I, *[P] * 11, *[I] * 8, P]
            lib.repnerv_train_stage_bwd.restype = I
            lib.repnerv_train_stage_bwd_workspace.argtypes = [I] * 7
            lib.repnerv_train_stage_bwd_workspace.restype = ctypes.c_longlong
        else:
            lib.repnerv_ssim_stats.argtypes = [*[P] * 4, *[I] * 5, P, I, F, F, P]
            lib.repnerv_ssim_stats_vjp.argtypes = [*[P] * 10, I, I, I, I, P, I, F, F, P]
            lib.repnerv_gauss_blur_valid.argtypes = [P, P, I, I, I, P, I, I, P]
        libs[name] = lib
    return libs


def cuda_ms(fn) -> float:
    """ms of one launch when LAUNCHES_PER_TIMING follow each other."""
    def many():
        for _ in range(LAUNCHES_PER_TIMING):
            fn()

    return cuda_ms_of_one_call(many) / LAUNCHES_PER_TIMING


def addr(t):
    return P(t.data_ptr() if t is not None else None)


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def checked(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed, cudaError {err}")


def probe_k4(libs: dict) -> None:
    gen = torch.Generator().manual_seed(0)
    ticket = torch.zeros(64, dtype=torch.int32, device="cuda")
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        dname = str(dtype).replace("torch.", "")
        for sname, h, w, c, s, cf in K4_SHAPES:
            z = (torch.randn(1, h * s, w * s, c, generator=gen) * 2).cuda().to(dtype)
            ct = torch.randn(1, h * s, w * s, cf or c, generator=gen).cuda()
            ct = ct if cf else ct.to(dtype)
            out = torch.rand(1, h * s, w * s, cf, generator=gen).cuda() if cf else None
            hw = (torch.randn(c, cf, generator=gen) * c**-0.5).cuda() if cf else None
            d_b = torch.empty(s * s * c, device="cuda")
            d_hw = torch.empty(c, cf, device="cuda") if cf else None
            d_hb = torch.empty(cf, device="cuda") if cf else None
            moved = sum(t.numel() * t.element_size() for t in (z, ct, out) if t is not None)
            moved += z.numel() * z.element_size()  # d_conv
            results = {}
            for name, lib in libs.items():
                d_conv = torch.empty(1, h, w, s * s * c, device="cuda", dtype=dtype)
                work = torch.empty(lib.repnerv_train_stage_bwd_workspace(code, 1, h, w, c, s, cf),
                                   device="cuda")

                def run():
                    checked(lib.repnerv_train_stage_bwd(
                        code, addr(z), addr(None if cf else ct), addr(ct if cf else None),
                        addr(out), addr(hw), addr(d_conv), addr(d_b), addr(d_hw), addr(d_hb),
                        addr(work), addr(ticket), 1, h, w, c, s, ACT_CODES["swish"], cf, 0,
                        stream()), name)

                ms = cuda_ms(run)
                torch.cuda.synchronize()
                results[name] = d_conv
                note = ""
                if name in ("fast_act", "exact_act") and "kernel" in results:
                    diff = (d_conv.float() - results["kernel"].float()).abs()
                    note = (f"  d_conv vs kernel: max|d| {diff.max().item():.3e}, share differing "
                            f"{(diff > 0).float().mean().item():.3e}")
                print(f"[probe] k4 {dname:8s} {sname:12s} {name:9s} {ms:8.4f} ms "
                      f"{moved / ms / 1e6:8.1f} GB/s{note}", flush=True)


def probe_k5(libs: dict) -> None:
    from .ssim_blur import TILE_COLS, TILE_ROWS, window_tuple

    gen = torch.Generator().manual_seed(0)
    win = window_tuple(11, 1.5)
    taps = (ctypes.c_float * 11)(*win)
    tp = ctypes.cast(taps, P)
    c1, c2 = 0.01**2, 0.03**2
    n, h, w = 3, 720, 1280
    x, y = torch.rand(1, h, w, n, generator=gen).cuda(), torch.rand(1, h, w, n, generator=gen).cuda()
    mom = torch.empty(5, n, h - 10, w - 10, device="cuda")
    g = torch.randn(2, n, generator=gen).cuda()
    d = torch.empty_like(x)
    one = torch.empty(n, h - 10, w - 10, device="cuda")
    image, small = n * h * w * 4, n * (h - 10) * (w - 10) * 4
    for name, lib in libs.items():
        tw = (64 if name == "cols64" else TILE_COLS) - 10  # the variant's output columns a block
        tiles = -(-(w - 10) // tw) * -(-(h - 10) // TILE_ROWS)
        partial = torch.empty(2, n, tiles, device="cuda")

        def stats(keep):
            return lib.repnerv_ssim_stats(addr(x), addr(y), addr(mom if keep else None),
                                          addr(partial), n, h, w, n, tiles, tp, 11, c1, c2,
                                          stream())

        calls = {
            "stats": (lambda: stats(False), 2 * image),
            "stats_grad": (lambda: stats(True), 2 * image + 5 * small),
            "stats VJP": (lambda: lib.repnerv_ssim_stats_vjp(
                *[addr(m) for m in mom], addr(g[0]), addr(g[1]), addr(x), addr(y), addr(d),
                n, h, w, n, tp, 11, c1, c2, stream()), 5 * small + 3 * image),
            # x's values as [n, h, w] planes
            "one map": (lambda: lib.repnerv_gauss_blur_valid(addr(x), addr(one), n, h, w, tp, 11,
                                                             0, stream()), image + small),
        }
        for what, (call, moved) in calls.items():
            ms = cuda_ms(lambda: checked(call(), f"{name} {what}"))
            print(f"[probe] k5 {what:12s} {name:14s} {ms:8.4f} ms {moved / ms / 1e6:8.1f} GB/s",
                  flush=True)


def main(argv=None) -> None:
    args = list(argv if argv is not None else sys.argv[1:])
    kind = args.pop(0) if args and args[0] in VARIANTS else "k4"
    names = args or list(VARIANTS[kind])
    for name in names:
        if name not in VARIANTS[kind]:
            raise SystemExit(f"probe_train: no variant {name!r} for {kind}")
    if not torch.cuda.is_available():
        raise SystemExit("probe_train: needs an NVIDIA GPU")
    libs = build_variants(kind, names)
    (probe_k4 if kind == "k4" else probe_k5)(libs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
