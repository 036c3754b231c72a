"""Operations, bytes and bounds of the work a cell does, from its shapes.

The peaks, ``roofline``, ``sum_bounds`` and ``stage_ops`` are copies of
``chip_smoke.py``'s; the MAC count is the ``deploy=True`` arithmetic of
``repnerv_tpu_torch/utils/costs.py::generator_macs`` (one fused 3x3 conv a
block, which is what online reparameterisation runs).  Bytes count each
input read once and each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Dict, List

from reference.model import dims

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): operations per second by the unit a type can use, and bytes per
# second of device memory.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

BF16, F32, INT8 = 2, 4, 1  # bytes an element
KERNEL_MIN_PIXELS = 1024  # a block whose input has fewer pixels stays on the library conv


def roofline(ops: float, nbytes: float, unit: str) -> dict:
    """The least time the card could take for a piece of work:
        bound_ms = max(ops / PEAK_OPS[unit], nbytes / PEAK_BYTES) * 1e3
    ``bound_by`` names the larger."""
    ops_ms, bytes_ms = ops / PEAK_OPS[unit] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sum_bounds(rows: list) -> dict:
    """The bound of several calls: the sum of theirs; bound by what the
    larger share of that sum is bound by."""
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    total = sum(r["bound_ms"] for r in rows)
    return {"bound_ms": total, "bound_by": "operations" if by_ops >= total - by_ops else "bytes"}


def stage_ops(bsz: int, h: int, w: int, cin: int, c: int, s: int, c_final: int) -> float:
    """FLOPs of one fused stage: the 3x3 conv (2 * 9 * Cin * Cout per low-res
    pixel) and the 1x1 head (2 * C * c_final per output pixel)."""
    return 2.0 * bsz * h * w * s * s * c * (9 * cin + c_final)


def stages(m: dict) -> List[dict]:
    """Each block as (h, w, cin, c, s, head) at its input size, and whether
    it is large enough for the fused stage kernels."""
    d = dims(m)
    n = len(d["blocks"])
    return [{"h": d["hs"][i], "w": d["ws"][i], "cin": cin, "c": c, "s": s,
             "head": 3 if i == n - 1 else 0,
             "kernel": d["hs"][i] * d["ws"][i] >= KERNEL_MIN_PIXELS}
            for i, (cin, c, s) in enumerate(d["blocks"])]


def stem_flops(m: dict) -> float:
    st = dims(m)["stem"]
    return 2.0 * sum(a * b for a, b in zip(st[:-1], st[1:]))


def deploy_flops_per_frame(m: dict) -> float:
    """The fused forward of one frame: stem, one 3x3 conv a block, the head."""
    return stem_flops(m) + sum(stage_ops(1, g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"])
                               for g in stages(m))


def frame_seconds_at_peak(m: dict, int8_first: int = None) -> float:
    """Seconds one frame's decode would take with every stage at its unit's
    peak: bf16, or int8 for the blocks from ``int8_first`` on."""
    total = stem_flops(m) / PEAK_OPS["bf16"]
    for i, g in enumerate(stages(m)):
        unit = "int8" if int8_first is not None and i >= int8_first else "bf16"
        total += stage_ops(1, g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]) / PEAK_OPS[unit]
    return total


def k3_bound(g: dict, bsz: int = 1) -> dict:
    """K3 (the training forward stage, bf16): x, the packed weights, the f32
    bias and head read once; the output (f32 with the head) and the
    pre-activation z written once."""
    h, w, cin, c, s, head = g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]
    cout, out_px = c * s * s, bsz * h * w * s * s
    moved = (bsz * h * w * cin * BF16 + 9 * cin * cout * BF16 + cout * F32
             + (c * head + head) * F32 + out_px * (head * F32 if head else c * BF16)
             + out_px * c * BF16)
    return roofline(stage_ops(bsz, h, w, cin, c, s, head), moved, "bf16")


def k4_bound(g: dict, bsz: int = 1) -> dict:
    """K4 (the epilogue backward, bf16): z, the cotangent and (head) the
    output and head weight read; d_conv and the finished sums written; ~10
    FLOPs of activation derivative a z element and 4 a head output, on the
    FMA pipes."""
    h, w, cin, c, s, head = g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]
    cout, out_px = c * s * s, bsz * h * w * s * s
    z = out_px * c
    moved = (z * BF16 + out_px * (head * F32 if head else c * BF16)
             + (out_px * head * F32 + c * head * F32 if head else 0)
             + bsz * h * w * cout * BF16 + cout * F32 + (c * head + head) * F32)
    return roofline(z * (10.0 + 4 * head), moved, "f32")


def blur_ops(n, h, w_in, w_out, h_out, maps):
    """2 x 11 FLOPs per value of the column pass and of the row pass."""
    return 22.0 * maps * n * (h_out * w_in + h_out * w_out)


def k5_bounds(height: int, width: int) -> dict:
    """K5 of one step: the loss's SSIM at the frame size (the five moments
    and their VJP) and the MS-SSIM metric's five levels (the moments), 3
    channels, batch 1, f32: x and y read once and five maps written; the
    three cotangents, x and y read and d_x written."""
    rows = []
    calls = [(height, width, 1, 1)] + [(height >> i, width >> i, 1, 0) for i in range(5)]
    for h, w, n_fwd, n_vjp in calls:
        n = 3
        fwd = roofline(blur_ops(n, h, w, w - 10, h - 10, 5),
                       (2 * n * h * w + 5 * n * (h - 10) * (w - 10)) * F32, "f32")
        vjp = roofline(blur_ops(n, h + 10, w - 10, w, h, 3),
                       (3 * n * (h - 10) * (w - 10) + 3 * n * h * w) * F32, "f32")
        rows += [fwd] * n_fwd + [vjp] * n_vjp
    return sum_bounds(rows)


def k1_bound(g: dict, bsz: int) -> dict:
    """K1 (the decode stage, bf16): x, the packed weights, the f32 bias and
    head read once, the output written once."""
    h, w, cin, c, s, head = g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]
    cout, out_px = c * s * s, bsz * h * w * s * s
    moved = (bsz * h * w * cin * BF16 + 9 * cin * cout * BF16 + cout * F32
             + (c * head + head) * F32 + out_px * (head * F32 if head else c * BF16))
    return roofline(stage_ops(bsz, h, w, cin, c, s, head), moved, "bf16")


def k2_bound(g: dict, bsz: int) -> dict:
    """K2 (the int8 stage): the conv's operations on the int8 tensor cores
    against the int8 input, the weights and the output crossing device
    memory once."""
    h, w, cin, c, s, head = g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]
    cout, out_px = c * s * s, bsz * h * w * s * s
    moved = (bsz * h * w * cin * INT8 + 9 * cin * cout * INT8
             + out_px * (head * F32 if head else c * INT8))
    return roofline(stage_ops(bsz, h, w, cin, c, s, head), moved, "int8")


def train_bounds(m: dict, height: int, width: int) -> Dict[str, float]:
    """ms the card needs at least for one `-b 1` step's K3, K4 and K5 calls."""
    kern = [g for g in stages(m) if g["kernel"]]
    return {"K3": sum_bounds([k3_bound(g) for g in kern])["bound_ms"],
            "K4": sum_bounds([k4_bound(g) for g in kern])["bound_ms"],
            "K5": k5_bounds(height, width)["bound_ms"]}


def decode_bounds(m: dict, bsz: int, int8_first: int = None) -> Dict[str, float]:
    """ms the card needs at least for one batch's K1 and K2 calls."""
    k1, k2 = [], []
    for i, g in enumerate(stages(m)):
        if int8_first is not None and i >= int8_first:
            k2.append(k2_bound(g, bsz))
        elif g["kernel"]:
            k1.append(k1_bound(g, bsz))
    return {"K1": sum_bounds(k1)["bound_ms"] if k1 else 0.0,
            "K2": sum_bounds(k2)["bound_ms"] if k2 else 0.0}
