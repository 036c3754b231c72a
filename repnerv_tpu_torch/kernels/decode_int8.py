"""int8 fused decode stage: int8 conv3x3 -> int32 -> dequant + bias -> act ->
PixelShuffle -> requant to int8 (or the 1x1 head + squash), the port of
``repnerv_tpu/pallas_kernels/decode_int8.py``.

On a CUDA tensor, ``decode_stage_int8`` launches a hand-written Hopper
kernel and nothing else: a launch that fails raises.  Which kernel is
``int8_route``'s answer, a pure function of the channel counts: stages with
Cin % 16 == 0, Cin <= 128, C % 8 == 0, C <= 96 and a head of at most 4
outputs (the flagship's blocks 3-4) run the wgmma + TMA kernel of
``csrc/decode_wgmma_s8.cu`` (``"wgmma"``), the other shapes the WMMA kernel of
``csrc/decode_int8.cu`` (``"wmma"``).  On a CPU tensor it runs the plain
PyTorch version, ``decode_stage_int8_reference``, which the tests also hold
the kernels and the JAX kernel against.

The scheme is the JAX package's (symmetric, no zero point, so SAME-padding
zeros stay exact), with its cast and rounding points, which the tests rely
on:

* weights, per output channel: ``sw = max(amax, 1e-12) / 127``,
  ``w_q = clip(round(w / sw), -127, 127)`` (``quantize_weight_int8``);
* activations, one static scale per stage from a calibration decode
  (``models/generator.calibrate_int8``): ``x_q = clip(round(f32(x) / sx))``
  -- a *division* by ``sx`` after a cast to f32 (``quantize_act_int8``).
  The first int8 block's input is quantised by this pass, or, where the
  block before it runs K1 on its wgmma route without a head on the card, by
  K1's own epilogue (``decode.decode_stage(out_scale=sx)``) with the same
  cast and rounding points: K1's f32 value rounded to the bf16 it would have
  stored, widened, divided by ``sx`` with IEEE rounding (torch's division by
  a tensor on the card), rounded half to even, clipped;
* the stage: the int8 x int8 products summed exactly in int32, then
  ``f32(acc) * scale`` and ``+ bias`` as two f32 operations with one
  rounding each (no FMA), ``scale = sx * sw``; the activation; then either
  the requantization ``clip(round(y * inv_out))`` -- a *multiplication* by
  ``inv_out = 1 / out_scale``, computed once in f32 as the JAX kernel does,
  which can differ from ``quantize_act_int8``'s division in the last ulp --
  or the head and squash in f32;
* every rounding is half to even (``jnp.round``, ``torch.round``, ``rintf``).

``pack_int8_stage`` puts a stage into the kernel's layout once per
calibration: the int8 implicit-GEMM operand [9*Cin, Cout] (rows (dy, dx,
ci), columns in shuffle-major order, ``decode.shuffle_weight_permutation``)
with ``scale`` and ``bias`` permuted the same way, and on the wgmma route its
K-major copy [Cout, 9*Cin].  ``fused_conv_ps_act_int8``
keeps the JAX function's signature and packs on every call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.layers import activation
from .build import load_library
from .decode import ACT_CODES, exact_f32, shuffle_weight_permutation, squash

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0
# ... and the same launches by the route they took
ROUTES = ("wmma", "wgmma")  # the index is the code csrc/decode_int8.cu takes
ROUTE_LAUNCHES: Dict[str, int] = dict.fromkeys(ROUTES, 0)
# what the wgmma kernel holds in one ring slot, in registers and shared memory
_WGMMA_MAX_CIN = 128
_WGMMA_MAX_C = 96
_WGMMA_MAX_HEAD = 4

_INT32_MAX = 2**31 - 1


def int8_route(cin: int, c: int, c_final: int) -> str:
    """Which kernel an int8 stage runs.  The wgmma kernel loads one whole
    pixel (up to 128 channels) as one 128-byte row by TMA, whose strides are
    multiples of 16 bytes (Cin % 16 == 0, Cin <= 128); it stores 8 channels a
    lane and holds one sub-pixel's channels in one tile (C % 8 == 0, C <= 96)
    and a head of at most 4 outputs; every stride takes it."""
    fits = (cin % 16 == 0 and 0 < cin <= _WGMMA_MAX_CIN and c % 8 == 0
            and 0 < c <= _WGMMA_MAX_C and c_final <= _WGMMA_MAX_HEAD)
    return "wgmma" if fits else "wmma"


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8: w [..., Cout] -> (w_q int8, sw f32 [Cout])."""
    amax = w.reshape(-1, w.shape[-1]).abs().amax(dim=0)
    sw = torch.clamp_min(amax, 1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
    return w_q, sw.to(torch.float32)


def quantize_act_int8(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Symmetric activation quantization with a static scale: divide the f32
    value by ``sx``, round half to even, clip to [-127, 127]."""
    return torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)


@dataclass(frozen=True)
class PackedInt8Stage:
    """One int8 decode stage in the kernel's layout."""

    w: torch.Tensor  # [9*Cin, Cout] int8; rows (dy, dx, ci), columns shuffle-major
    scale: torch.Tensor  # [Cout] f32 (sx * sw), shuffle-major
    b: torch.Tensor  # [Cout] f32, shuffle-major
    stride: int
    inv_out: Optional[torch.Tensor] = None  # [1] f32, 1/out_scale: requantize
    head_w: Optional[torch.Tensor] = None  # [C, c_final] f32: fused head
    head_b: Optional[torch.Tensor] = None  # [c_final] f32
    wt: Optional[torch.Tensor] = None  # [Cout, 9*Cin] int8: w transposed, on the wgmma route only

    @property
    def c_final(self) -> int:
        return 0 if self.head_w is None else self.head_w.shape[1]

    @property
    def route(self) -> str:
        return int8_route(self.cin, self.c, self.c_final)

    @property
    def cin(self) -> int:
        return self.w.shape[0] // 9

    @property
    def c(self) -> int:
        return self.w.shape[1] // (self.stride * self.stride)


def pack_int8_stage(
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: int,
    *,
    out_scale: Optional[torch.Tensor] = None,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
) -> PackedInt8Stage:
    """HWIO int8 conv weight [3, 3, Cin, Cout] (PixelShuffle channel order),
    scale and bias [Cout], and exactly one of ``out_scale`` (scalar: the next
    stage's input scale) or the HWIO head [1, 1, C, c_final] ->
    ``PackedInt8Stage``."""
    kh, kw, cin, cout = w_q.shape
    if (kh, kw) != (3, 3) or cout % (stride * stride) or w_q.dtype != torch.int8:
        raise ValueError(f"need a 3x3 int8 kernel with Cout divisible by s^2, got "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    if (out_scale is None) == (head_w is None):
        raise ValueError("need exactly one output mode: out_scale or head_w")
    dev = w_q.device
    perm = shuffle_weight_permutation(cout, stride, dev)
    w2 = w_q[..., perm].reshape(9 * cin, cout).contiguous()
    scale2 = scale.to(torch.float32)[perm].contiguous()
    if bias is None:
        bias = torch.zeros(cout, device=dev)
    b2 = bias.to(torch.float32)[perm].contiguous()
    if head_w is None:
        inv_out = (1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=dev)).reshape(1)
        p = PackedInt8Stage(w2, scale2, b2, stride, inv_out=inv_out)
    else:
        hw = head_w[0, 0].to(torch.float32).contiguous()
        hb = (
            head_b.to(torch.float32) if head_b is not None
            else torch.zeros(hw.shape[1], device=dev)
        ).contiguous()
        p = PackedInt8Stage(w2, scale2, b2, stride, head_w=hw, head_b=hb)
    if p.route != "wgmma":
        return p
    return dataclasses.replace(p, wt=w2.t().contiguous())


def int_conv3x3(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact integer sum of a SAME conv3x3 of int8 x [B, H, W, Cin] with
    the packed int8 operand w [9*Cin, Cout], as f32 [B, H, W, Cout]: one
    matmul per tap, in f32 while every partial sum stays below 2^24 (then
    each is exact, 9*Cin*128^2 < 2^24 for Cin <= 113), in float64 above
    that width and then rounded to f32 once."""
    bsz, h, wd, cin = x_q.shape
    dt = torch.float32 if 9 * cin * 128 * 128 < 2**24 else torch.float64
    xp = F.pad(x_q.to(dt), (0, 0, 1, 1, 1, 1))
    wk = w.to(dt).reshape(9, cin, -1)
    acc = None
    with exact_f32():
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            part = xp[:, dy : dy + h, dx : dx + wd, :].reshape(-1, cin) @ wk[tap]
            acc = part if acc is None else acc + part
    return acc.reshape(bsz, h, wd, -1).to(torch.float32)


def decode_stage_int8_reference(
    x_q: torch.Tensor, p: PackedInt8Stage, act: str = "swish", out_squash: str = "tanh"
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with its cast points: the
    exact integer sum, ``f32(acc) * scale`` then ``+ bias``, the shuffle-major
    pixel shuffle, the activation, then the requantization or the f32 head
    and squash."""
    bsz, h, wd, _ = x_q.shape
    s, c = p.stride, p.c
    y = int_conv3x3(x_q, p.w) * p.scale
    y = y + p.b
    # shuffle-major pixel shuffle: channel (i*s + j)*C + c -> (h*s+i, w*s+j, c)
    y = y.reshape(bsz, h, wd, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(bsz, h * s, wd * s, c)
    y = activation(y, act)
    if p.head_w is None:
        return torch.clamp(torch.round(y * p.inv_out), -127, 127).to(torch.int8)
    with exact_f32():
        return squash(torch.matmul(y, p.head_w) + p.head_b, out_squash)


def check_int8_args(x_q: torch.Tensor, p: PackedInt8Stage, act: str, out_squash: str) -> int:
    """Raise on what the kernel does not take; return the head width (0
    without a head)."""
    bsz, h, w, cin = x_q.shape
    c_final = p.c_final
    tensors = [x_q, p.w, p.scale, p.b] + ([p.head_w, p.head_b] if c_final else [p.inv_out])
    if p.route == "wgmma":
        if (p.wt is None or p.wt.shape != (p.w.shape[1], p.w.shape[0])
                or p.wt.dtype != torch.int8):
            raise ValueError("decode_stage_int8: the wgmma route needs the K-major weights "
                             "(pack_int8_stage)")
        tensors.append(p.wt)
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("decode_stage_int8: x_q and the packed stage must share a device")
    if x_q.dtype != torch.int8 or p.w.dtype != torch.int8:
        raise TypeError(f"decode_stage_int8: x_q is {x_q.dtype}, weights {p.w.dtype}; need int8")
    if any(t.dtype != torch.float32 for t in tensors[2:] if t is not p.wt):
        raise TypeError("decode_stage_int8: scale, bias, inv_out and the head must be f32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_stage_int8: x_q (NHWC) and the packed stage must be contiguous")
    if cin != p.cin or p.stride not in (1, 2, 3, 4, 5) or not 0 <= c_final <= 16:
        raise ValueError(
            f"decode_stage_int8: x_q {tuple(x_q.shape)} vs weights {tuple(p.w.shape)}, "
            f"stride {p.stride}, head width {c_final}"
        )
    if act not in ACT_CODES or out_squash not in ("tanh", "sigmoid"):
        raise ValueError(f"decode_stage_int8: act {act!r}, squash {out_squash!r}")
    if h >= 2**14 or w >= 2**14:
        raise ValueError("decode_stage_int8: H and W must be below 16384")
    return c_final


def decode_stage_int8(
    x_q: torch.Tensor, p: PackedInt8Stage, act: str = "swish", out_squash: str = "tanh"
) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; run the plain version on a CPU one.
    Returns int8 [B, H*s, W*s, C], or f32 [B, H*s, W*s, c_final] with a head."""
    global LAUNCHES
    if x_q.device.type == "cpu":
        return decode_stage_int8_reference(x_q, p, act, out_squash)
    if x_q.device.type != "cuda":
        raise ValueError(f"decode_stage_int8 runs on cuda or cpu tensors, not {x_q.device}")
    c_final = check_int8_args(x_q, p, act, out_squash)
    bsz, h, w, _ = x_q.shape
    s = p.stride
    out = torch.empty(
        bsz, h * s, w * s, c_final or p.c, device=x_q.device,
        dtype=torch.float32 if c_final else torch.int8,
    )
    if out.numel() == 0:
        return out
    if max(x_q.numel(), p.w.numel(), out.numel()) > _INT32_MAX:
        raise ValueError("decode_stage_int8: tensors must hold fewer than 2**31 elements")
    lib = load_library()  # builds csrc/*.cu on first use
    ptr = ctypes.c_void_p
    route = p.route
    with torch.cuda.device(x_q.device):  # the runtime launches on the current device
        err = lib.repnerv_fused_conv_ps_act_int8(
            ROUTES.index(route),
            ptr(x_q.data_ptr()),
            ptr(p.w.data_ptr()),
            ptr(p.wt.data_ptr() if route == "wgmma" else None),
            ptr(p.scale.data_ptr()),
            ptr(p.b.data_ptr()),
            ptr(p.inv_out.data_ptr() if not c_final else None),
            ptr(p.head_w.data_ptr() if c_final else None),
            ptr(p.head_b.data_ptr() if c_final else None),
            ptr(out.data_ptr()),
            bsz, h, w, p.cin, p.c, s,
            ACT_CODES[act],
            c_final,
            int(out_squash == "sigmoid"),
            ptr(torch.cuda.current_stream(x_q.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"int8 stage kernel ({route}) launch failed: cudaError {err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def fused_conv_ps_act_int8(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: int,
    act: str = "swish",
    *,
    out_scale: Optional[torch.Tensor] = None,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
    out_squash: Optional[str] = None,
) -> torch.Tensor:
    """act(pixel_shuffle(dequant(conv3x3_int8(x_q)) + bias)) [-> head | requant],
    the JAX signature: x_q [B, H, W, Cin] int8; w_q [3, 3, Cin, Cout] int8 in
    PixelShuffle channel order; scale [Cout] f32 = sx * sw; exactly one of
    ``out_scale`` (int8 out) or ``head_w`` (f32 out)."""
    p = pack_int8_stage(w_q, scale, bias, stride, out_scale=out_scale, head_w=head_w,
                        head_b=head_b)
    return decode_stage_int8(x_q.contiguous(), p, act, out_squash or "tanh")
