"""Fused decode stage: conv3x3 + bias + PixelShuffle + activation (+ 1x1 head
+ squash), the port of ``repnerv_tpu/pallas_kernels/decode.py``.

On a CUDA tensor, ``decode_stage`` launches a hand-written Hopper kernel and
nothing else: a launch that fails raises.  Which kernel is ``stage_route``'s
answer, a pure function of the stage's type and channel counts.  Stages with
C in multiples of 8 up to 96 and a head of at most 4 outputs run the wgmma +
TMA mainloop of ``csrc/stage_wgmma.cuh``: bf16 with Cin % 8 == 0 through
``csrc/decode_wgmma.cu`` (``"wgmma"``), f32 with Cin % 4 == 0 through
``csrc/decode_wgmma_tf32.cu`` (``"wgmma_tf32x3"``: each f32 product as three
TF32 tensor-core products, see ``split_tf32``).  The other shapes run
``csrc/decode.cu``: bf16 its WMMA kernel, f32 its FMA kernel.  On a CPU tensor
it runs the plain PyTorch version, ``decode_stage_reference``, which the tests
also hold the kernel and the JAX kernel against.

The weights go into the kernel's layout once (``pack_weights``): an
implicit-GEMM operand [9*Cin, Cout] in the compute dtype whose columns are
in shuffle-major order, so one sub-pixel's C channels are contiguous and
pixel shuffle becomes the store's index arithmetic; stages on a wgmma route
also get its K-major copy [Cout, 9*Cin], in f32 split into its two TF32 parts
[2, Cout, 9*Cin].  ``fused_conv_ps_act``
keeps the JAX function's signature and layouts (x NHWC, w HWIO in
PixelShuffle channel order) and packs on every call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import activation, exact_f32
from .build import load_library

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0
# ... and the same launches by the route they took
ROUTES = ("fma", "wmma", "wgmma", "wgmma_tf32x3")  # the index is the code csrc/decode.cu takes
ROUTE_LAUNCHES: Dict[str, int] = dict.fromkeys(ROUTES, 0)
# what the wgmma kernels hold in registers and shared memory
_WGMMA_MAX_C = 96
_WGMMA_MAX_HEAD = 4

# activation name -> the code csrc/decode.cu's apply_act switches on
ACT_CODES = {
    "relu": 0,
    "leaky": 1,
    "leaky01": 2,
    "relu6": 3,
    "gelu": 4,
    "sin": 5,
    "swish": 6,
    "softplus": 7,
    "hardswish": 8,
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# route -> the shape of PackedStage.wt for a packed operand [K, Cout]
_WT_SHAPE = {"wgmma": lambda cout, k: (cout, k), "wgmma_tf32x3": lambda cout, k: (2, cout, k)}
_INT32_MAX = 2**31 - 1


def stage_route(dtype: torch.dtype, cin: int, c: int, stride: int, c_final: int) -> str:
    """Which kernel a stage runs: ``"wgmma"`` or ``"wmma"`` (bf16),
    ``"wgmma_tf32x3"`` or ``"fma"`` (f32).  The wgmma kernels load their tiles
    by TMA, whose strides are multiples of 16 bytes (Cin % 8 == 0 in bf16,
    Cin % 4 == 0 in f32); they store channel pairs and hold one sub-pixel's
    channels in one tile (C % 8 == 0, C <= 96) and a head of at most 4
    outputs; every stride takes them."""
    fits = c % 8 == 0 and 0 < c <= _WGMMA_MAX_C and c_final <= _WGMMA_MAX_HEAD
    if dtype == torch.bfloat16:
        return "wgmma" if fits and cin % 8 == 0 else "wmma"
    return "wgmma_tf32x3" if fits and cin > 0 and cin % 4 == 0 else "fma"


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 number (10 mantissa bits, ties away from zero:
    ``cvt.rna.tf32.f32``) as f32 with the low 13 bits clear.  Integer
    arithmetic on the bits, on ``v``'s device."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo), both TF32 numbers: ``hi = tf32_round(v)``, ``lo =
    tf32_round(v - hi)``.  ``v - hi`` is exact in f32, so ``hi + (v - hi) ==
    v`` to the bit and ``|v - (hi + lo)| <= 2^-22 |v|``.  The f32 wgmma kernel
    sums ``a_lo * b_hi + a_hi * b_lo + a_hi * b_hi``: each product of two TF32
    numbers is exact in the tensor core, whatever it does with the low 13
    bits, and what is dropped is ~2^-22 of ``a * b``."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def shuffle_weight_permutation(cout: int, stride: int, device=None) -> torch.Tensor:
    """perm such that w[..., perm] reorders PyTorch pixel-shuffle channel
    order (c*s*s + i*s + j) into shuffle-major order ((i*s + j)*C + c).
    Built on ``device`` itself: a copy from host memory would make the
    stream wait."""
    s = stride
    c = cout // (s * s)
    idx = torch.arange(cout, device=device)
    return (idx % c) * s * s + idx // c


# (Cout, stride, device) -> (perm, its inverse), made once
_PERMUTATIONS: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def shuffle_permutations(cout: int, stride: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``shuffle_weight_permutation`` and its inverse (``inv[perm] ==
    arange``: ``v[perm].index_select(0, inv) == v``), built once per (Cout,
    stride, device) and kept, so that a train step launches no kernel for them."""
    key = (cout, stride, torch.device(device))
    if key not in _PERMUTATIONS:
        perm = shuffle_weight_permutation(cout, stride, key[2])
        _PERMUTATIONS[key] = (perm, torch.argsort(perm))
    return _PERMUTATIONS[key]


@dataclass(frozen=True)
class PackedStage:
    """One decode stage's weights in the kernel's layout."""

    w: torch.Tensor  # [9*Cin, Cout] compute dtype; rows (dy, dx, ci), columns shuffle-major
    b: torch.Tensor  # [Cout] f32, shuffle-major
    stride: int
    head_w: Optional[torch.Tensor] = None  # [C, c_final] f32
    head_b: Optional[torch.Tensor] = None  # [c_final] f32
    # w transposed, on the wgmma routes only: [Cout, 9*Cin] bf16, or its two
    # TF32 parts (split_tf32) [2, Cout, 9*Cin] f32
    wt: Optional[torch.Tensor] = None

    @property
    def c_final(self) -> int:
        return 0 if self.head_w is None else self.head_w.shape[1]

    @property
    def route(self) -> str:
        return stage_route(self.w.dtype, self.cin, self.c, self.stride, self.c_final)

    @property
    def cin(self) -> int:
        return self.w.shape[0] // 9

    @property
    def c(self) -> int:
        return self.w.shape[1] // (self.stride * self.stride)


def pack_weights(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    compute_dtype: torch.dtype,
    *,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
) -> PackedStage:
    """HWIO conv weight [3, 3, Cin, Cout] (PixelShuffle channel order), bias
    [Cout] and optional HWIO head [1, 1, C, c_final] -> ``PackedStage``."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cout % (stride * stride):
        raise ValueError(f"need a 3x3 kernel with Cout divisible by s^2, got {tuple(w.shape)}")
    perm, _ = shuffle_permutations(cout, stride, w.device)
    w2 = w[..., perm].reshape(9 * cin, cout).to(compute_dtype).contiguous()
    if b is None:
        b = torch.zeros(cout, device=w.device)
    b2 = b[perm].to(torch.float32).contiguous()
    hw = hb = None
    if head_w is not None:
        hw = head_w[0, 0].to(torch.float32).contiguous()
        hb = (
            head_b.to(torch.float32)
            if head_b is not None
            else torch.zeros(hw.shape[1], device=w.device)
        ).contiguous()
    p = PackedStage(w2, b2, stride, hw, hb)
    if p.route == "wgmma":
        return dataclasses.replace(p, wt=w2.t().contiguous())
    if p.route == "wgmma_tf32x3":
        return dataclasses.replace(p, wt=torch.stack(split_tf32(w2.t().contiguous())))
    return p


def squash(y: torch.Tensor, out_squash: str) -> torch.Tensor:
    return torch.sigmoid(y) if out_squash == "sigmoid" else (torch.tanh(y) + 1.0) * 0.5


def stage_reference(
    x: torch.Tensor, p: PackedStage, act: str, out_squash: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the stage kernels, with their cast
    points: inputs in the compute dtype, then f32 conv, bias, activation,
    head and squash; the output in the compute dtype, or f32 with a head.
    Returns (out, the f32 pixel-shuffled pre-activation [B, H*s, W*s, C])."""
    cd = p.w.dtype
    s, c = p.stride, p.c
    bsz, h, w, cin = x.shape
    wk = p.w.float().reshape(3, 3, cin, -1).permute(3, 2, 0, 1)  # OIHW, shuffle-major O
    with exact_f32():
        acc = F.conv2d(x.to(cd).float().permute(0, 3, 1, 2), wk, padding=1)
        acc = acc.permute(0, 2, 3, 1) + p.b  # [B, H, W, s*s*C]
        # shuffle-major pixel shuffle: channel (i*s + j)*C + c -> (h*s+i, w*s+j, c)
        pre = acc.reshape(bsz, h, w, s, s, c).permute(0, 1, 3, 2, 4, 5)
        pre = pre.reshape(bsz, h * s, w * s, c)
        y = activation(pre, act)
        if p.head_w is None:
            return y.to(cd), pre
        return squash(torch.matmul(y, p.head_w) + p.head_b, out_squash), pre


def decode_stage_reference(
    x: torch.Tensor, p: PackedStage, act: str = "swish", out_squash: str = "tanh"
) -> torch.Tensor:
    """The plain version of ``decode_stage``."""
    return stage_reference(x, p, act, out_squash)[0]


def check_stage_args(
    name: str, x: torch.Tensor, p: PackedStage, act: str, out_squash: str
) -> int:
    """Raise on what the stage kernels do not take; return the head width
    (0 without a head)."""
    bsz, h, w, cin = x.shape
    s = p.stride
    c_final = p.c_final
    tensors = [x, p.w, p.b] + ([p.head_w, p.head_b] if c_final else [])
    if p.route in _WT_SHAPE:
        want = _WT_SHAPE[p.route](p.w.shape[1], p.w.shape[0])
        if p.wt is None or tuple(p.wt.shape) != want or p.wt.dtype != p.w.dtype:
            raise ValueError(f"{name}: the {p.route} route needs the K-major weights "
                             f"{want} (pack_weights)")
        tensors.append(p.wt)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: x and the packed weights must share a device")
    if x.dtype != p.w.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x is {x.dtype}, weights {p.w.dtype}; need f32 or bf16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: x (NHWC) and the packed weights must be contiguous")
    if cin != p.cin or s not in (1, 2, 3, 4, 5) or not 0 <= c_final <= 16:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} vs weights {tuple(p.w.shape)}, stride {s}, "
            f"head width {c_final}"
        )
    if act not in ACT_CODES or out_squash not in ("tanh", "sigmoid"):
        raise ValueError(f"{name}: act {act!r}, squash {out_squash!r}")
    if h >= 2**14 or w >= 2**14:
        raise ValueError(f"{name}: H and W must be below 16384")
    return c_final


def decode_stage(
    x: torch.Tensor, p: PackedStage, act: str = "swish", out_squash: str = "tanh"
) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; run the plain version on a CPU one."""
    global LAUNCHES
    if x.device.type == "cpu":
        return decode_stage_reference(x, p, act, out_squash)
    if x.device.type != "cuda":
        raise ValueError(f"decode_stage runs on cuda or cpu tensors, not {x.device}")
    bsz, h, w, _ = x.shape
    c_final = check_stage_args("decode_stage", x, p, act, out_squash)
    out_dtype = torch.float32 if c_final else x.dtype
    s = p.stride
    out = torch.empty(bsz, h * s, w * s, c_final or p.c, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    route = launch_stage_kernel(x, p, act, out_squash, out)
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def launch_stage_kernel(
    x: torch.Tensor,
    p: PackedStage,
    act: str,
    out_squash: str,
    out: torch.Tensor,
    z: Optional[torch.Tensor] = None,
) -> str:
    """Launch the stage kernel that ``p.route`` names on checked CUDA inputs:
    the decode stage, or with ``z`` the training forward, which also stores
    the pre-activation there.  A refused launch raises.  Returns the route."""
    bsz, h, w, cin = x.shape
    c_final = p.c_final
    route = p.route
    sizes = [x.numel(), p.w.numel(), out.numel()] + ([z.numel()] if z is not None else [])
    if max(sizes) > _INT32_MAX:
        raise ValueError("stage kernel: tensors must hold fewer than 2**31 elements")
    lib = load_library()  # builds csrc/*.cu on first use
    ptr = ctypes.c_void_p
    pointers = [
        ptr(x.data_ptr()),
        ptr(p.w.data_ptr()),
        ptr(p.wt.data_ptr() if route in _WT_SHAPE else None),
        ptr(p.b.data_ptr()),
        ptr(p.head_w.data_ptr() if c_final else None),
        ptr(p.head_b.data_ptr() if c_final else None),
        ptr(out.data_ptr()),
    ]
    if z is None:
        entry = lib.repnerv_fused_conv_ps_act
    else:
        entry = lib.repnerv_train_stage_fwd
        pointers.append(ptr(z.data_ptr()))
    with torch.cuda.device(x.device):  # the runtime launches on the current device
        err = entry(
            ROUTES.index(route),
            *pointers,
            bsz, h, w, cin, p.c, p.stride,
            ACT_CODES[act],
            c_final,
            int(out_squash == "sigmoid"),
            ptr(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"stage kernel ({route}) launch failed: cudaError {err}")
    return route


def fused_conv_ps_act(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    act: str = "swish",
    *,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
    out_squash: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(pixel_shuffle(conv3x3(x) + b)) [-> 1x1 head -> squash], the JAX
    signature: x [B, H, W, Cin]; w [3, 3, Cin, C*s*s] in PixelShuffle channel
    order.  Returns [B, H*s, W*s, C], or [..., c_final] f32 with a head."""
    p = pack_weights(w, b, stride, compute_dtype, head_w=head_w, head_b=head_b)
    return decode_stage(x.to(compute_dtype).contiguous(), p, act, out_squash or "tanh")


def fused_conv_ps_act_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    act: str = "swish",
    *,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
    out_squash: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The plain version of ``fused_conv_ps_act``, on any device."""
    p = pack_weights(w, b, stride, compute_dtype, head_w=head_w, head_b=head_b)
    return decode_stage_reference(x, p, act, out_squash or "tanh")
