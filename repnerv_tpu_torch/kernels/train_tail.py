"""Fused training stage: act(pixel_shuffle(conv3x3(x) + b)) [-> 1x1 head ->
squash] with its backward, the port of
``repnerv_tpu/pallas_kernels/train_tail.py``.

Two kernels, each behind a wrapper that launches it on a CUDA tensor and
runs its plain PyTorch version on a CPU tensor:

* ``stage_forward`` (K3): the decode kernel that ``stage_route`` names
  (``csrc/decode_wgmma.cu`` for bf16 and ``csrc/decode_wgmma_tf32.cu`` for
  f32 where the channel counts allow it, else ``csrc/decode.cu``) with one
  more store, the pre-activation ``z`` [B, H*s, W*s, C] in the compute dtype
  (the JAX kernel's z5 [B, H, s, W, s*C] is the same bytes).
* ``epilogue_backward`` (K4, ``csrc/train_tail.cu``): from ``z``, the
  cotangent and (with a head) the squashed output to ``d_conv`` [B, H, W,
  s*s*C] in shuffle-major column order, plus the finished bias gradient (in
  the model's channel order) and head gradients: the kernel ends its sums
  itself, in a fixed order.

``fused_stage_train`` is a ``torch.autograd.Function`` with the JAX custom
VJP's contract: the conv dX/dW after K4 stay on the library conv
(one ``aten::convolution_backward``, cuDNN on the card), in the compute
dtype, with TF32 off in f32, on the forward's packed weight; the weight
gradient comes back from shuffle-major order by one gather with the inverse
of ``shuffle_weight_permutation``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..models.layers import activation
from .build import load_library
from .decode import (
    ACT_CODES,
    PackedStage,
    ROUTES,
    _DTYPE_CODES,
    _INT32_MAX,
    check_stage_args,
    exact_f32,
    launch_stage_kernel,
    pack_weights,
    shuffle_permutations,
    stage_reference,
)

# kernel launches since the counts were last set to 0 (chip_smoke.py reads them)
FWD_LAUNCHES = 0
FWD_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)  # K3's launches by kernels.decode.stage_route
BWD_LAUNCHES = 0

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def activation_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz of ``models.layers.activation``, with the JAX package's
    values at the kinks (``jax.vjp``): relu 0 at 0, leaky 1 at 0, relu6 0 at
    0 and 6, hardswish 0 at -3 and 1 at 3."""
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    if act == "relu":
        return torch.where(z > 0, one, zero)
    if act in ("leaky", "leaky01"):
        return torch.where(z >= 0, one, torch.full_like(z, 0.01 if act == "leaky" else 0.1))
    if act == "relu6":
        return torch.where((z > 0) & (z < 6), one, zero)
    if act == "gelu":
        return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * torch.exp(
            -0.5 * z * z
        ) * 0.3989422804014327
    if act == "sin":
        return torch.cos(z)
    if act == "swish":
        sg = torch.sigmoid(z)
        return sg * (1.0 + z * (1.0 - sg))
    if act == "softplus":
        return torch.sigmoid(z)
    if act == "hardswish":
        r = torch.clamp(z + 3.0, 0.0, 6.0)
        return (r + z * torch.where((z + 3.0 > 0) & (z + 3.0 < 6), one, zero)) / 6.0
    raise KeyError(f"Unknown activation function {act}.")


def _f32_ctx(dtype: torch.dtype):
    return exact_f32() if dtype == torch.float32 else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# K3: forward with the pre-activation store
# ---------------------------------------------------------------------------


def stage_forward_reference(
    x: torch.Tensor, p: PackedStage, act: str, squash: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, with the kernel's cast points (those of
    ``decode.stage_reference``), z rounded to the compute dtype; the
    activation and head take the unrounded value.  Returns (out, z)."""
    out, pre = stage_reference(x, p, act, squash)
    return out, pre.to(p.w.dtype)


def stage_forward(
    x: torch.Tensor, p: PackedStage, act: str, squash: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on a CUDA tensor; run the plain version on a CPU one.
    Returns (out, z)."""
    global FWD_LAUNCHES
    if x.device.type == "cpu":
        return stage_forward_reference(x, p, act, squash)
    if x.device.type != "cuda":
        raise ValueError(f"stage_forward runs on cuda or cpu tensors, not {x.device}")
    bsz, h, w, _ = x.shape
    c_final = check_stage_args("stage_forward", x, p, act, squash)
    s, c = p.stride, p.c
    out_dtype = torch.float32 if c_final else x.dtype
    out = torch.empty(bsz, h * s, w * s, c_final or c, device=x.device, dtype=out_dtype)
    z = torch.empty(bsz, h * s, w * s, c, device=x.device, dtype=x.dtype)
    if z.numel() == 0:
        return out, z
    route = launch_stage_kernel(x, p, act, squash, out, z)
    FWD_LAUNCHES += 1
    FWD_ROUTE_LAUNCHES[route] += 1
    return out, z


# ---------------------------------------------------------------------------
# K4: epilogue backward
# ---------------------------------------------------------------------------

Grads = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def epilogue_backward_reference(
    z: torch.Tensor,
    ct: torch.Tensor,
    out: Optional[torch.Tensor],
    head_w: Optional[torch.Tensor],
    stride: int,
    act: str,
    squash: str,
) -> Grads:
    """The plain version.  z [B, H*s, W*s, C] (compute dtype); ct the
    cotangent of the stage output (f32 [.., c_final] with a head, else the
    compute dtype [.., C]); out the squashed f32 output (head); head_w f32
    [C, c_final].  Returns (d_conv [B, H, W, s*s*C] in the compute dtype and
    shuffle-major column order, d_b [s*s*C] f32 in PixelShuffle channel
    order (the order of the model's bias), d_hw [C,
    c_final] f32 | None, d_hb [c_final] f32 | None), with the JAX kernel's
    cast points: d_h and the head weight rounded to the compute dtype for
    d_a, act(z) from the rounded z, the bias gradient from the f32 d_z."""
    cd = z.dtype
    bsz, hs, ws, c = z.shape
    s = stride
    h, w = hs // s, ws // s
    zf = z.float()
    with exact_f32():
        if head_w is not None:
            o = out.float()
            g = ct.float()
            if squash == "sigmoid":
                d_h = g * o * (1.0 - o)
            else:
                u = 2.0 * o - 1.0
                d_h = g * 0.5 * (1.0 - u * u)
            a = activation(zf, act)
            d_hw = torch.einsum("bhwc,bhwo->co", a, d_h)
            d_hb = d_h.sum(dim=(0, 1, 2))
            d_a = torch.matmul(d_h.to(cd).float(), head_w.to(cd).float().t())
        else:
            d_a, d_hw, d_hb = ct.float(), None, None
    d_z = d_a * activation_grad(zf, act)
    # [B, H, s, W, s, C] -> [B, H, W, (i*s + j)*C + c]
    d_conv = d_z.reshape(bsz, h, s, w, s, c).permute(0, 1, 3, 2, 4, 5).reshape(bsz, h, w, s * s * c)
    # the bias gradient: column (i*s + j)*C + c -> PixelShuffle channel c*s*s + i*s + j
    d_b = d_conv.sum(dim=(0, 1, 2)).reshape(s * s, c).t().reshape(-1)
    return d_conv.to(cd), d_b, d_hw, d_hb


# device -> the 64 int32 tickets K4's blocks draw from: 0 between launches
# (the blocks that add the sums set them back), shared by the launches of one
# stream
_TICKETS: Dict[torch.device, torch.Tensor] = {}
# (device, (dtype code, B, H, W, C, s, c_final)) -> the f32 values of workspace K4 needs
_WORKSPACES: Dict[tuple, int] = {}


def epilogue_backward(
    z: torch.Tensor,
    ct: torch.Tensor,
    out: Optional[torch.Tensor],
    head_w: Optional[torch.Tensor],
    stride: int,
    act: str,
    squash: str,
) -> Grads:
    """Launch K4 on a CUDA tensor (the kernel ends its own sums: no torch
    reduction follows); run the plain version on a CPU one."""
    global BWD_LAUNCHES
    if z.device.type == "cpu":
        return epilogue_backward_reference(z, ct, out, head_w, stride, act, squash)
    if z.device.type != "cuda":
        raise ValueError(f"epilogue_backward runs on cuda or cpu tensors, not {z.device}")
    bsz, hs, ws, c = z.shape
    s = stride
    c_final = 0 if head_w is None else head_w.shape[1]
    if z.dtype not in _DTYPE_CODES or hs % s or ws % s or s not in (1, 2, 3, 4, 5):
        raise ValueError(f"epilogue_backward: z {tuple(z.shape)} {z.dtype}, stride {s}")
    if act not in ACT_CODES or squash not in ("tanh", "sigmoid") or not 0 <= c_final <= 16:
        raise ValueError(f"epilogue_backward: act {act!r}, squash {squash!r}, head {c_final}")
    if c_final:
        tensors = [z, ct, out, head_w]
        want = [(z.shape, z.dtype), ((bsz, hs, ws, c_final), torch.float32),
                ((bsz, hs, ws, c_final), torch.float32), ((c, c_final), torch.float32)]
    else:
        tensors = [z, ct]
        want = [(z.shape, z.dtype), (z.shape, z.dtype)]
    for t, (shape, dtype) in zip(tensors, want):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != z.device:
            raise ValueError(
                f"epilogue_backward: got {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"want {tuple(shape)} {dtype} on {z.device}"
            )
        if not t.is_contiguous():
            raise ValueError("epilogue_backward: the inputs must be contiguous")
    if not 0 < z.numel() <= _INT32_MAX:
        raise ValueError("epilogue_backward: z must hold 1 to 2**31 - 1 elements")
    h, w = hs // s, ws // s
    cout = s * s * c
    dev = z.device
    lib = load_library()
    code = _DTYPE_CODES[z.dtype]
    key = (code, bsz, h, w, c, s, c_final)
    if (dev, key) not in _WORKSPACES:  # asked of the library once per problem and card
        with torch.cuda.device(dev):
            _WORKSPACES[dev, key] = lib.repnerv_train_stage_bwd_workspace(*key)
    n_work = _WORKSPACES[dev, key]
    if n_work < 0:
        raise ValueError(f"epilogue_backward: the kernel does not take z {tuple(z.shape)}")
    d_conv = torch.empty(bsz, h, w, cout, device=dev, dtype=z.dtype)
    d_b = torch.empty(cout, device=dev, dtype=torch.float32)
    d_hw = torch.empty(c, c_final, device=dev, dtype=torch.float32) if c_final else None
    d_hb = torch.empty(c_final, device=dev, dtype=torch.float32) if c_final else None
    work = torch.empty(n_work, device=dev, dtype=torch.float32)
    if dev not in _TICKETS:
        _TICKETS[dev] = torch.zeros(64, device=dev, dtype=torch.int32)
    ptr = ctypes.c_void_p

    def addr(t):
        return ptr(t.data_ptr() if t is not None else None)

    with torch.cuda.device(dev):
        err = lib.repnerv_train_stage_bwd(
            code,
            addr(z),
            addr(None if c_final else ct),
            addr(ct if c_final else None),
            addr(out if c_final else None),
            addr(head_w),
            addr(d_conv),
            addr(d_b),
            addr(d_hw),
            addr(d_hb),
            addr(work),
            addr(_TICKETS[dev]),
            bsz, h, w, c, s,
            ACT_CODES[act],
            c_final,
            int(squash == "sigmoid"),
            ptr(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"train stage backward kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    return d_conv, d_b, d_hw, d_hb


# ---------------------------------------------------------------------------
# The differentiable stage
# ---------------------------------------------------------------------------


def packed_weight_oihw(p: PackedStage) -> torch.Tensor:
    """The packed conv weight [9*Cin, Cout] as an OIHW view [Cout, Cin, 3, 3]
    (shuffle-major O, compute dtype) for the library's dX / dW.  No kernel runs."""
    return p.w.reshape(3, 3, p.cin, p.w.shape[1]).permute(3, 2, 0, 1)


class _FusedStageTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, head_w, head_b, stride, act, squash, cdt_name):
        cd = DTYPES[cdt_name]
        p = pack_weights(
            w.detach(), b.detach(), stride, cd,
            head_w=head_w.detach() if head_w is not None else None,
            head_b=head_b.detach() if head_b is not None else None,
        )
        xc = x.detach().to(cd).contiguous()  # x itself when it has the type and layout
        out, z = stage_forward(xc, p, act, squash)
        with_head = head_w is not None
        # the backward's conv weight is the forward's packed one: no second gather and cast
        ctx.save_for_backward(xc, z, out if with_head else None, packed_weight_oihw(p))
        ctx.cfg = (stride, act, squash, cd, p.head_w, with_head, x.dtype, w.dtype)
        return out

    @staticmethod
    def backward(ctx, ct):
        xc, z, out, w2 = ctx.saved_tensors
        stride, act, squash, cd, hw2, with_head, x_dtype, w_dtype = ctx.cfg
        ct = ct.to(torch.float32 if with_head else cd).contiguous()
        d_conv, d_b, d_hw, d_hb = epilogue_backward(
            z, ct, out, hw2 if with_head else None, stride, act, squash
        )
        x_nchw = xc.permute(0, 3, 1, 2)
        d_nchw = d_conv.permute(0, 3, 1, 2)
        # dX and dW in one library call on the tensors as they lie (NHWC memory
        # seen as channels_last NCHW: cuDNN copies nothing).  torch.nn.grad's
        # conv2d_input / conv2d_weight stand in a made-up operand for the one
        # they do not read, which the backend first copies out at full size:
        # on an H100 2.416 ms for the pair against 0.685 ms for this call at
        # the 720p stage in bf16.
        with _f32_ctx(cd):
            d_x, d_w2, _ = torch.ops.aten.convolution_backward(
                d_nchw, x_nchw, w2, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, False],
            )
        # w2 = w[..., perm]  =>  d_w = d_w2[inverse of perm]: one gather
        _, inv = shuffle_permutations(w2.shape[0], stride, w2.device)
        d_w = d_w2.index_select(0, inv)
        return (
            d_x.permute(0, 2, 3, 1).to(x_dtype),
            d_w.permute(2, 3, 1, 0).to(w_dtype),
            d_b,
            d_hw.reshape(1, 1, *d_hw.shape) if with_head else None,
            d_hb if with_head else None,
            None, None, None, None,
        )


def fused_stage_train(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    head_w: Optional[torch.Tensor],
    head_b: Optional[torch.Tensor],
    stride: int,
    act: str,
    squash: str,
    cdt_name: str,
) -> torch.Tensor:
    """act(pixel_shuffle(conv3x3(x) + b)) [-> 1x1 head -> squash], trainable
    in x, w, b (and head_w, head_b when present).  x NHWC; w HWIO [3, 3, Cin,
    C*s*s] in PixelShuffle channel order; head_w HWIO [1, 1, C, c_final].
    Returns [B, H*s, W*s, C] in the compute dtype ``cdt_name``, or [...,
    c_final] f32 with a head."""
    return _FusedStageTrain.apply(x, w, b, head_w, head_b, stride, act, squash, cdt_name)
