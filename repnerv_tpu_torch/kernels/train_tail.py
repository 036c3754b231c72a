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
  s*s*C] in shuffle-major column order, plus the bias and head gradients.

``fused_stage_train`` is a ``torch.autograd.Function`` with the JAX custom
VJP's contract: the conv dX/dW after K4 stay on the library conv
(``torch.nn.grad``, cuDNN on the card), in the compute dtype, with TF32 off
in f32; the weight and bias gradients scatter back from shuffle-major order
through ``shuffle_weight_permutation``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

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
    shuffle_weight_permutation,
    stage_reference,
)

# kernel launches since the counts were last set to 0 (chip_smoke.py reads them)
FWD_LAUNCHES = 0
FWD_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)  # K3's launches by kernels.decode.stage_route
BWD_LAUNCHES = 0

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BWD_MAX_TILE = 64  # low-res pixels per block of the backward kernel


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
    shuffle-major column order, d_b [s*s*C] f32 in that order, d_hw [C,
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
    return d_conv.to(cd), d_conv.sum(dim=(0, 1, 2)), d_hw, d_hb


def _bwd_tile(m: int, s: int, c: int, c_final: int) -> int:
    """Low-res pixels per backward block: enough blocks to fill the card
    (~8 per SM of 132), at most 64 pixels, and shared memory under 48 KB."""
    tile = max(1, min(_BWD_MAX_TILE, m // (132 * 8)))
    while tile > 1 and (tile * s * s * c_final + c * c_final + s * s * c * c_final) * 4 > 48 * 1024:
        tile //= 2
    return tile


def epilogue_backward(
    z: torch.Tensor,
    ct: torch.Tensor,
    out: Optional[torch.Tensor],
    head_w: Optional[torch.Tensor],
    stride: int,
    act: str,
    squash: str,
) -> Grads:
    """Launch K4 on a CUDA tensor and sum its per-block partials; run the
    plain version on a CPU one."""
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
    m = bsz * h * w
    tile = _bwd_tile(m, s, c, c_final)
    n_blocks = -(-m // tile)
    dev = z.device
    d_conv = torch.empty(bsz, h, w, cout, device=dev, dtype=z.dtype)
    db_part = torch.empty(n_blocks, cout, device=dev, dtype=torch.float32)
    dhw_part = torch.empty(n_blocks, c, c_final, device=dev) if c_final else None
    dhb_part = torch.empty(n_blocks, c_final, device=dev) if c_final else None
    lib = load_library()
    ptr = ctypes.c_void_p

    def addr(t):
        return ptr(t.data_ptr() if t is not None else None)

    with torch.cuda.device(dev):
        err = lib.repnerv_train_stage_bwd(
            _DTYPE_CODES[z.dtype],
            addr(z),
            addr(None if c_final else ct),
            addr(ct if c_final else None),
            addr(out if c_final else None),
            addr(head_w),
            addr(d_conv),
            addr(db_part),
            addr(dhw_part),
            addr(dhb_part),
            bsz, h, w, c, s,
            ACT_CODES[act],
            c_final,
            int(squash == "sigmoid"),
            tile,
            ptr(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"train stage backward kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    return (
        d_conv,
        db_part.sum(dim=0),
        dhw_part.sum(dim=0) if c_final else None,
        dhb_part.sum(dim=0) if c_final else None,
    )


# ---------------------------------------------------------------------------
# The differentiable stage
# ---------------------------------------------------------------------------


class _FusedStageTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, head_w, head_b, stride, act, squash, cdt_name):
        cd = DTYPES[cdt_name]
        p = pack_weights(
            w.detach(), b.detach(), stride, cd,
            head_w=head_w.detach() if head_w is not None else None,
            head_b=head_b.detach() if head_b is not None else None,
        )
        out, z = stage_forward(x.detach().to(cd).contiguous(), p, act, squash)
        ctx.save_for_backward(x, w, z, out if head_w is not None else None)
        ctx.cfg = (stride, act, squash, cd, p.head_w, head_w is not None)
        return out

    @staticmethod
    def backward(ctx, ct):
        x, w, z, out = ctx.saved_tensors
        stride, act, squash, cd, hw2, with_head = ctx.cfg
        ct = ct.to(torch.float32 if with_head else cd).contiguous()
        d_conv, d_b2, d_hw, d_hb = epilogue_backward(
            z, ct, out, hw2 if with_head else None, stride, act, squash
        )
        cout = w.shape[-1]
        perm = shuffle_weight_permutation(cout, stride, w.device)
        w2 = w.detach()[..., perm].permute(3, 2, 0, 1).to(cd)  # OIHW, shuffle-major O
        x_nchw = x.detach().to(cd).permute(0, 3, 1, 2)
        d_nchw = d_conv.permute(0, 3, 1, 2)
        with _f32_ctx(cd):
            d_x = torch.nn.grad.conv2d_input(x_nchw.shape, w2, d_nchw, padding=1)
            d_w2 = torch.nn.grad.conv2d_weight(x_nchw, w2.shape, d_nchw, padding=1)
        # w2 = w[..., perm]  =>  d_w[..., perm] = d_w2
        d_w = torch.empty_like(d_w2)
        d_w[perm] = d_w2
        d_b = torch.empty_like(d_b2)
        d_b[perm] = d_b2
        return (
            d_x.permute(0, 2, 3, 1).to(x.dtype),
            d_w.permute(2, 3, 1, 0).to(w.dtype),
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
