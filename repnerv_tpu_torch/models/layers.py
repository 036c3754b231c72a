"""Primitive layers (port of ``repnerv_tpu/models/layers.py``): activations,
norms, the MLP stem, pixel shuffle, conv and initializers.

Conventions:

* Activations are NHWC tensors at every public function, as in the JAX
  package.  A conv views them as channels-last NCHW (a permute, no copy).
* Conv weights are OIHW and linear weights [out, in]: the reference's
  PyTorch layouts, so ``state_dict()`` keys and shapes equal what
  ``repnerv_tpu.train.checkpoint.params_to_torch_state`` writes.
* Initialization draws from an explicit ``torch.Generator`` on the CPU and
  then moves to the target device, so a seed gives the same weights on any
  device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Activations (all 9 of repnerv_tpu.config.ACT_TYPES)
# ---------------------------------------------------------------------------


def activation(x: torch.Tensor, act_type: str) -> torch.Tensor:
    if act_type == "relu":
        return F.relu(x)
    if act_type == "leaky":
        return F.leaky_relu(x, 0.01)
    if act_type == "leaky01":
        return F.leaky_relu(x, 0.1)
    if act_type == "relu6":
        return F.relu6(x)
    if act_type == "gelu":
        return F.gelu(x)  # exact erf form, as torch nn.GELU() and the reference
    if act_type == "sin":
        return torch.sin(x)
    if act_type == "swish":
        return F.silu(x)
    if act_type == "softplus":
        # jax.nn.softplus = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
        # unthresholded; torch's F.softplus returns x itself above 20
        return F.relu(x) + torch.log1p(torch.exp(-x.abs()))
    if act_type == "hardswish":
        return x * F.relu6(x + 3.0) / 6.0  # jax.nn.hard_swish's operation order
    raise KeyError(f"Unknown activation function {act_type}.")


class Activation(nn.Module):
    def __init__(self, act_type: str):
        super().__init__()
        self.act_type = act_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation(x, self.act_type)


# ---------------------------------------------------------------------------
# Norms, NHWC
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Batch norm over the channel (last) axis, with the reference's
    parameter names and no ``num_batches_tracked`` buffer (the checkpoint
    bridge writes none).  In training mode it normalizes with the batch
    statistics and never updates the running ones, as the JAX package's
    ``apply_norm(train=True)`` does (unlike ``nn.BatchNorm2d``); in eval
    mode it uses the running statistics."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self.weight, self.bias, self.eps)
        mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def batch_norm_train(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, group=None
) -> torch.Tensor:
    """Training-mode batch norm of NHWC ``x`` over (B, H, W) with the given
    affine parameters.  With a ``group`` of data ranks, the statistics are
    the global batch's, as JAX's ``jnp.mean`` / ``jnp.var`` over a batch axis
    that GSPMD shards: the mean from the all-reduced per-channel sums and
    counts, then the variance as the all-reduced sum of ``(x - mean)^2``
    over the count (two passes: ``E[x^2] - E[x]^2`` cancels).  Both
    all-reduces are differentiable, their backward the sum of the ranks'
    cotangents."""
    if group is None:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
    else:
        from ..parallel.collectives import all_reduce

        n = x.new_full((1,), float(x.shape[0] * x.shape[1] * x.shape[2]))
        sums = all_reduce(torch.cat([x.sum(dim=(0, 1, 2)), n]), group, grad_sum=True)
        count = sums[-1].detach()
        mean = sums[:-1] / count
        var = all_reduce(((x - mean) ** 2).sum(dim=(0, 1, 2)), group, grad_sum=True) / count
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class InstanceNorm(nn.Module):
    """Instance norm over H, W of an NHWC tensor (torch default affine=False)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps)


def make_norm(norm_type: str, ch: int) -> nn.Module:
    if norm_type == "none":
        return nn.Identity()
    if norm_type == "bn":
        return BatchNorm(ch)
    if norm_type == "in":
        return InstanceNorm()
    raise NotImplementedError(norm_type)


# ---------------------------------------------------------------------------
# Pixel shuffle, NHWC, torch channel order:
# out[b, h*s+i, w*s+j, c] = in[b, h, w, c*s*s + i*s + j]
# ---------------------------------------------------------------------------


def pixel_shuffle(x: torch.Tensor, stride: int) -> torch.Tensor:
    if stride == 1:
        return x
    b, h, w, c = x.shape
    cc = c // (stride * stride)
    x = x.reshape(b, h, w, cc, stride, stride)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, si, w, sj, cc
    return x.reshape(b, h * stride, w * stride, cc)


def pixel_unshuffle(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The inverse of ``pixel_shuffle``: [b, h*s, w*s, cc] -> [b, h, w, cc*s*s]."""
    if stride == 1:
        return x
    b, hs, ws, cc = x.shape
    h, w = hs // stride, ws // stride
    x = x.reshape(b, h, stride, w, stride, cc)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, cc * stride * stride)


# ---------------------------------------------------------------------------
# Conv (NHWC x OIHW), stride 1, zero padding
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Full-f32 cuDNN convs and matmuls (no TF32) for the duration."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the operand cast of compute_dtype "mixed"
    (bf16 operands, f32 accumulation and result)."""
    return t.to(torch.bfloat16).to(torch.float32)


# compute_dtype "mixed": the custom VJPs of repnerv_tpu/models/layers.py
# (mxu_conv2d_f32, mxu_matmul_f32).  The forward, dX and dW all multiply
# operands rounded to bf16 -- x, w and the cotangent -- and sum in f32; the
# residuals are the bf16 casts.  A product of two bf16 numbers is exact in
# f32, so the library's f32 conv / matmul with TF32 off differs from the JAX
# package's bf16 x bf16 -> f32 ops only in the order of the sums.


class _MixedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        pad = [w.shape[2] // 2, w.shape[3] // 2]
        ctx.pad = pad
        with exact_f32():
            out = F.conv2d(xb.float().permute(0, 3, 1, 2), wb.float(), padding=pad)
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, ct):
        xb, wb = ctx.saved_tensors
        with exact_f32():
            d_x, d_w, _ = torch.ops.aten.convolution_backward(
                bf16_round(ct).permute(0, 3, 1, 2), xb.float().permute(0, 3, 1, 2), wb.float(),
                None, [1, 1], ctx.pad, [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return (d_x.permute(0, 2, 3, 1) if d_x is not None else None), d_w


def mxu_conv2d_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC f32 ``x`` with an odd OIHW f32 kernel ``w``
    on bf16-rounded operands, f32 result; its backward rounds the cotangent
    to bf16 before dX and dW."""
    return _MixedConv.apply(x, w)


class _MixedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        with exact_f32():
            return xb.float() @ wb.float().t()

    @staticmethod
    def backward(ctx, ct):
        xb, wb = ctx.saved_tensors
        ctb = bf16_round(ct)
        with exact_f32():
            d_x = ctb @ wb.float() if ctx.needs_input_grad[0] else None
            d_w = ctb.t() @ xb.float() if ctx.needs_input_grad[1] else None
        return d_x, d_w


def mxu_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [B, in] @ w[out, in].T`` on bf16-rounded operands, f32 result; its
    backward rounds the cotangent to bf16 before dX and dW."""
    return _MixedMatmul.apply(x, w)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    padding: str = "same",
    groups: int = 1,
    mixed: bool = False,
) -> torch.Tensor:
    """NHWC conv with an OIHW kernel.  The bias is added after the conv in
    the output dtype, the JAX package's cast point.  ``mixed`` takes
    ``mxu_conv2d_f32`` where the JAX package does: SAME, ungrouped, odd
    kernels; other convs run as they are."""
    if mixed and padding == "same" and groups == 1 and w.shape[2] % 2 and w.shape[3] % 2:
        out = mxu_conv2d_f32(x, w)
        return out + b.to(out.dtype) if b is not None else out
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype), None, padding=padding, groups=groups
    ).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Parameter containers and torch-default initialization:
# kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for the
# weight, the same bound for the bias.
# ---------------------------------------------------------------------------


def torch_uniform(
    shape: Sequence[int], fan_in: int, generator: torch.Generator
) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


class ConvWeights(nn.Module):
    """An OIHW conv weight and optional bias, named ``weight``/``bias`` as on
    ``nn.Conv2d``.  A container: callers run the conv through ``conv2d``."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None

    @classmethod
    def uniform(
        cls,
        cin: int,
        cout: int,
        kh: int,
        kw: int,
        *,
        bias: bool = True,
        generator: torch.Generator,
    ) -> "ConvWeights":
        fan_in = cin * kh * kw
        w = torch_uniform((cout, cin, kh, kw), fan_in, generator)
        return cls(w, torch_uniform((cout,), fan_in, generator) if bias else None)


class Linear(nn.Module):
    """[out, in] linear layer that runs in a given compute dtype."""

    def __init__(self, din: int, dout: int, *, bias: bool = True, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch_uniform((dout, din), din, generator))
        self.bias = nn.Parameter(torch_uniform((dout,), din, generator)) if bias else None

    def forward(
        self, x: torch.Tensor, dtype: Optional[torch.dtype] = None, mixed: bool = False
    ) -> torch.Tensor:
        return linear(x, self.weight, self.bias, dtype, mixed)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    dtype: Optional[torch.dtype] = None,
    mixed: bool = False,
) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` [out, in], in ``dtype`` (or "mixed": f32
    accumulation of bf16 products)."""
    if mixed:
        x = mxu_matmul_f32(x, w)
    else:
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
        x = x @ w.t()
    if b is not None:
        x = x + b.to(x.dtype)
    return x


class MLP(nn.Module):
    """The stem: [Linear, act] per layer, children named "0", "1", ... as in
    the reference's nn.Sequential, so the state keys are ``stem.{2i}.*``."""

    def __init__(
        self, dims: Sequence[int], act: str, *, bias: bool = True, generator: torch.Generator
    ):
        super().__init__()
        self.act = act
        for i in range(len(dims) - 1):
            self.add_module(
                str(2 * i), Linear(dims[i], dims[i + 1], bias=bias, generator=generator)
            )
            self.add_module(str(2 * i + 1), Activation(act))

    def forward(
        self, x: torch.Tensor, dtype: Optional[torch.dtype] = None, mixed: bool = False
    ) -> torch.Tensor:
        for module in self.children():
            if isinstance(module, Linear):
                x = module(x, dtype, mixed)
            else:
                x = module(x)
        return x
