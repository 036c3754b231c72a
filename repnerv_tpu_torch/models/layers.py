"""Primitive layers (port of ``repnerv_tpu/models/layers.py``): activations,
eval-mode norms, the MLP stem, pixel shuffle, conv and initializers.

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

import math
from typing import Optional, Sequence

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
# Norms, eval mode, NHWC
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the channel (last) axis, with the
    reference's parameter names and no ``num_batches_tracked`` buffer (the
    checkpoint bridge writes none)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias


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


# ---------------------------------------------------------------------------
# Conv (NHWC x OIHW), stride 1, zero padding
# ---------------------------------------------------------------------------


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the input cast of compute_dtype "mixed"
    (bf16 operands, f32 accumulation and result)."""
    return t.to(torch.bfloat16).to(torch.float32)


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
    the output dtype, the JAX package's cast point."""
    if mixed:
        x, w = bf16_round(x), bf16_round(w)
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
        w = self.weight
        if mixed:
            x, w = bf16_round(x), bf16_round(w)
        elif dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
        x = x @ w.t()
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)
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
