"""NeRVBlock — conv -> PixelShuffle -> norm -> act (port of
``repnerv_tpu/models/blocks.py``).

``out_channels = new_ngf * stride**2`` feeds a PixelShuffle(stride), so one
stride-1 conv performs the upsampling.  The block holds its branch weights
under the reference model's attribute names.  ``forward`` runs the
online-fused path by default: fuse the branches into one 3x3 kernel (autograd
differentiates through the fusion algebra), run one conv; with
``online_fuse=False`` it runs the branch-sum graph of the reference
(``apply_branches_direct``).  Deploy replaces the branches with a single
``rbr_reparam`` conv (``block_to_deploy``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from . import reparam
from .layers import ConvWeights, activation, conv2d, make_norm, pixel_shuffle

# every branch attribute a block may hold (all but ``rbr_reparam``)
BRANCH_ATTRS = (
    "branch",
    "rbr_3x3_branch",
    "rbr_3x1_branch",
    "rbr_1x3_branch",
    "rbr_1x1_branch",
    "rbr_1x1_3x3_1x1_branch_1x1_1",
    "rbr_1x1_3x3_1x1_branch_3x3",
    "rbr_1x1_3x3_1x1_branch_1x1_2",
    "rbr_1x1_3x3_branch_1x1",
    "rbr_1x1_3x3_branch_3x3",
    "rbr_1x1_avg_branch_1x1",
    "rbr_conv1x1_sbx_branch",
    "rbr_conv1x1_sby_branch",
    "rbr_conv1x1_lpl_branch",
)


class SeqConvWeights(nn.Module):
    """SeqConv3x3 edge-branch params (reference names): 1x1 conv ``k0``/``b0``
    (torch default init) and ``scale``/``bias`` drawn as randn * 1e-3."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        conv = ConvWeights.uniform(cin, cout, 1, 1, generator=generator)
        self.k0 = conv.weight
        self.b0 = conv.bias
        self.scale = nn.Parameter(torch.randn(cout, 1, 1, 1, generator=generator) * 1e-3)
        self.bias = nn.Parameter(torch.randn(cout, generator=generator) * 1e-3)


class NeRVBlock(nn.Module):
    def __init__(
        self,
        *,
        ngf: int,
        new_ngf: int,
        stride: int,
        branch_type: str = "NeRV_vanilla",
        norm: str = "none",
        act: str = "swish",
        bias: bool = True,
        deploy: bool = False,
        generator: torch.Generator,
    ):
        super().__init__()
        self.stride = stride
        self.branch_type = branch_type
        self.norm_type = norm
        self.act = act
        cout = new_ngf * stride * stride
        g = generator

        def conv(cin, co, kh, kw, b=True):
            return ConvWeights.uniform(cin, co, kh, kw, bias=b, generator=g)

        self.norm = make_norm(norm, new_ngf)
        self.rbr_reparam: Optional[ConvWeights] = None
        if deploy:
            self.rbr_reparam = conv(ngf, cout, 3, 3)
            return
        if branch_type == "NeRV_vanilla":
            self.branch = conv(ngf, cout, 3, 3, bias)
        elif branch_type in ("ERB", "ACB"):
            self.rbr_3x3_branch = conv(ngf, cout, 3, 3)
            self.rbr_3x1_branch = conv(ngf, cout, 3, 1)
            self.rbr_1x3_branch = conv(ngf, cout, 1, 3)
            if branch_type == "ERB":
                self.rbr_1x1_3x3_1x1_branch_1x1_1 = conv(ngf, 2 * ngf, 1, 1, False)
                self.rbr_1x1_3x3_1x1_branch_3x3 = conv(2 * ngf, cout, 3, 3, False)
                self.rbr_1x1_3x3_1x1_branch_1x1_2 = conv(cout, cout, 1, 1, False)
        elif branch_type == "RepVGG":
            self.rbr_3x3_branch = conv(ngf, cout, 3, 3)
            self.rbr_1x1_branch = conv(ngf, cout, 1, 1)
        elif branch_type == "DBB":
            self.rbr_3x3_branch = conv(ngf, cout, 3, 3)
            self.rbr_1x1_branch = conv(ngf, cout, 1, 1)
            self.rbr_1x1_3x3_branch_1x1 = conv(ngf, 2 * ngf, 1, 1, False)
            self.rbr_1x1_3x3_branch_3x3 = conv(2 * ngf, cout, 3, 3, False)
            self.rbr_1x1_avg_branch_1x1 = conv(ngf, cout, 1, 1, False)
        elif branch_type == "ECB":
            self.rbr_3x3_branch = conv(ngf, cout, 3, 3)
            self.rbr_1x1_3x3_branch_1x1 = conv(ngf, 2 * ngf, 1, 1, False)
            self.rbr_1x1_3x3_branch_3x3 = conv(2 * ngf, cout, 3, 3, False)
            for name in reparam.EDGE_MASKS:
                setattr(self, name, SeqConvWeights(ngf, cout, g))
        else:
            raise KeyError(f"unknown branch_type {branch_type}")

    def forward(
        self, x: torch.Tensor, mixed: bool = False, online_fuse: bool = True
    ) -> torch.Tensor:
        """NHWC forward: conv (fused, or the branch sum), pixel shuffle, norm,
        act, as the JAX ``apply_block``."""
        if self.rbr_reparam is not None or online_fuse:
            with span("reparam.fuse"):
                k, b = reparam.fuse(self.branch_type, self)
            out = conv2d(x, k, b, mixed=mixed)
        else:
            out = apply_branches_direct(self, x)
        out = pixel_shuffle(out, self.stride)
        return activation(self.norm(out), self.act)


def _seqconv_apply(p: SeqConvWeights, x: torch.Tensor, mask: tuple) -> torch.Tensor:
    """The literal SeqConv3x3 forward: 1x1 conv, a one-pixel border filled
    with the 1x1 bias, then the depthwise mask conv."""
    y = conv2d(x, p.k0, p.b0, padding="valid")
    y = F.pad(y, (0, 0, 1, 1, 1, 1))
    border = torch.ones(y.shape[1], y.shape[2], 1, dtype=torch.bool, device=y.device)
    border[1:-1, 1:-1] = False
    y = torch.where(border, p.b0.to(y.dtype), y)
    m = reparam.edge_mask(mask, p.scale.dtype, p.scale.device)
    cout = p.scale.shape[0]
    w = (m[None] * p.scale[:, 0]).reshape(cout, 1, 3, 3)
    return conv2d(y, w, p.bias, padding="valid", groups=cout)


def _avgpool3x3(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride 1, padding 1) with count_include_pad, NHWC."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1, count_include_pad=True)
    return out.permute(0, 2, 3, 1)


def apply_branches_direct(blk: NeRVBlock, x: torch.Tensor) -> torch.Tensor:
    """The branch-by-branch conv output of the reference model (before pixel
    shuffle), for every branch type."""
    bt = blk.branch_type

    def conv(m, inp, w=None):
        return conv2d(inp, m.weight if w is None else w, m.bias)

    if bt == "NeRV_vanilla":
        return conv(blk.branch, x)
    if bt in ("ERB", "ACB"):
        out = (
            conv(blk.rbr_3x3_branch, x)
            + conv(blk.rbr_3x1_branch, x, reparam.pad_3x1_to_3x3(blk.rbr_3x1_branch.weight))
            + conv(blk.rbr_1x3_branch, x, reparam.pad_1x3_to_3x3(blk.rbr_1x3_branch.weight))
        )
        if bt == "ERB":
            h = conv(blk.rbr_1x1_3x3_1x1_branch_1x1_1, x)
            h = conv(blk.rbr_1x1_3x3_1x1_branch_3x3, h)
            h = conv(blk.rbr_1x1_3x3_1x1_branch_1x1_2, h)
            out = out + h
        return out
    if bt == "RepVGG":
        return conv(blk.rbr_3x3_branch, x) + conv(blk.rbr_1x1_branch, x)
    if bt == "DBB":
        seq = conv(blk.rbr_1x1_3x3_branch_3x3, conv(blk.rbr_1x1_3x3_branch_1x1, x))
        avg = _avgpool3x3(conv(blk.rbr_1x1_avg_branch_1x1, x))
        return conv(blk.rbr_3x3_branch, x) + conv(blk.rbr_1x1_branch, x) + seq + avg
    if bt == "ECB":
        seq = conv(blk.rbr_1x1_3x3_branch_3x3, conv(blk.rbr_1x1_3x3_branch_1x1, x))
        out = conv(blk.rbr_3x3_branch, x) + seq
        for name, mask in reparam.EDGE_MASKS.items():
            out = out + _seqconv_apply(getattr(blk, name), x, mask)
        return out
    raise KeyError(bt)


def block_to_deploy(blk: NeRVBlock) -> NeRVBlock:
    """Fuse the branches into one ``rbr_reparam`` conv, in place; idempotent.
    The fused conv keeps a bias only where the branches had one."""
    if blk.rbr_reparam is not None:
        return blk
    with torch.no_grad():
        k, b = reparam.fuse(blk.branch_type, blk)
        rbr = ConvWeights(k.clone(), b.clone() if b is not None else None)
    for name in BRANCH_ATTRS:
        if hasattr(blk, name):
            delattr(blk, name)
    blk.rbr_reparam = rbr
    return blk
