"""NeRVBlock — conv -> PixelShuffle -> norm -> act (port of
``repnerv_tpu/models/blocks.py``).

``out_channels = new_ngf * stride**2`` feeds a PixelShuffle(stride), so one
stride-1 conv performs the upsampling.  The block holds its branch weights
under the reference model's attribute names; ``forward`` is the online-fused
path: fuse the branches into one 3x3 kernel, run one conv.  Deploy replaces
the branches with a single ``rbr_reparam`` conv (``block_to_deploy``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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

    def forward(self, x: torch.Tensor, mixed: bool = False) -> torch.Tensor:
        """NHWC forward: one conv with the fused kernel, then pixel shuffle,
        norm, act (the eval-mode fused path of the JAX ``apply_block``)."""
        k, b = reparam.fuse(self.branch_type, self)
        out = conv2d(x, k, b, mixed=mixed)
        out = pixel_shuffle(out, self.stride)
        return activation(self.norm(out), self.act)


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
