"""Structural-reparameterization fusion for all 6 branch types (port of
``repnerv_tpu/models/reparam.py``), on OIHW weights.

``fuse(branch_type, block)`` reads a block's branch modules (attributes named
as in the reference model, see ``models/blocks.py``) and returns the single
equivalent 3x3 kernel [O, I, 3, 3] and bias [O] (or None).  The algebra and
its exactness notes are the JAX package's:

* 1x3 / 3x1 / 1x1 kernels zero-pad to 3x3 and add;
* bias-free 1x1 -> 3x3 -> 1x1 sequences contract over the middle channel;
* DBB's avg-pool branch (AvgPool2d(3, 1, 1), count_include_pad) is a 1/9
  kernel, so (bias-free 1x1) o avgpool is W1x1 / 9 on every tap;
* ECB's SeqConv3x3 edge branch fuses to k0 * scale * mask with bias
  b0 * sum(scale * mask) + bias.

ERB's fusion runs on the card as two launches of
``kernels/reparam_fuse.py`` (and its VJP as two more) when its branch
tensors are CUDA f32 tensors; on any other tensors it is the plain algebra
above (``fuse_erb_plain``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import reparam_fuse

SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))
LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
# edge-branch attribute -> its (kh, kw) mask
EDGE_MASKS = {
    "rbr_conv1x1_sbx_branch": SOBEL_X,
    "rbr_conv1x1_sby_branch": SOBEL_Y,
    "rbr_conv1x1_lpl_branch": LAPLACIAN,
}

Fused = Tuple[torch.Tensor, Optional[torch.Tensor]]


def pad_1x3_to_3x3(w: torch.Tensor) -> torch.Tensor:
    return F.pad(w, (0, 0, 1, 1))


def pad_3x1_to_3x3(w: torch.Tensor) -> torch.Tensor:
    return F.pad(w, (1, 1, 0, 0))


def pad_1x1_to_3x3(w: torch.Tensor) -> torch.Tensor:
    return F.pad(w, (1, 1, 1, 1))


def fuse_seq_1x1_3x3(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Bias-free 1x1 [M, I, 1, 1] then 3x3 [O, M, 3, 3] -> [O, I, 3, 3]."""
    return torch.einsum("omuv,mi->oiuv", w2, w1[:, :, 0, 0])


def fuse_seq_3x3_1x1(w2: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """3x3 [M, I, 3, 3] then bias-free 1x1 [O, M, 1, 1] -> [O, I, 3, 3]."""
    return torch.einsum("om,miuv->oiuv", w3[:, :, 0, 0], w2)


@functools.lru_cache(maxsize=None)
def edge_mask(mask: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 3x3 edge mask as a tensor on ``device``, made once per (mask, dtype,
    device): a copy from host memory on every forward would make the stream
    wait.  Read-only."""
    return torch.tensor(mask, dtype=dtype, device=device)


def fuse_edge_branch(p: nn.Module, mask: tuple) -> Fused:
    """SeqConv3x3 edge branch with params k0 [O, I, 1, 1], b0 [O],
    scale [O, 1, 1, 1], bias [O]."""
    m = edge_mask(mask, p.k0.dtype, p.k0.device)
    eff_mask = p.scale[:, 0] * m[None]  # [O, 3, 3]
    kernel = p.k0 * eff_mask[:, None]  # [O, I, 3, 3]
    bias = p.b0 * eff_mask.sum(dim=(1, 2)) + p.bias
    return kernel, bias


def _wb(conv: nn.Module) -> Fused:
    return conv.weight, conv.bias


def fuse_vanilla(blk: nn.Module) -> Fused:
    return _wb(blk.branch)


def fuse_acb(blk: nn.Module) -> Fused:
    k = (
        blk.rbr_3x3_branch.weight
        + pad_1x3_to_3x3(blk.rbr_1x3_branch.weight)
        + pad_3x1_to_3x3(blk.rbr_3x1_branch.weight)
    )
    b = blk.rbr_3x3_branch.bias + blk.rbr_1x3_branch.bias + blk.rbr_3x1_branch.bias
    return k, b


def erb_tensors(blk: nn.Module):
    """ERB's nine branch tensors in ``reparam_fuse.erb_fold``'s order."""
    return (
        blk.rbr_3x3_branch.weight, blk.rbr_3x3_branch.bias,
        blk.rbr_1x3_branch.weight, blk.rbr_1x3_branch.bias,
        blk.rbr_3x1_branch.weight, blk.rbr_3x1_branch.bias,
        blk.rbr_1x1_3x3_1x1_branch_1x1_1.weight,
        blk.rbr_1x1_3x3_1x1_branch_3x3.weight,
        blk.rbr_1x1_3x3_1x1_branch_1x1_2.weight,
    )


def fuse_erb(blk: nn.Module) -> Fused:
    """ACB's three kernels + the bias-free 1x1 -> 3x3 -> 1x1 branch: the
    kernels of ``reparam_fuse`` on CUDA f32 tensors, else the plain
    version."""
    tensors = erb_tensors(blk)
    if reparam_fuse.takes(tensors):
        return reparam_fuse.erb_fold(*tensors)
    return fuse_erb_plain(blk)


def fuse_erb_plain(blk: nn.Module) -> Fused:
    """``fuse_erb`` in plain PyTorch, on any device and dtype."""
    k, b = fuse_acb(blk)
    seq = fuse_seq_3x3_1x1(
        fuse_seq_1x1_3x3(
            blk.rbr_1x1_3x3_1x1_branch_1x1_1.weight,
            blk.rbr_1x1_3x3_1x1_branch_3x3.weight,
        ),
        blk.rbr_1x1_3x3_1x1_branch_1x1_2.weight,
    )
    return k + seq, b


def fuse_repvgg(blk: nn.Module) -> Fused:
    k = blk.rbr_3x3_branch.weight + pad_1x1_to_3x3(blk.rbr_1x1_branch.weight)
    return k, blk.rbr_3x3_branch.bias + blk.rbr_1x1_branch.bias


def fuse_dbb(blk: nn.Module) -> Fused:
    """3x3 + 1x1 + (1x1 -> 3x3) + (1x1 -> avgpool3x3)."""
    k_seq = fuse_seq_1x1_3x3(
        blk.rbr_1x1_3x3_branch_1x1.weight, blk.rbr_1x1_3x3_branch_3x3.weight
    )
    k_avg = (blk.rbr_1x1_avg_branch_1x1.weight / 9.0).expand(-1, -1, 3, 3)
    k = (
        blk.rbr_3x3_branch.weight
        + pad_1x1_to_3x3(blk.rbr_1x1_branch.weight)
        + k_seq
        + k_avg
    )
    return k, blk.rbr_3x3_branch.bias + blk.rbr_1x1_branch.bias


def fuse_ecb(blk: nn.Module) -> Fused:
    """3x3 + (1x1 -> 3x3) + Sobel-x + Sobel-y + Laplacian edge branches."""
    k = blk.rbr_3x3_branch.weight + fuse_seq_1x1_3x3(
        blk.rbr_1x1_3x3_branch_1x1.weight, blk.rbr_1x1_3x3_branch_3x3.weight
    )
    b = blk.rbr_3x3_branch.bias
    for name, mask in EDGE_MASKS.items():
        ek, eb = fuse_edge_branch(getattr(blk, name), mask)
        k = k + ek
        b = b + eb
    return k, b


FUSERS = {
    "NeRV_vanilla": fuse_vanilla,
    "ERB": fuse_erb,
    "ACB": fuse_acb,
    "RepVGG": fuse_repvgg,
    "DBB": fuse_dbb,
    "ECB": fuse_ecb,
}


def fuse(branch_type: str, blk: nn.Module) -> Fused:
    """A block's branches -> the equivalent (3x3 kernel OIHW, bias | None)."""
    if getattr(blk, "rbr_reparam", None) is not None:  # already deployed
        return _wb(blk.rbr_reparam)
    return FUSERS[branch_type](blk)
