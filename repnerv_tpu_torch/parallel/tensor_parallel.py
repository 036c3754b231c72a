"""Tensor parallelism over the mesh's ``"model"`` axis: the generator's
train-mode forward on this rank's shards of the parameters, with the
collectives of the layout that ``repnerv_tpu/parallel/sharding.py``'s
``params_specs`` asks GSPMD for.

``sharding.params_specs`` says which leaf splits: the stem's first linear by
its outputs (column parallel), its later ones by their inputs (row
parallel), and every conv weight by its output channels, wherever the
dimension divides the model axis.  A rank holds its contiguous slice of each
such leaf, the whole of every other one.  ``forward`` computes only the
rank's share of the work and moves activations between the ranks of its
model group:

* **the stem**: the Megatron MLP (layer 0 on the rank's outputs, layer 1 on
  the matching inputs, one all-reduce of the partial sums);
* **a NeRV block** whose Cout divides: the rank's Cout slice of the fused
  3x3 kernel (``models/reparam.py``; the leaves the fusion contracts over,
  ERB's ``seq_1x1_a`` and ``seq_3x3`` and the DBB / ECB ``seq_1x1``, are
  all-gathered whole), the stage on that slice (K3 / K4 where the
  generator's gate holds), then an all-gather of the output over channels
  for the next block.  A slice of Cout / M channels is whole PixelShuffle
  groups (Cout / M a multiple of s^2) or the conv output is gathered before
  the shuffle;
* **a head**: row parallel over the channels of its input (the rank's shard
  of the last stage's output, never gathered), one all-reduce of the
  3-channel partial map, then the bias and the squash;
* **loss and metrics**: on the same full output on every model rank.

Gradients.  A replicated activation (the stem's output, a gathered stage
output) feeds a per-rank computation, so each rank's gradient of it is a
partial one and the true gradient is their sum: the all-gather's backward
sums and keeps the rank's slice, the stem's all-reduce sums its cotangents
too, and a replicated leaf that a rank uses only in part (a conv
bias through its slice, a stem bias after the all-reduce) passes through
``copy``: identity forward, all-reduce backward.  The heads' all-reduce
feeds the loss, which every rank computes whole: its backward is the
identity.  So every replicated leaf ends the backward with the same
gradient on every model rank, and every shard with its own slice of the
full model's gradient.

``--norm bn`` over more than one data rank (``batch_norm_train``): the
statistics of the global batch, from sums all-reduced over the data group.

The forward always fuses the branches (``online_fuse`` off computes the same
function branch by branch) and never rematerializes (``remat`` trades memory
for time, not values); every collective works in f32 (bf16 gathers move the
bits as f16), as ``parallel/collectives.py`` says.
"""

from __future__ import annotations

import types
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config import head_plan, stage_channels
from ..kernels.train_tail import fused_stage_train
from ..models import reparam
from ..models.generator import DTYPES, squash_name, use_ptrain
from ..models.layers import Linear, activation, batch_norm_train, conv2d, linear, pixel_shuffle
from . import collectives as C

# the leaves the fusion contracts over their output channels (dim 0): a Cout
# slice of the fused kernel needs them whole
CONTRACTED = (
    "rbr_1x1_3x3_1x1_branch_1x1_1",
    "rbr_1x1_3x3_1x1_branch_3x3",
    "rbr_1x1_3x3_branch_1x1",
)


# the collectives over the mesh's model group (``parallel/collectives.py``);
# no-ops on a model axis of one rank


def all_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    if mesh.model_size == 1:
        return x
    return C.all_gather(x, dim % x.dim(), mesh.model_group, mesh.model_size, mesh.model_index)


def reduce(x: torch.Tensor, mesh, grad_sum: bool) -> torch.Tensor:
    return x if mesh.model_size == 1 else C.all_reduce(x, mesh.model_group, grad_sum)


def copy(x: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    return x if x is None or mesh.model_size == 1 else C.copy(x, mesh.model_group)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def _stem(gen, embed, mesh, specs, dtype, mixed) -> torch.Tensor:
    """The MLP stem; returns its output whole on every rank."""
    x, sharded = embed, False
    linears = [m for m in gen.stem.children() if isinstance(m, Linear)]
    for i, lin in enumerate(linears):
        split = specs.get(f"stem.{2 * i}.weight")
        if split == 0:  # column parallel: this rank's outputs (and bias)
            x, sharded = linear(x, lin.weight, lin.bias, dtype, mixed), True
        elif split == 1:  # row parallel: partial sums over this rank's inputs
            xs = x if sharded else mesh.model_slice(x, -1)
            x = reduce(linear(xs, lin.weight, None, dtype, mixed), mesh, grad_sum=True)
            if lin.bias is not None:
                x = x + copy(lin.bias, mesh).to(x.dtype)
            sharded = False
        else:
            if sharded:
                x, sharded = all_gather(x, -1, mesh), False
            x = linear(x, copy(lin.weight, mesh), copy(lin.bias, mesh), dtype, mixed)
        x = activation(x, gen.stem.act)
    return all_gather(x, -1, mesh) if sharded else x


def _leaf(mesh, specs, name: str, t: torch.Tensor, contracted: bool,
          split: bool) -> torch.Tensor:
    """What the rank's share of a block uses of the leaf ``name``: a split
    leaf as held (or gathered whole where the fusion contracts over it), a
    replicated one through ``copy`` (and its Cout slice where the block
    splits)."""
    if specs.get(name) == 0:
        return all_gather(t, 0, mesh) if contracted else t
    t = copy(t, mesh)
    return mesh.model_slice(t, 0) if split and not contracted else t


def _block_view(blk, li: int, mesh, specs, split: bool):
    """A stand-in for block ``li`` whose branches hold what the rank's share
    uses (``_leaf``), for ``reparam.fuse``."""
    view = types.SimpleNamespace(rbr_reparam=None)
    for attr, mod in blk.named_children():
        if attr == "norm":
            continue
        sub = types.SimpleNamespace()
        for pname, p in mod.named_parameters(recurse=False):
            setattr(sub, pname, _leaf(mesh, specs, f"layers.{li}.{attr}.{pname}", p,
                                      attr in CONTRACTED, split))
        if not hasattr(sub, "bias") and hasattr(mod, "bias"):
            sub.bias = None
        setattr(view, attr, sub)
    return view


def _block(gen, li: int, x: torch.Tensor, mesh, train_kernel: bool):
    """Block ``li`` on the whole input ``x``: returns (its output, whether
    that is this rank's channel shard of it).  ``train_kernel``: the
    generator's gate for the fused training stage holds."""
    cfg = gen.cfg
    blk = gen.layers[li]
    s = blk.stride
    _, new_ngf, _ = stage_channels(cfg)[li]
    split = divides(new_ngf * s * s, mesh.model_size)
    k, b = reparam.fuse(blk.branch_type, _block_view(blk, li, mesh, gen.shard_specs or {}, split))
    whole = k.shape[0] % (s * s) == 0
    if train_kernel and whole:
        if b is None:
            b = torch.zeros(k.shape[0], dtype=k.dtype, device=k.device)
        y = fused_stage_train(x, k.permute(2, 3, 1, 0), b, None, None, s, cfg.act,
                              squash_name(cfg),
                              "float32" if cfg.compute_dtype == "float32" else "bfloat16")
        return y, split
    out = conv2d(x, k, b, mixed=cfg.compute_dtype == "mixed")
    sharded = split and whole
    if split and not whole:  # a slice of partial PixelShuffle groups: shuffle it whole
        out = all_gather(out, -1, mesh)
    out = pixel_shuffle(out, s)
    if cfg.norm == "bn":
        w, bias = copy(blk.norm.weight, mesh), copy(blk.norm.bias, mesh)
        if sharded:
            w, bias = mesh.model_slice(w, 0), mesh.model_slice(bias, 0)
        group = None  # this rank's rows alone
        if mesh.data_size > 1:
            group = mesh.data_group if mesh.data_group is not None else dist.group.WORLD
        out = batch_norm_train(out, w, bias, blk.norm.eps, group)
    else:
        out = blk.norm(out)
    return activation(out, cfg.act), sharded


def _head(gen, hi: int, x: torch.Tensor, sharded: bool, mesh) -> torch.Tensor:
    """Head ``hi`` on a stage output (this rank's channel shard, or whole):
    row parallel over the input channels, partial sums in f32, one
    all-reduce, then the bias and the squash; the output f32 NHWC."""
    head = gen.head_layers[hi]
    name = f"head_layers.{hi}.weight"
    if mesh.model_size == 1:
        img = conv2d(x, head.weight, head.bias)
    else:
        split = (gen.shard_specs or {}).get(name) == 0
        w = all_gather(head.weight, 0, mesh) if split else copy(head.weight, mesh)
        m, c = mesh.model_index, x.shape[-1]
        if sharded:
            lo, n = m * c, c
        else:  # this rank's share of the channels (any count)
            bounds = [c * r // mesh.model_size for r in range(mesh.model_size + 1)]
            lo, n = bounds[m], bounds[m + 1] - bounds[m]
            x = x.narrow(-1, lo, n)
        part = conv2d(x.float(), w.narrow(1, lo, n).float())
        img = reduce(part, mesh, grad_sum=False)
        if head.bias is not None:
            img = img + head.bias
    img = torch.sigmoid(img) if gen.cfg.sigmoid else (torch.tanh(img) + 1.0) * 0.5
    return img.float()


def divides(dim: int, axis_size: int) -> bool:
    """JAX's ``_divides``: an axis of more than one rank that ``dim`` divides."""
    return axis_size > 1 and dim % axis_size == 0


def forward(gen, embed: torch.Tensor, mesh) -> List[torch.Tensor]:
    """The train-mode forward of ``gen`` on ``embed`` [B, embed_length] over
    ``mesh`` (a ``parallel.sharding.Mesh``): ``gen`` holds this rank's shards
    of the leaves its ``shard_specs`` split (none on a model axis of one
    rank).  Returns the list of NHWC f32 frames of ``Generator.forward``,
    whole on every model rank."""
    cfg = gen.cfg
    mixed = cfg.compute_dtype == "mixed"
    h, w, c = cfg.fc_hwd
    x = _stem(gen, embed, mesh, gen.shard_specs or {}, DTYPES[cfg.compute_dtype], mixed)
    x = x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()
    outputs: List[torch.Tensor] = []
    n_blocks = len(gen.layers)
    li = 0
    for hi, has_head in enumerate(head_plan(cfg)):
        for _ in range(cfg.num_blocks):
            y, sharded = _block(gen, li, x, mesh, use_ptrain(cfg, x, train=True))
            li += 1
            if li < n_blocks:
                x = all_gather(y, -1, mesh) if sharded else y
        if has_head:
            outputs.append(_head(gen, hi, y, sharded, mesh))
    return outputs
