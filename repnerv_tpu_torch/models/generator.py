"""Generator — MLP stem -> reshape -> NeRVBlock stack -> RGB head (port of
``repnerv_tpu/models/generator.py``).

``forward(embed)`` returns a list of NHWC f32 frames, one per active head,
as ``apply_generator`` does, with ``train`` taken from the module's
training mode (a new ``Generator`` starts in eval mode).  The stem output
is viewed NCHW [B, c, h, w] as in the reference and transposed to NHWC.

Decode path (eval mode): a deploy block (``rbr_reparam``) with norm none
whose input has at least ``KERNEL_MIN_PIXELS`` pixels runs the fused decode
stage (``kernels/decode.py``), the last one with the head fused in, after
which the forward returns.  The kernel-layout weights are packed once per
weight version and dtype, not on every call.

int8 decode (eval mode, ``decode_int8``): checked before the decode path,
with the JAX gate (norm none, a deploy block, an entry for the block in the
module's ``int8`` tables; no pixel-count gate), a block runs the int8 stage
(``kernels/decode_int8.py``): a non-int8 input is quantized with the block's
``in_scale``, an int8 input passes through, and the last block fuses the
head and returns f32.  ``calibrate_int8`` returns a copy of a deploy
generator with the tables; each entry holds its stage packed in the
kernel's layout when it is made (``int8_entry``).  The tables live outside
``state_dict()``, so checkpoints and ``load_state(strict=True)`` do not
see them.

Training path (train mode): a block that passes the JAX package's
``use_pallas_train`` gate (batch <= 2, norm none, online fusion, no remat,
not "mixed", input >= ``KERNEL_MIN_PIXELS`` pixels) fuses its branches
(autograd differentiates through the fusion) and runs
``kernels/train_tail.fused_stage_train``, the last one with the head; other
blocks run the library conv under autograd, through
``torch.utils.checkpoint`` with ``remat``.  compute_dtype "mixed" (f32
activations and parameters) runs every block conv and stem matmul through
``layers.mxu_conv2d_f32`` / ``mxu_matmul_f32``: bf16-rounded operands, f32
sums, the cotangent rounded to bf16 in the backward.

On a CUDA tensor each fused stage is a hand-written kernel; on a CPU
tensor its plain version.  Each fused stage, on every path, runs inside the
program span ``stage.s<stride>`` (``stage_spans``): in training the branch
fusion (``reparam.fuse``) and K3, in serving K1 or K2.  The fused stage's
backward (K4 and the library's dX / dW) runs in the same span, inside the
step's backward.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, head_plan, stage_channels
from ..kernels import decode as decode_kernel
from ..kernels import decode_int8
from ..kernels.train_tail import fused_stage_train, stage_span
from ..utils.profiling import span
from . import reparam
from .blocks import NeRVBlock, block_to_deploy
from .layers import MLP, ConvWeights, conv2d

# below this input-pixel count a stage stays on the library conv even when
# use_pallas_decode / use_pallas_train is set (the 9x16 stem map of the
# flagship gains nothing)
KERNEL_MIN_PIXELS = 1024

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "mixed": torch.float32}


def stage_out_widths(cfg: ModelConfig) -> List[int]:
    plan = stage_channels(cfg)
    return [plan[(i + 1) * cfg.num_blocks - 1][1] for i in range(len(cfg.strides))]


class Int8Entry(NamedTuple):
    """One block's int8 decode table (the JAX params' ``int8[str(i)]``) and
    the same table in the kernel's layout."""

    w_q: torch.Tensor  # [3, 3, Cin, Cout] int8, HWIO, PixelShuffle channel order
    scale: torch.Tensor  # [Cout] f32, in_scale * sw
    in_scale: torch.Tensor  # scalar f32, the block input's quantization step
    b: Optional[torch.Tensor]  # [Cout] f32
    out_scale: Optional[torch.Tensor]  # scalar f32, the next block's in_scale
    packed: decode_int8.PackedInt8Stage


def squash_name(cfg: ModelConfig) -> str:
    """The output squash of ``cfg``, by the kernels' name for it."""
    return "sigmoid" if cfg.sigmoid else "tanh"


def use_ptrain(cfg: ModelConfig, x: torch.Tensor, train: bool) -> bool:
    """Whether a block runs the fused training stage (K3 forward, K4
    backward) on its NHWC input ``x``: training, at most two frames, no
    norm, fused branches, no remat, not "mixed", and a stage of at least
    ``KERNEL_MIN_PIXELS`` pixels (the JAX package's gate)."""
    return (
        train
        and cfg.use_pallas_train
        and x.shape[0] <= 2
        and cfg.norm == "none"
        and cfg.online_fuse
        and not cfg.remat
        and cfg.compute_dtype != "mixed"
        and x.shape[1] * x.shape[2] >= KERNEL_MIN_PIXELS
    )


class Generator(nn.Module):
    # the split dim of each state entry when the module holds one rank's
    # shards (parallel/sharding.py::shard_train_state), else None
    shard_specs: Optional[Dict[str, Optional[int]]] = None

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cpu"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        stem_dim, stem_num = cfg.stem_dims
        h, w, c = cfg.fc_hwd
        dims = [cfg.embed_length] + [stem_dim] * stem_num + [h * w * c]
        self.stem = MLP(dims, cfg.act, bias=True, generator=g)
        self.layers = nn.ModuleList(
            NeRVBlock(
                ngf=ngf,
                new_ngf=new_ngf,
                stride=stride,
                branch_type=cfg.branch_type,
                norm=cfg.norm,
                act=cfg.act,
                bias=cfg.bias,
                deploy=cfg.deploy,
                generator=g,
            )
            for ngf, new_ngf, stride in stage_channels(cfg)
        )
        widths = stage_out_widths(cfg)
        self.head_layers = nn.ModuleList(
            ConvWeights.uniform(widths[i], 3, 1, 1, bias=cfg.bias, generator=g)
            if has_head
            else None
            for i, has_head in enumerate(head_plan(cfg))
        )
        # each block's fused-stage span, named once
        self.stage_spans = [stage_span(blk.stride) for blk in self.layers]
        self._packed: Dict[Tuple, decode_kernel.PackedStage] = {}
        # int8 decode tables by block index (str, as the JAX params' keys)
        self.int8: Dict[str, Int8Entry] = {}
        self.to(device)
        self.eval()

    def _packed_stage(
        self, li: int, head: Optional[ConvWeights], dtype: torch.dtype
    ) -> decode_kernel.PackedStage:
        """Block ``li``'s weights in the decode kernel's layout, packed once
        per (weight version, dtype)."""
        rbr = self.layers[li].rbr_reparam
        tensors = [rbr.weight, rbr.bias] + ([head.weight, head.bias] if head is not None else [])
        key = (li, dtype) + tuple(
            (t.data_ptr(), t._version) if t is not None else None for t in tensors
        )
        if key not in self._packed:
            self._packed = {k: v for k, v in self._packed.items() if k[:2] != (li, dtype)}
            with torch.no_grad():
                self._packed[key] = decode_kernel.pack_weights(
                    rbr.weight.permute(2, 3, 1, 0),  # OIHW -> HWIO
                    rbr.bias,
                    self.layers[li].stride,
                    dtype,
                    head_w=head.weight.permute(2, 3, 1, 0) if head is not None else None,
                    head_b=head.bias if head is not None else None,
                )
        return self._packed[key]

    def forward(self, embed: torch.Tensor, mesh=None) -> List[torch.Tensor]:
        """embed [B, embed_length] -> list of NHWC f32 frames.  ``mesh`` (a
        ``parallel.sharding.Mesh``): the train-mode forward of
        ``parallel/tensor_parallel.py`` over its ranks, on this rank's
        shards under a model axis (``shard_specs``), with the global batch
        statistics of ``--norm bn`` over its data axis."""
        if mesh is not None:
            if not self.training:
                raise ValueError("the forward over a mesh trains; evaluate the gathered model")
            from ..parallel import tensor_parallel

            return tensor_parallel.forward(self, embed, mesh)
        cfg = self.cfg
        train = self.training
        mixed = cfg.compute_dtype == "mixed"
        dtype = DTYPES[cfg.compute_dtype]
        squash = squash_name(cfg)
        h, w, c = cfg.fc_hwd

        x = self.stem(embed, dtype=dtype, mixed=mixed)
        x = x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()

        outputs: List[torch.Tensor] = []
        li = 0
        for head in self.head_layers:
            for _ in range(cfg.num_blocks):
                blk = self.layers[li]
                fuse_head = head if li == len(self.layers) - 1 else None
                q = (
                    self.int8.get(str(li))
                    if cfg.decode_int8
                    and not train
                    and cfg.norm == "none"
                    and blk.rbr_reparam is not None
                    else None
                )
                if q is not None:
                    if x.dtype != torch.int8:
                        with span("int8.quantize_act"):
                            x = decode_int8.quantize_act_int8(x, q.in_scale)
                    with span(self.stage_spans[li]):
                        x = decode_int8.decode_stage_int8(x.contiguous(), q.packed, cfg.act,
                                                          squash)
                    if fuse_head is not None:
                        outputs.append(x)
                        return outputs
                    li += 1
                    continue
                use_decode = (
                    not train
                    and cfg.use_pallas_decode
                    and cfg.norm == "none"
                    and blk.rbr_reparam is not None
                    and x.shape[1] * x.shape[2] >= KERNEL_MIN_PIXELS
                )
                if use_decode:
                    with span(self.stage_spans[li]):
                        p = self._packed_stage(li, fuse_head, dtype)
                        x = decode_kernel.decode_stage(x.to(dtype).contiguous(), p, cfg.act,
                                                       squash)
                elif use_ptrain(cfg, x, train):
                    with span(self.stage_spans[li]):
                        with span("reparam.fuse"):
                            wt, bt = reparam.fuse(cfg.branch_type, blk)
                        if bt is None:
                            bt = torch.zeros(wt.shape[0], dtype=wt.dtype, device=wt.device)
                        x = fused_stage_train(
                            x,
                            wt.permute(2, 3, 1, 0),  # OIHW -> HWIO
                            bt,
                            fuse_head.weight.permute(2, 3, 1, 0) if fuse_head is not None
                            else None,
                            fuse_head.bias if fuse_head is not None else None,
                            blk.stride,
                            cfg.act,
                            squash,
                            "float32" if cfg.compute_dtype == "float32" else "bfloat16",
                        )
                else:
                    fuse_head = None
                    if train and cfg.remat:
                        # the model draws no random numbers: no RNG state to save,
                        # and none to read while a CUDA graph is being captured
                        x = checkpoint(blk, x, mixed, cfg.online_fuse, use_reentrant=False,
                                       preserve_rng_state=False)
                    else:
                        x = blk(x, mixed=mixed, online_fuse=cfg.online_fuse)
                if fuse_head is not None:
                    outputs.append(x.float())
                    return outputs
                li += 1
            if head is not None:
                img = conv2d(x, head.weight, head.bias)  # no bf16 cast in "mixed", as in JAX
                img = torch.sigmoid(img) if cfg.sigmoid else (torch.tanh(img) + 1.0) * 0.5
                outputs.append(img.float())
        return outputs


def generator_to_deploy(gen: Generator) -> Generator:
    """A new generator with every block's branches fused into one conv and
    the config marked deployed (the reference's switch_to_deploy sweep).
    ``gen`` is left as it was, so training can go on after a deploy
    snapshot, as with the JAX package's pure function."""
    dep = copy.deepcopy(gen)
    for blk in dep.layers:
        block_to_deploy(blk)
    dep.cfg = dataclasses.replace(gen.cfg, deploy=True)
    dep._packed = {}
    return dep


@torch.no_grad()
def int8_entry(gen: Generator, li: int, w_q, scale, in_scale, b, out_scale) -> Int8Entry:
    """Block ``li``'s int8 table for ``gen``, its stage packed in the
    kernel's layout once, here: the last block with ``gen``'s head fused,
    the others requantizing to ``out_scale``."""
    head = gen.head_layers[-1] if li == len(gen.layers) - 1 else None
    packed = decode_int8.pack_int8_stage(
        w_q, scale, b, gen.layers[li].stride,
        out_scale=out_scale if head is None else None,
        head_w=head.weight.permute(2, 3, 1, 0) if head is not None else None,
        head_b=head.bias if head is not None else None,
    )
    return Int8Entry(w_q, scale, in_scale, b, out_scale, packed)


@torch.no_grad()
def calibrate_int8(gen: Generator, calib_embeds: torch.Tensor) -> Generator:
    """A copy of the deploy generator ``gen`` with int8 decode tables for the
    trailing blocks (from ``len(blocks) + cfg.int8_from_block`` on), as the
    JAX package's ``calibrate_int8``: an f32 forward over ``calib_embeds`` in
    2-frame chunks through the library conv (whatever ``compute_dtype`` is:
    a bf16 decode would move the abs-max), the abs-max of each block's
    input, then per block the per-channel int8 weights, ``in_scale =
    max(amax, 1e-12) / 127``, ``scale = in_scale * sw`` and the next block's
    scale as ``out_scale``, all f32 on the generator's device.  ``gen`` is
    left as it was.  Multi-head layouts and an ``int8_from_block`` out of
    range are declined: ``gen`` itself comes back, without tables."""
    cfg = gen.cfg
    heads = head_plan(cfg)
    if any(heads[:-1]) or not heads[-1]:
        return gen
    n_blocks = len(gen.layers)
    first = n_blocks + cfg.int8_from_block
    if not 0 <= first < n_blocks:
        return gen
    if any(blk.rbr_reparam is None for blk in gen.layers):
        raise ValueError("calibrate_int8 needs a deploy generator (fused blocks)")

    h, w, c = cfg.fc_hwd
    emb = calib_embeds.to(torch.float32)
    pad = (-emb.shape[0]) % 2
    if pad:  # repeating the last frame cannot change any max
        emb = torch.cat([emb, emb[-1:].expand(pad, -1)])
    amax = torch.zeros(n_blocks, dtype=torch.float32, device=emb.device)
    was_training = gen.training
    gen.eval()
    try:
        with decode_kernel.exact_f32():
            for chunk in emb.split(2):
                x = gen.stem(chunk)
                x = x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1)
                per_block = []
                for blk in gen.layers:
                    per_block.append(x.abs().amax())
                    x = blk(x)
                amax = torch.maximum(amax, torch.stack(per_block))
    finally:
        gen.train(was_training)

    out = copy.deepcopy(gen)
    out._packed = {}
    out.int8 = {}
    for i in range(first, n_blocks):
        rbr = out.layers[i].rbr_reparam
        w_q, sw = decode_int8.quantize_weight_int8(rbr.weight.detach().permute(2, 3, 1, 0))
        in_scale = torch.clamp_min(amax[i], 1e-12) / 127.0
        out.int8[str(i)] = int8_entry(
            out, i, w_q, in_scale * sw, in_scale,
            rbr.bias.detach().to(torch.float32) if rbr.bias is not None else None,
            torch.clamp_min(amax[i + 1], 1e-12) / 127.0 if i + 1 < n_blocks else None,
        )
    return out


def param_count(gen: nn.Module) -> int:
    """Every tensor of the state, as the JAX count over the params pytree
    (which holds BN running statistics too)."""
    return sum(t.numel() for t in gen.state_dict().values())
