"""Generator — MLP stem -> reshape -> NeRVBlock stack -> RGB head (port of
``repnerv_tpu/models/generator.py``).

``forward(embed)`` returns a list of NHWC f32 frames, one per active head,
as ``apply_generator(train=False)`` does.  The stem output is viewed NCHW
[B, c, h, w] as in the reference and transposed to NHWC.

Decode path: a deploy block (``rbr_reparam``) with norm none whose input has
at least ``KERNEL_MIN_PIXELS`` pixels runs the fused decode stage
(``kernels/decode.py``), the last one with the head fused in, after which
the forward returns.  On a CUDA tensor that stage is the hand-written
kernel; on a CPU tensor its plain version.  The kernel-layout weights are
packed once per weight version and dtype, not on every call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig, head_plan, stage_channels
from ..kernels import decode as decode_kernel
from .blocks import NeRVBlock, block_to_deploy
from .layers import MLP, ConvWeights, conv2d

# below this input-pixel count a stage stays on the library conv even when
# use_pallas_decode is set (the 9x16 stem map of the flagship gains nothing)
KERNEL_MIN_PIXELS = 1024

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "mixed": torch.float32}


def stage_out_widths(cfg: ModelConfig) -> List[int]:
    plan = stage_channels(cfg)
    return [plan[(i + 1) * cfg.num_blocks - 1][1] for i in range(len(cfg.strides))]


class Generator(nn.Module):
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
        self._packed: Dict[Tuple, decode_kernel.PackedStage] = {}
        self.to(device)
        self.eval()  # the training forward is not ported yet (ROADMAP A3)

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

    def forward(self, embed: torch.Tensor) -> List[torch.Tensor]:
        """embed [B, embed_length] -> list of NHWC f32 frames (eval mode)."""
        cfg = self.cfg
        if self.training:
            raise NotImplementedError("the training forward is not ported yet (ROADMAP A3)")
        if cfg.decode_int8:
            raise NotImplementedError(
                "decode_int8 is not ported yet (ROADMAP B5: the int8 decode kernel)"
            )
        mixed = cfg.compute_dtype == "mixed"
        dtype = DTYPES[cfg.compute_dtype]
        h, w, c = cfg.fc_hwd

        x = self.stem(embed, dtype=dtype, mixed=mixed)
        x = x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()

        outputs: List[torch.Tensor] = []
        li = 0
        for head in self.head_layers:
            for _ in range(cfg.num_blocks):
                blk = self.layers[li]
                is_last = li == len(self.layers) - 1
                use_kernel = (
                    cfg.use_pallas_decode
                    and cfg.norm == "none"
                    and blk.rbr_reparam is not None
                    and x.shape[1] * x.shape[2] >= KERNEL_MIN_PIXELS
                )
                if use_kernel:
                    fuse_head = head if is_last else None
                    p = self._packed_stage(li, fuse_head, dtype)
                    x = decode_kernel.decode_stage(
                        x.to(dtype).contiguous(),
                        p,
                        cfg.act,
                        "sigmoid" if cfg.sigmoid else "tanh",
                    )
                    if fuse_head is not None:
                        outputs.append(x.float())
                        return outputs
                else:
                    x = blk(x, mixed=mixed)
                li += 1
            if head is not None:
                img = conv2d(x, head.weight, head.bias)  # no bf16 cast in "mixed", as in JAX
                img = torch.sigmoid(img) if cfg.sigmoid else (torch.tanh(img) + 1.0) * 0.5
                outputs.append(img.float())
        return outputs


def generator_to_deploy(gen: Generator) -> Generator:
    """Fuse every block's branches into one conv, in place, and mark the
    config deployed (the per-layer switch_to_deploy sweep of the reference)."""
    import dataclasses

    for blk in gen.layers:
        block_to_deploy(blk)
    gen.cfg = dataclasses.replace(gen.cfg, deploy=True)
    gen._packed.clear()
    return gen


def param_count(gen: nn.Module) -> int:
    """Every tensor of the state, as the JAX count over the params pytree
    (which holds BN running statistics too)."""
    return sum(t.numel() for t in gen.state_dict().values())
