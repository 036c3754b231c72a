"""Configuration of the PyTorch port: its own copy of ``repnerv_tpu/config.py``
(stdlib only), with the same dataclasses, fields, defaults and JSON form, so
a ``.rnvb`` header or a checkpoint's config written by either package reads
back in the other.

One dataclass shared by the train and eval CLIs, replacing the duplicated
~130-line argparse blocks of the reference (main_train.py:39-109
and main_eval.py:31-104).  The CLI layer (``cli/args.py``) keeps
an argv-compatible flag surface, including ``@argfile`` support.  Fields
that only the JAX package acts on (``mesh_shape``, ``mesh_axes``,
``donate``, ``profile``, ``stream_chunk_mb``, ...) are kept so that the two
configs stay field-for-field equal.  ``fused_epoch`` selects the port's
fused epoch (``train/loop.py::make_epoch_fn``: one CUDA graph replay per
step on the card) as it selects the JAX package's ``lax.scan`` epoch.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

BRANCH_TYPES = ("NeRV_vanilla", "ERB", "ACB", "RepVGG", "DBB", "ECB")
ACT_TYPES = (
    "relu",
    "leaky",
    "leaky01",
    "relu6",
    "gelu",
    "sin",
    "swish",
    "softplus",
    "hardswish",
)
NORM_TYPES = ("none", "bn", "in")
LR_TYPES = ("cosine", "step", "const", "plateau")


@dataclass
class ModelConfig:
    """Generator architecture (reference: model.py:571-609)."""

    embed: str = "1.25_40"  # "base_levels" positional-encoding spec, or "none"
    stem_dim_num: str = "512_1"  # "hidden_dim_num_layers"
    fc_hw_dim: str = "9_16_26"  # "h_w_c" of the reshaped stem output
    expansion: float = 1.0  # channel expansion at first conv stage
    reduction: int = 2  # channel reduction at strided stages
    strides: Tuple[int, ...] = (5, 2, 2, 2, 2)
    num_blocks: int = 1  # blocks per stage (only the first carries the stride)
    lower_width: int = 96  # channel floor for feature maps
    norm: str = "none"
    act: str = "swish"
    bias: bool = True
    single_res: bool = True  # single head at the last stage vs one head per stage
    sigmoid: bool = False  # sigmoid output; else (tanh(x)+1)/2
    branch_type: str = "NeRV_vanilla"
    deploy: bool = False  # build the fused single-conv graph
    conv_type: str = "conv"  # kept for flag parity (dead in reference, model.py:143)

    # knobs with no reference counterpart
    compute_dtype: str = "float32"  # "float32" | "bfloat16" | "mixed"
    # ("mixed" = f32 activations/params with bf16 matmul inputs + f32
    #  accumulation on every conv/matmul, models/layers.py::mxu_conv2d_f32)
    online_fuse: bool = True  # run one fused conv per block instead of branch-sum
    use_pallas_decode: bool = True  # fused conv+PS+act(+head) decode kernel
    # (the field keeps the JAX package's name; here: kernels/decode.py)
    use_pallas_train: bool = True  # fused TRAIN forward / epilogue backward for
    # the trailing stages (kernels/train_tail.py)
    decode_int8: bool = False  # int8 decode for the trailing blocks; needs
    # calibrate_int8() tables on the generator
    int8_from_block: int = -2  # first int8 block, counted from the end (the
    # tail blocks carry ~95% of decode FLOPs; early stages stay high-precision)
    remat: bool = False  # recompute each block in the backward

    @property
    def embed_length(self) -> int:
        if self.embed.lower() == "none":
            return 1
        _, levels = self.embed.split("_")
        return 2 * int(levels)

    @property
    def stem_dims(self) -> Tuple[int, int]:
        d, n = self.stem_dim_num.split("_")
        return int(d), int(n)

    @property
    def fc_hwd(self) -> Tuple[int, int, int]:
        h, w, d = self.fc_hw_dim.split("_")
        return int(h), int(w), int(d)


@dataclass
class DataConfig:
    """Frame source (reference: model.py:11-70, main_train.py:200-215)."""

    dataset: str = "bunny"
    data_dir: str = "data"  # root holding <dataset>/ frame images
    vid: Optional[Tuple[int, ...]] = None  # frame-index subset
    frame_gap: int = 1
    test_gap: int = 1
    batch_size: int = 1
    # Synthetic fallback when no frame directory exists (tests / benches).
    synthetic_frames: int = 0
    synthetic_hw: Tuple[int, int] = (720, 1280)
    # Content key of the synthetic/photo/corpus generator: lets a SINGLE-video
    # run (train/eval CLI) reproduce exactly the content the multi-video
    # suite assigns video v (manual_seed + v).
    content_seed: int = 0
    # Camera-motion profile of the synthetic/photo/corpus generators:
    # "normal" = the standard pan/zoom; "slow" = 1/8 pan amplitude + 0.4%
    # zoom breath; "static" = frozen camera (every frame identical).  The
    # slow/static profiles isolate temporal bandwidth from spatial capacity
    # in the text-class floor analysis.
    content_motion: str = "normal"
    cache_device: bool = True  # keep the decoded video resident in HBM
    # Out-of-core controls (the reference never materializes the video — each
    # sample is a per-item PIL load, model.py:52-70 — so arbitrarily large
    # videos train from disk; these give this build the same reach):
    #   hbm_budget_mb   -1 = auto (a fraction of the device's HBM), 0 = never
    #                   spill; videos larger than the budget stay host-side
    #                   and the fused epoch streams chunks to the device.
    #   host_budget_mb  0 = unlimited; frame DIRECTORIES whose decoded size
    #                   exceeds this stay on disk and decode lazily per
    #                   gather (the reference's per-__getitem__ regime).
    #   stream_chunk_mb per-dispatch pixel budget of the streaming fused
    #                   epoch (one H2D + one scan per chunk).
    hbm_budget_mb: int = -1
    host_budget_mb: int = 0
    stream_chunk_mb: int = 256


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)

    epochs: int = 300
    warmup: float = 0.2  # ratio of epochs (int(warmup*epochs) epochs of warmup)
    lr: float = 5e-4
    lr_type: str = "cosine"
    lr_steps: Tuple[float, ...] = ()
    beta: float = 0.5  # Adam beta1 (reference main_train.py:196)
    loss_type: str = "Fusion6"
    lw: float = 1.0  # loss weight on all but the last multi-scale head
    eval_freq: int = 50
    ckpt_freq: int = 1  # epochs between checkpoint writes (1 = reference cadence)
    eval_fps: bool = False
    manual_seed: int = 1
    print_freq: int = 50
    debug: bool = False  # truncate epochs to 10 steps; eval every epoch
    outf: str = "result/unify"
    suffix: str = ""
    overwrite: bool = False
    weight: str = "None"

    # compression / eval surface (reference main_eval.py flags)
    prune_ratio: float = 1.0
    prune_steps: Tuple[float, ...] = (0.0,)
    quant_bit: int = -1
    quant_axis: int = 0
    finetune: bool = False
    finetune_epochs: int = 100
    finetune_qat: bool = False  # quantization-aware finetune: the forward
    # trains through a straight-through fake quantizer matching the final
    # quantize_params semantics, so post-finetune quantization is
    # (near-)lossless; reparam branches deploy BEFORE the finetune so the
    # fused rbr_reparam tensors are the ones adapted (compress/qat.py —
    # capability beyond the reference, whose switch_to_deploy is
    # destructive and untrainable)
    dump_images: bool = False
    codec: str = "huffman"  # entropy coder for the BPP accounting/bitstream:
    # "huffman" (reference dahuffman parity, main_eval.py:673-698) or "rans"
    # (fractional-bit coding; measured ~0.3% smaller BPP on the smooth
    # weight histograms — compress/rans.py)
    save_bitstream: bool = False  # write the real compressed artifact
    # (codes + codec table + qparams + sparsity map in one file) and verify
    # its decode reproduces the evaluated weights bit-exactly; reports the
    # all-in BPP next to the reference-style symbol-only estimate
    # (compress/bitstream.py — the reference never writes an artifact,
    # main_eval.py:714-727 only estimates)

    # parity dials (documented deviations from the reference, each with a
    # flag to reproduce the reference behavior exactly for A/B runs)
    lr_frac_mode: str = "batch"  # "batch": continuous intra-epoch LR fraction;
    # "sample": reference adjust_lr denominator (utils.py:241) — at b>1 the
    # intra-epoch fraction only reaches 1/b (see train/schedule.py docstring)
    finetune_lr_mode: str = "fresh"  # "fresh": new warmup+decay over
    # finetune_epochs (actually recovers quality); "reference": continue the
    # original cosine past its end (main_eval.py:447,472 — lr stays ~0, the
    # reference's finetune barely updates)
    dump_gt: bool = False  # also dump gt_{n}.png next to pred_{n}.png
    # (commented-out in the reference, main_eval.py:804)

    # In-run divergence recovery (train/recovery.py): an epoch
    # whose train PSNR is NaN or > recover_drop_db below the running best
    # restores the best on-device snapshot with fresh optimizer moments
    # (bounded retries), and the final state is never left collapsed.
    # <= 0 disables.  Calibrated on two recorded collapses: healthy runs
    # dip < ~1.5 dB, collapses > 20.
    recover_drop_db: float = 6.0
    max_recoveries: int = 3

    # accelerator-specific
    profile: bool = False  # capture a profiler trace of the first epoch
    fused_epoch: bool = True  # scan the whole epoch in one device dispatch
    mesh_shape: Tuple[int, ...] = ()  # () = single device; e.g. (8,) data-parallel
    mesh_axes: Tuple[str, ...] = ("data",)
    donate: bool = True

    def warmup_epochs(self) -> int:
        # reference: args.warmup = int(args.warmup * args.epochs), main_train.py:111
        return int(self.warmup * self.epochs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        raw = json.loads(s)
        model = ModelConfig(**{k: _tupled(v) for k, v in raw.pop("model").items()})
        data = DataConfig(**{k: _tupled(v) for k, v in raw.pop("data").items()})
        return TrainConfig(model=model, data=data, **{k: _tupled(v) for k, v in raw.items()})


def _tupled(v):
    return tuple(v) if isinstance(v, list) else v


def stage_channels(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """Per-block (in_ch, out_base_ch, stride) schedule.

    Mirrors the loop in reference model.py:583-595: stage 0 expands by
    ``expansion``; later stages divide by ``reduction`` when strided, clamped
    below by ``lower_width``.  Within a stage only the first block upsamples.
    """
    h, w, ngf = cfg.fc_hwd
    plan: List[Tuple[int, int, int]] = []
    for i, stride in enumerate(cfg.strides):
        if i == 0:
            new_ngf = int(ngf * cfg.expansion)
        else:
            new_ngf = max(ngf // (1 if stride == 1 else cfg.reduction), cfg.lower_width)
        for j in range(cfg.num_blocks):
            plan.append((ngf, new_ngf, 1 if j else stride))
            ngf = new_ngf
    return plan


def head_plan(cfg: ModelConfig) -> List[bool]:
    """Whether each *stage* carries a 1x1 RGB head (reference model.py:598-608)."""
    n = len(cfg.strides)
    if cfg.single_res:
        return [i == n - 1 for i in range(n)]
    return [True] * n


def output_hw(cfg: ModelConfig) -> Tuple[int, int]:
    h, w, _ = cfg.fc_hwd
    for s in cfg.strides:
        h, w = h * s, w * s
    return h, w
