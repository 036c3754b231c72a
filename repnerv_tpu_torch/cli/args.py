"""Shared CLI parser — argv-compatible with the reference flag surface.
The port's own copy of ``repnerv_tpu/cli/args.py``: the same flags, defaults
and help, so the rank0 lines and the experiment ids of the two packages stay
equal.

One parser serves both train and eval (the reference duplicates ~130 lines
between main_train.py:39-109 and main_eval.py:31-104).  ``@argfile``
expansion is kept (fromfile_prefix_chars).  Flags the reference parses but
never uses (``--scale, --augment, --cycles, --eval_only, --not_resume_epoch``)
are accepted for drop-in compatibility and ignored.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import DataConfig, ModelConfig, TrainConfig


def build_parser(eval_mode: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(fromfile_prefix_chars="@")

    # dataset
    p.add_argument("--vid", default=[None], type=int, nargs="+")
    p.add_argument("--scale", type=int, default=1)  # dead in reference
    p.add_argument("--frame_gap", type=int, default=1)
    p.add_argument("--augment", type=int, default=0)  # dead in reference
    p.add_argument("--dataset", type=str, default="UVG")
    p.add_argument("--test_gap", default=1, type=int)
    p.add_argument("--data_dir", type=str, default="data")  # ours (ref hardcodes ../data)
    p.add_argument("--synthetic_frames", type=int, default=0)
    p.add_argument("--synthetic_hw", type=int, nargs=2, default=[720, 1280])
    p.add_argument(
        "--content_seed", type=int, default=0,
        help="content key of the synth/photo/corpus generator; suite video v "
        "uses manual_seed+v, so this reproduces one suite video standalone",
    )
    p.add_argument(
        "--content_motion", default="normal",
        choices=["normal", "slow", "static"],
        help="camera-motion profile of the photo/corpus generators; the "
        "slow/static profiles isolate temporal bandwidth from spatial "
        "capacity (BENCHMARKS 'text-class floor')",
    )
    # out-of-core (ours; the reference streams per-item from disk instead,
    # model.py:52-70 — see DataConfig for the three-rung ladder)
    p.add_argument("--hbm_budget_mb", type=int, default=-1)
    p.add_argument("--host_budget_mb", type=int, default=0)
    p.add_argument("--stream_chunk_mb", type=int, default=256)

    # architecture
    p.add_argument("--embed", type=str, default="1.25_80")
    p.add_argument("--stem_dim_num", type=str, default="1024_1")
    p.add_argument("--fc_hw_dim", type=str, default="9_16_128")
    p.add_argument("--expansion", type=float, default=8)
    p.add_argument("--reduction", type=int, default=2)
    p.add_argument("--strides", type=int, nargs="+", default=[5, 3, 2, 2, 2])
    p.add_argument("--num_blocks", type=int, default=1)
    p.add_argument("--norm", default="none", choices=["none", "bn", "in"])
    p.add_argument(
        "--act",
        type=str,
        default="gelu",
        choices=["relu", "leaky", "leaky01", "relu6", "gelu", "swish", "softplus", "hardswish", "sin"],
    )
    p.add_argument("--lower_width", type=int, default=32)
    p.add_argument("--single_res", action="store_true")
    p.add_argument("--conv_type", default="conv", choices=["conv", "deconv", "bilinear"])
    p.add_argument(
        "--branch_type",
        default="NeRV_vanilla",
        choices=["NeRV_vanilla", "ERB", "ACB", "RepVGG", "DBB", "ECB"],
    )

    # training
    p.add_argument("-j", "--workers", type=int, default=4)  # no-op (no workers)
    p.add_argument("-b", "--batchSize", type=int, default=1)
    p.add_argument("--not_resume_epoch", action="store_true")
    p.add_argument("-e", "--epochs", type=int, default=150)
    p.add_argument("--warmup", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_type", type=str, default="cosine")
    p.add_argument("--lr_steps", default=[], type=float, nargs="+")
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--loss_type", "--loss", dest="loss_type", type=str, default="L2")
    p.add_argument("--lw", type=float, default=1.0)
    p.add_argument("--sigmoid", action="store_true")

    # evaluation / compression
    p.add_argument("--deploy", action="store_true", default=False)
    p.add_argument("--eval_only", action="store_true", default=False)
    p.add_argument("--eval_freq", type=int, default=50)
    p.add_argument("--ckpt_freq", type=int, default=1, help="epochs between checkpoint writes")
    p.add_argument("--quant_bit", type=int, default=-1)
    p.add_argument("--quant_axis", type=int, default=0)
    p.add_argument("--dump_images", action="store_true", default=False)
    p.add_argument("--eval_fps", action="store_true", default=False)
    p.add_argument("--prune_steps", type=float, nargs="+", default=[0.0])
    p.add_argument("--prune_ratio", type=float, default=1.0)
    p.add_argument("--dump_gt", action="store_true", default=False,
                   help="also dump gt_{n}.png (commented out in the reference)")
    if eval_mode:
        p.add_argument("--finetune", action="store_true", default=False)
        p.add_argument("--finetune_epochs", type=int, default=100)
        p.add_argument(
            "--finetune_lr_mode", default="fresh", choices=["fresh", "reference"],
            help="'reference' continues the stale cosine past its end "
            "(lr~0, main_eval.py:447,472) for exact A/B parity",
        )
        p.add_argument(
            "--qat", action="store_true", default=False,
            help="quantization-aware finetune: train through the fake "
            "quantizer so post-finetune quantization is (near-)lossless; "
            "reparam branches deploy before the finetune (compress/qat.py)",
        )

    # distributed (flags kept for argv compatibility)
    p.add_argument("--manualSeed", type=int, default=1)
    p.add_argument("--init_method", default="tcp://127.0.0.1:9888", type=str)
    p.add_argument("-d", "--distributed", action="store_true", default=False)
    p.add_argument("--mesh_shape", type=int, nargs="*", default=[])
    p.add_argument("--mesh_axes", type=str, nargs="*", default=["data"])

    # logging / output
    p.add_argument("--debug", action="store_true")
    p.add_argument("-p", "--print_freq", default=50, type=int)
    p.add_argument("--weight", default="None", type=str)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--outf", default="unify")
    p.add_argument("--suffix", default="")

    # knobs with no reference counterpart
    p.add_argument(
        "--lr_frac_mode", default="batch", choices=["batch", "sample"],
        help="'sample' reproduces the reference adjust_lr denominator at b>1",
    )
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16", "mixed"])
    p.add_argument("--no_online_fuse", action="store_true")
    p.add_argument("--no_pallas_decode", action="store_true")
    p.add_argument("--no_pallas_train", action="store_true",
                   help="disable the fused Pallas training forward for "
                   "trailing stages (b=1 step speed, train_tail.py)")
    p.add_argument(
        "--codec", default="huffman", choices=["huffman", "rans"],
        help="entropy coder for BPP accounting: huffman (reference parity) "
        "or rans (fractional-bit, ~0.3%% smaller BPP measured)",
    )
    p.add_argument(
        "--save_bitstream", action="store_true",
        help="write the entropy-coded model artifact (.rnvb), verify its "
        "decode bit-exactly, and report the all-in BPP (file bytes incl. "
        "codec table/qparams/sparsity map) next to the symbol-only BPP",
    )
    p.add_argument(
        "--decode_int8", action="store_true",
        help="int8 MXU decode for the trailing blocks (measured +40%% fps "
        "at -0.15 dB); scales calibrated from the first val frames",
    )
    p.add_argument(
        "--int8_from_block", type=int, default=-2,
        help="first int8 block, counted from the end (-1 = last block only, "
        "-3 = last three); trades decode fps against quantization error",
    )
    p.add_argument(
        "--recover_drop_db", type=float, default=6.0,
        help="in-run divergence guard: restore the best snapshot (fresh "
        "optimizer) when an epoch's train PSNR falls this many dB below "
        "the running best, or is NaN; <= 0 disables (train/recovery.py)",
    )
    p.add_argument(
        "--max_recoveries", type=int, default=3,
        help="retry budget of the in-run divergence guard",
    )
    p.add_argument("--remat", action="store_true", help="rematerialize block activations in backward")
    p.add_argument("--profile", action="store_true", help="capture a JAX profiler trace of epoch 1")
    return p


def args_to_config(a: argparse.Namespace, eval_mode: bool = False) -> TrainConfig:
    model = ModelConfig(
        embed=a.embed,
        stem_dim_num=a.stem_dim_num,
        fc_hw_dim=a.fc_hw_dim,
        expansion=a.expansion,
        reduction=a.reduction,
        strides=tuple(a.strides),
        num_blocks=a.num_blocks,
        lower_width=a.lower_width,
        norm=a.norm,
        act=a.act,
        bias=True,
        single_res=a.single_res,
        sigmoid=a.sigmoid,
        branch_type=a.branch_type,
        deploy=a.deploy,
        conv_type=a.conv_type,
        compute_dtype=a.compute_dtype,
        online_fuse=not a.no_online_fuse,
        use_pallas_decode=not a.no_pallas_decode,
        use_pallas_train=not getattr(a, "no_pallas_train", False),
        decode_int8=getattr(a, "decode_int8", False),
        int8_from_block=getattr(a, "int8_from_block", -2),
        remat=a.remat,
    )
    data = DataConfig(
        dataset=a.dataset,
        data_dir=a.data_dir,
        vid=None if a.vid == [None] or None in a.vid else tuple(a.vid),
        frame_gap=a.frame_gap,
        test_gap=a.test_gap,
        batch_size=a.batchSize,
        synthetic_frames=a.synthetic_frames,
        synthetic_hw=tuple(a.synthetic_hw),
        content_seed=a.content_seed,
        content_motion=getattr(a, "content_motion", "normal"),
        hbm_budget_mb=a.hbm_budget_mb,
        host_budget_mb=a.host_budget_mb,
        stream_chunk_mb=a.stream_chunk_mb,
    )
    return TrainConfig(
        model=model,
        data=data,
        epochs=a.epochs,
        warmup=a.warmup,
        lr=a.lr,
        lr_type=a.lr_type,
        lr_steps=tuple(a.lr_steps),
        beta=a.beta,
        loss_type=a.loss_type,
        lw=a.lw,
        eval_freq=1 if a.debug else a.eval_freq,
        ckpt_freq=a.ckpt_freq,
        eval_fps=a.eval_fps,
        manual_seed=a.manualSeed,
        print_freq=a.print_freq,
        debug=a.debug,
        outf="result/debug" if a.debug else f"result/{a.outf}",
        suffix=a.suffix,
        overwrite=a.overwrite,
        weight=a.weight,
        prune_ratio=a.prune_ratio,
        prune_steps=tuple(a.prune_steps),
        quant_bit=a.quant_bit,
        quant_axis=a.quant_axis,
        finetune=getattr(a, "finetune", False),
        finetune_epochs=getattr(a, "finetune_epochs", 100),
        finetune_lr_mode=getattr(a, "finetune_lr_mode", "fresh"),
        finetune_qat=getattr(a, "qat", False),
        codec=getattr(a, "codec", "huffman"),
        save_bitstream=getattr(a, "save_bitstream", False),
        lr_frac_mode=a.lr_frac_mode,
        dump_images=a.dump_images,
        dump_gt=a.dump_gt,
        recover_drop_db=getattr(a, "recover_drop_db", 6.0),
        max_recoveries=getattr(a, "max_recoveries", 3),
        mesh_shape=tuple(a.mesh_shape),
        mesh_axes=tuple(a.mesh_axes),
        profile=a.profile,
    )


def exp_id(cfg: TrainConfig) -> str:
    """Experiment-id string (reference main_train.py:122-138 structure)."""
    a = cfg
    m = cfg.model
    prune_str = (
        f"_Prune{a.prune_ratio}_{','.join(str(x) for x in a.prune_steps)}"
        if a.prune_ratio < 1
        else ""
    )
    extra = "_Strd{}_{}Res".format(
        ",".join(str(x) for x in m.strides),
        "Sin" if m.single_res else f"_lw{a.lw}_multi",
    )
    norm_str = "" if m.norm == "none" else m.norm
    return (
        f"{a.data.dataset}/embed{m.embed}_{m.stem_dim_num}_fc_{m.fc_hw_dim}"
        f"__exp{m.expansion}_reduce{m.reduction}_low{m.lower_width}_blk{m.num_blocks}"
        f"_gap{a.data.frame_gap}_e{a.epochs}_warm{a.warmup_epochs()}_b{a.data.batch_size}"
        f"_{m.conv_type}_lr{a.lr}_{a.lr_type}_{a.loss_type}{norm_str}{extra}{prune_str}"
        f"_act{m.act}_{a.suffix}"
    )
