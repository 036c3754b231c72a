"""Eval / compress CLI, argv-compatible with the JAX package's (port of
``repnerv_tpu/cli/eval_main.py``, itself the reference main_eval.py's).

    python -m repnerv_tpu_torch.cli.eval_main <the train CLI's flags> \\
        --prune_ratio 0.2 --quant_bit 8 [--finetune --finetune_epochs N [--qat]] \\
        [--save_bitstream] [--decode_int8] [--dump_images [--dump_gt]] \\
        [--rd_sweep ...] [--device cuda]

Loads the checkpoint the branch / finetune combination calls for from the
train CLI's output directory, runs prune -> [finetune / QAT] -> deploy ->
quantize -> Huffman or rANS (``compress/pipeline.py``), verifies a written
``.rnvb`` bit-exactly against the evaluated weights, calibrates the int8
decode with ``--decode_int8``, then measures PSNR / MS-SSIM over the
validation frames, the whole-video decode fps and the single-frame fps (on
the card only: a measurement without a card fails), dumps predictions, and
appends the JAX package's result lines to the result file it names.
``--rd_sweep`` runs the PATH-B rate-distortion grid and writes
``rd_sweep.json``.

Flags of later slices are refused with the ROADMAP row that ports them:
``--mesh_shape`` (A8), ``--host_budget_mb`` and ``--dataset photo|corpus``
(A7), ``--finetune`` with ``--compute_dtype mixed`` (A1).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..compress.bitstream import read_bitstream
from ..compress.pipeline import (
    CompressionReport,
    compress,
    model_state,
    prune_params,
    quantize_params,
)
from ..config import TrainConfig
from ..data.frames import make_frame_store
from ..models.embedding import positional_encoding
from ..models.generator import Generator, calibrate_int8
from ..ops.metrics import round_tensor
from ..train import checkpoint as ckpt
from ..train.loop import (
    decode_batch_cap,
    evaluate,
    make_decode_fn,
    make_eval_step,
    measure_decode_fps,
)
from ..utils.costs import generator_macs
from .args import args_to_config, build_parser


def select_checkpoint(cfg: TrainConfig, outf: str, qat: bool = False):
    """The JAX package's ``_select_checkpoint``: reparam branches load the
    deploy state except on the finetune PATH A (QAT finetunes the deploy
    tensors, so it loads deploy too).  Returns (path, load_cfg)."""
    reparam = cfg.model.branch_type != "NeRV_vanilla"
    if reparam and (not cfg.finetune or qat):
        path = os.path.join(outf, "model_latest_deploy.pth")
        load_cfg = dataclasses.replace(cfg.model, deploy=True)
    else:
        path = os.path.join(outf, "model_latest.pth")
        load_cfg = dataclasses.replace(cfg.model, deploy=False)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return path, load_cfg


def load_model(path: str, load_cfg, device) -> tuple:
    state, extra = ckpt.load_pth(path)
    return ckpt.load_state(Generator(load_cfg, device=device), state), extra


def measure_micro_fps(model: Generator, cfg: TrainConfig, t_one: torch.Tensor,
                      warmup: int = 5, reps: int = 50) -> float:
    """Single-frame decode rate on the card (reference main_eval.py:767-784:
    5 warm-up and 50 timed one-frame forwards), each ended by a
    synchronize: a latency surface, where ``measure_decode_fps`` is the
    throughput one.  Without a card it fails instead of timing the CPU."""
    if t_one.device.type != "cuda":
        raise RuntimeError(f"decode fps is measured on a CUDA device, not {t_one.device}")
    decode = make_decode_fn(cfg)
    for _ in range(warmup):
        decode(model, t_one)
    torch.cuda.synchronize(t_one.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        decode(model, t_one)
        torch.cuda.synchronize(t_one.device)
    return reps / (time.perf_counter() - t0)


def _stores(cfg: TrainConfig, device):
    store = make_frame_store(cfg.data, device, split="train")
    # train (finetune) and val sample the same pixels; only the gap differs
    return store, dataclasses.replace(store, frame_gap=cfg.data.test_gap)


def run_eval(cfg: TrainConfig, device="cuda") -> dict:
    device = _device(device)
    outf = os.path.join(cfg.outf, cfg.suffix) if cfg.suffix else cfg.outf
    store, val_store = _stores(cfg, device)

    reparam = cfg.model.branch_type != "NeRV_vanilla"
    qat = cfg.finetune and cfg.finetune_qat and cfg.quant_bit != -1
    path, load_cfg = select_checkpoint(cfg, outf, qat)
    model, extra = load_model(path, load_cfg, device)
    print(f"loaded {path} (branch={cfg.model.branch_type}, deploy={load_cfg.deploy})")

    work_cfg = dataclasses.replace(cfg, model=load_cfg)
    bitstream_path = (
        os.path.join(outf, f"model_pr{cfg.prune_ratio:.2f}_q{cfg.quant_bit}.rnvb")
        if cfg.save_bitstream and cfg.quant_bit != -1
        else None
    )
    model, report = compress(
        model,
        work_cfg,
        store,
        max_steps_per_epoch=10 if cfg.debug else None,
        start_epoch=int(extra.get("epoch", cfg.epochs)),
        bitstream_path=bitstream_path,
    )
    if bitstream_path:
        # the artifact must reproduce the evaluated weights bit-exactly
        loaded, _, _ = read_bitstream(bitstream_path)
        state = model_state(model)
        if list(loaded) != list(state) or not all(
            np.array_equal(loaded[k], state[k]) for k in state
        ):
            raise AssertionError("bitstream decode does not match the evaluated weights")
        acct = report.extras["bitstream"]
        print(
            f"bitstream: {bitstream_path} ({int(acct['file_bytes'])} bytes; "
            f"payload {int(acct['payload_bits'])} bits, header "
            f"{int(acct['header_bytes'])} B, qparams {int(acct['qparams_bytes'])} B, "
            f"sparsity map {int(acct['bitmap_bytes'])} B); decode verified "
            f"bit-exact; all-in BPP {acct.get('bpp_all_in', 0.0):.6f} vs "
            f"symbol-only {report.bpp:.6f}"
        )
    final_cfg = dataclasses.replace(cfg.model, deploy=reparam or load_cfg.deploy)
    if not reparam:
        final_cfg = load_cfg
    model.cfg = final_cfg

    if final_cfg.decode_int8 and (reparam or final_cfg.deploy):
        # int8 scales from the first val frames: the PSNR / MS-SSIM below
        # are then the int8 decode's
        calib_rows = val_store.sample_indices()[:8]
        calib_t = torch.from_numpy(np.asarray(val_store.t[calib_rows], np.float32)).to(device)
        model = calibrate_int8(model, positional_encoding(calib_t, final_cfg.embed))
        if model.int8:
            print(f"int8 decode calibrated over {len(calib_rows)} frames")
        else:
            print(
                "WARNING: int8 calibration skipped (unsupported head layout "
                f"or int8_from_block={final_cfg.int8_from_block} out of "
                "range); measurements below use the non-int8 decode path"
            )

    eval_cfg = dataclasses.replace(cfg, model=final_cfg)
    eval_step = make_eval_step(eval_cfg, with_msssim=min(val_store.hw) > 160)
    val_psnr, val_msssim = evaluate(
        model, eval_step, val_store, eval_cfg, max_steps=10 if cfg.debug else None
    )

    bsz = decode_batch_cap(*val_store.hw, base=max(cfg.data.batch_size, 8))
    rows = val_store.sample_indices()
    fps = measure_decode_fps(model, eval_cfg, val_store.t[rows], bsz)
    t_one = torch.from_numpy(np.asarray(val_store.t[rows[:1]], np.float32)).to(device)
    micro_fps = measure_micro_fps(model, eval_cfg, t_one)
    print(f"[first val frame] FPS: {micro_fps:.2f}")

    if cfg.dump_images:
        from PIL import Image

        vis = os.path.join(outf, "visualize")
        os.makedirs(vis, exist_ok=True)
        print(f"Saving predictions to {vis}")
        # every val frame, batched, global indices pred_{i*B+b}.png
        decode = make_decode_fn(eval_cfg)
        for i0 in range(0, len(rows), bsz):
            chunk = rows[i0 : i0 + bsz]
            t = np.pad(np.asarray(val_store.t[chunk], np.float32), (0, bsz - len(chunk)),
                       mode="edge")
            out = decode(model, torch.from_numpy(t).to(device))
            arr = np.clip(out[: len(chunk)].cpu().numpy() * 255, 0, 255).astype(np.uint8)
            for b in range(len(chunk)):
                Image.fromarray(arr[b]).save(os.path.join(vis, f"pred_{i0 + b}.png"))
                if cfg.dump_gt:
                    gt = val_store.frames[int(chunk[b])].cpu().numpy()
                    Image.fromarray(gt).save(os.path.join(vis, f"gt_{i0 + b}.png"))

    costs = generator_macs(final_cfg, deploy=final_cfg.deploy)
    print(f"MACs: {costs['macs'] / 1e9:.3f} G, FLOPs: {costs['flops'] / 1e9:.3f} G")

    result = {
        "macs_g": costs["macs"] / 1e9,
        "val_psnr": [float(x) for x in val_psnr],
        "val_msssim": [float(x) for x in val_msssim],
        "fps": fps,
        "micro_fps": micro_fps,
        "prune_ratio": report.prune_ratio_actual,
        "quant_bit": report.quant_bit,
        "avg_bits": report.avg_bits,
        "efficiency": report.efficiency,
        "bpp": report.bpp,
    }
    if "bitstream" in report.extras:
        result["bitstream_bytes"] = report.extras["bitstream"]["file_bytes"]
        result["bpp_all_in"] = report.extras["bitstream"].get("bpp_all_in", 0.0)
    qb = cfg.quant_bit
    fname = (
        f"finetune{'_qat' if qat else ''}_e{cfg.finetune_epochs}_pr{cfg.prune_ratio:.2f}"
        f"_q{qb if qb != -1 else 'none'}.txt"
        if cfg.finetune
        else f"only_prune{cfg.prune_ratio:.2f}_quant{qb if qb > 0 else 'full'}.txt"
    )
    msg = (
        f"PSNR: {round_tensor(val_psnr, 2)}, MSSSIM: {round_tensor(val_msssim, 4)} "
        f"FPS: {fps:.2f} BPP: {report.bpp:.6f} "
        f"Entropy encoding efficiency for bit {qb}: {report.efficiency}"
    )
    print(msg)
    os.makedirs(outf, exist_ok=True)
    with open(os.path.join(outf, fname), "a") as f:
        f.write(msg + "\n" + json.dumps(result) + "\n")
    return result


def run_rd_sweep(cfg: TrainConfig, prune_ratios, quant_bits, device="cuda") -> dict:
    """The PATH-B rate-distortion grid in one command: the checkpoint loads
    once, each prune ratio prunes once and every bit width quantizes the same
    pruned weights.  Results land in ``<outf>/rd_sweep.json``."""
    device = _device(device)
    outf = os.path.join(cfg.outf, cfg.suffix) if cfg.suffix else cfg.outf
    store, val_store = _stores(cfg, device)
    # PATH B per point: the --finetune flag does not choose the checkpoint
    path, load_cfg = select_checkpoint(dataclasses.replace(cfg, finetune=False), outf)
    base, _ = load_model(path, load_cfg, device)
    print(f"rd_sweep: loaded {path}")

    eval_cfg = dataclasses.replace(cfg, model=load_cfg)
    eval_step = make_eval_step(eval_cfg, with_msssim=min(val_store.hw) > 160)
    n = store.frames.shape[0]
    max_steps = 10 if cfg.debug else None
    rows = []
    for pr in prune_ratios:
        pcfg = dataclasses.replace(eval_cfg, prune_ratio=pr, finetune=False)
        report = CompressionReport()
        pruned, _ = prune_params(copy.deepcopy(base), pcfg, report)
        pr_actual = report.prune_ratio_actual
        for bit in quant_bits:
            qcfg = dataclasses.replace(pcfg, quant_bit=bit)
            qreport = CompressionReport()
            qreport.prune_ratio_actual = pr_actual
            model = quantize_params(copy.deepcopy(pruned), qcfg, qreport, frame_hw=store.hw,
                                    n_frames=n)
            psnr, msssim = evaluate(model, eval_step, val_store, eval_cfg, max_steps=max_steps)
            row = {
                "prune_ratio": pr,
                "prune_actual": pr_actual,
                "quant_bit": bit,
                "psnr": float(psnr[-1]),
                "msssim": float(msssim[-1]),
                "bpp": qreport.bpp,
                "efficiency": qreport.efficiency,
            }
            rows.append(row)
            print(
                f"prune {pr:.2f} quant {bit:2d}: PSNR {row['psnr']:.2f} "
                f"MS-SSIM {row['msssim']:.4f} BPP {row['bpp']:.4f}"
            )
    result = {"rows": rows, "checkpoint": path}
    os.makedirs(outf, exist_ok=True)
    with open(os.path.join(outf, "rd_sweep.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type == "cuda":
        # full-f32 convs and matmuls: TF32 would move f32 quality by ~1e-3
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


# flags of later slices -> the ROADMAP row that ports them
def _refusal(a) -> str:
    if a.mesh_shape:
        return "--mesh_shape is not ported yet (ROADMAP A8: multi-GPU)"
    if a.host_budget_mb:
        return "--host_budget_mb (out-of-core frames) is not ported yet (ROADMAP A7)"
    if a.dataset in ("photo", "corpus"):
        return f"--dataset {a.dataset} is not ported yet (ROADMAP A7)"
    if a.finetune and a.compute_dtype == "mixed":
        return "--finetune with --compute_dtype mixed is not ported yet (ROADMAP A1)"
    return ""


def main(argv=None):
    parser = build_parser(eval_mode=True)
    parser.add_argument(
        "--rd_sweep", action="store_true", default=False,
        help="rate-distortion grid in one command: PATH-B quality/BPP over "
        "--rd_prune_ratios x --rd_quant_bits",
    )
    parser.add_argument("--rd_prune_ratios", type=float, nargs="+", default=[1.0, 0.2, 0.4])
    parser.add_argument("--rd_quant_bits", type=int, nargs="+", default=[8, 6, 5, 4])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    a = parser.parse_args(argv)
    refused = _refusal(a)
    if refused:
        parser.error(refused)
    cfg = args_to_config(a, eval_mode=True)
    if a.rd_sweep:
        return run_rd_sweep(cfg, a.rd_prune_ratios, a.rd_quant_bits, a.device)
    return run_eval(cfg, a.device)


if __name__ == "__main__":
    main()
