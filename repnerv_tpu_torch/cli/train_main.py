"""Train CLI, argv-compatible with the JAX package's (port of
``repnerv_tpu/cli/train_main.py``).

    python -m repnerv_tpu_torch.cli.train_main --dataset synth \\
        --synthetic_frames 16 --synthetic_hw 720 1280 --embed 1.25_40 \\
        --stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 \\
        --strides 5 2 2 2 2 --lower_width 96 --branch_type ERB --act swish \\
        --single_res --loss Fusion6 -b 1 --lr 5e-4 -e 2 \\
        --compute_dtype bfloat16 [--device cuda]

Per epoch: train over the device-resident video, log PSNR / MS-SSIM to
stdout and ``rank0.txt`` in the JAX package's line format, evaluate at
``eval_freq`` and over the last 10 epochs, keep the divergence guard, and at
``ckpt_freq`` write ``model_latest.pth`` (+ train / val best) and, for
reparam branches, the deploy-state ``model_latest_deploy.pth``, plus the
resume file that a rerun with the same output directory picks up.

Flags of later slices are refused with the ROADMAP row that ports them:
``--mesh_shape`` (A8), ``--profile`` (the JAX profiler), ``--compute_dtype
mixed`` (A1), ``--host_budget_mb`` (A7, out-of-core).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
from datetime import datetime

import numpy as np
import torch

from ..config import TrainConfig
from ..data.frames import make_frame_store
from ..models.generator import generator_to_deploy, param_count
from ..ops.metrics import round_tensor
from ..train import checkpoint as ckpt
from ..train.loop import (
    evaluate,
    init_train_state,
    make_eval_step,
    make_train_step,
    measure_decode_fps,
    run_epoch,
)
from ..train.recovery import DivergenceGuard, snapshot
from ..utils.costs import generator_macs
from .args import args_to_config, build_parser, exp_id


def log_line(outf: str, rank: int, msg: str):
    print(msg, flush=True)
    with open(os.path.join(outf, f"rank{rank}.txt"), "a") as f:
        f.write(msg + "\n")


def deploy_state(model, state=None) -> dict:
    """The deploy-state tensors of ``model``, or of ``model`` holding
    ``state`` (a snapshot); ``model`` itself is left as it is."""
    if state is not None:
        model = copy.deepcopy(model)
        model.load_state_dict(state)
    return generator_to_deploy(model).state_dict()


def run_training(cfg: TrainConfig, device="cuda") -> dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type == "cuda":
        # full-f32 convs and matmuls: TF32 would move f32 training by ~1e-3
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    outf = os.path.join(cfg.outf, cfg.suffix) if cfg.suffix else cfg.outf
    if cfg.overwrite and os.path.isdir(outf):
        shutil.rmtree(outf)
    os.makedirs(outf, exist_ok=True)
    with open(os.path.join(outf, "config.json"), "w") as f:
        f.write(cfg.to_json())

    store = make_frame_store(cfg.data, device, split="train")
    # train and val share the pixels on the device; only the gap differs
    val_store = dataclasses.replace(store, frame_gap=cfg.data.test_gap)
    steps_per_epoch = max(store.num_samples // cfg.data.batch_size, 1)

    state = init_train_state(cfg, device)
    start_epoch = 0
    if cfg.weight not in ("None", "", None):
        weights, _ = ckpt.load_pth(cfg.weight)
        ckpt.load_state(state.model, weights)
        print(f"initialized weights from {cfg.weight}")
    if os.path.exists(os.path.join(outf, ckpt.RESUME_FILE)) and not cfg.overwrite:
        state.step, start_epoch = ckpt.load_resume(outf, state.model, state.optimizer)
        print(f"resumed from epoch {start_epoch}")

    n_params = param_count(state.model)
    log_line(outf, 0, f"{exp_id(cfg)}\nModel Params: {n_params / 1e6}M")
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(outf, f"param_{n_params / 1e6}M", "tensorboard"))
    except ImportError:  # tensorboard is optional
        writer = None

    with_msssim = min(store.hw) > 160
    train_step = make_train_step(cfg, steps_per_epoch, with_msssim=with_msssim)
    eval_step = make_eval_step(cfg, with_msssim=with_msssim)
    guard = DivergenceGuard(cfg, log=lambda msg: log_line(outf, 0, msg))
    pending_train_best = pending_val_best = None  # (on-device state, extra)
    bests = {
        "train_best_psnr": 0.0,
        "train_best_msssim": 0.0,
        "val_best_psnr": 0.0,
        "val_best_msssim": 0.0,
    }
    history = []
    start = datetime.now()
    max_steps = 10 if cfg.debug else None
    reparam = cfg.model.branch_type != "NeRV_vanilla" and not cfg.model.deploy
    macs = generator_macs(cfg.model, deploy=cfg.model.deploy)["macs"]
    log_line(outf, 0, f"MACs: {macs / 1e9:.2f}G")

    for epoch in range(start_epoch, cfg.epochs):
        ep_start = datetime.now()
        state, m = run_epoch(state, train_step, store, cfg, epoch, max_steps=max_steps)
        state, _ = guard.observe(epoch, float(m.psnr[-1]), state)
        history.append({"epoch": epoch + 1, "loss": m.loss, "lr": m.lr,
                        "psnr": m.psnr.tolist(), "msssim": m.msssim.tolist()})
        is_train_best = m.psnr[-1] > bests["train_best_psnr"]
        bests["train_best_psnr"] = max(bests["train_best_psnr"], float(m.psnr[-1]))
        bests["train_best_msssim"] = max(bests["train_best_msssim"], float(m.msssim[-1]))
        if writer is not None:
            h, w = [d * int(np.prod(cfg.model.strides)) for d in cfg.model.fc_hwd[:2]]
            tag = f"{h}X{w}_gap{cfg.data.frame_gap}"
            writer.add_scalar(f"Train/PSNR_{tag}", float(m.psnr[-1]), epoch + 1)
            writer.add_scalar(f"Train/MSSSIM_{tag}", float(m.msssim[-1]), epoch + 1)
            writer.add_scalar(f"Train/best_PSNR_{tag}", bests["train_best_psnr"], epoch + 1)
            writer.add_scalar(f"Train/best_MSSSIM_{tag}", bests["train_best_msssim"], epoch + 1)
            writer.add_scalar("Train/lr", m.lr, epoch + 1)
        ep_s = (datetime.now() - ep_start).total_seconds()
        avg_s = (datetime.now() - start).total_seconds() / (epoch + 1 - start_epoch)
        log_line(
            outf,
            0,
            f"[{datetime.now():%Y/%m/%d %H:%M:%S}] Epoch[{epoch + 1}/{cfg.epochs}] "
            f"lr:{m.lr:.2e} PSNR: {round_tensor(m.psnr, 2)} "
            f"MSSSIM: {round_tensor(m.msssim, 4)} "
            f"Time/epoch: Current:{ep_s:.2f} Average:{avg_s:.2f}",
        )

        extra = {"epoch": epoch + 1, **bests}
        if is_train_best:
            pending_train_best = (snapshot(state.model), extra)
        save_now = (epoch + 1) % cfg.ckpt_freq == 0 or epoch == cfg.epochs - 1
        if (epoch + 1) % cfg.eval_freq == 0 or epoch > cfg.epochs - 10:
            val_psnr, val_msssim = evaluate(
                state.model, eval_step, val_store, cfg, max_steps=max_steps
            )
            if cfg.eval_fps:
                n_frames = val_store.num_samples if max_steps is None else min(
                    val_store.num_samples, max_steps * cfg.data.batch_size
                )
                bsz = min(cfg.data.batch_size, n_frames)
                t_val = val_store.t[val_store.sample_indices()[:n_frames]]
                state.model.eval()
                try:
                    fps = measure_decode_fps(state.model, cfg, t_val, bsz)
                finally:
                    state.model.train()
                log_line(outf, 0, f"FPS: {fps:.2f}")
            is_val_best = val_psnr[-1] > bests["val_best_psnr"]
            bests["val_best_psnr"] = max(bests["val_best_psnr"], float(val_psnr[-1]))
            bests["val_best_msssim"] = max(bests["val_best_msssim"], float(val_msssim[-1]))
            if writer is not None:
                writer.add_scalar("Val/PSNR", float(val_psnr[-1]), epoch + 1)
                writer.add_scalar("Val/MSSSIM", float(val_msssim[-1]), epoch + 1)
                writer.add_scalar("Val/best_PSNR", bests["val_best_psnr"], epoch + 1)
                writer.add_scalar("Val/best_MSSSIM", bests["val_best_msssim"], epoch + 1)
            log_line(
                outf,
                0,
                f"Eval at epoch {epoch + 1}: PSNR {round_tensor(val_psnr, 2)} "
                f"MSSSIM {round_tensor(val_msssim, 4)}",
            )
            if is_val_best:
                pending_val_best = (snapshot(state.model), extra)

        if not save_now:
            continue
        ckpt.save_pth(os.path.join(outf, "model_latest.pth"), state.model.state_dict(), extra)
        if pending_train_best is not None:
            ckpt.save_pth(os.path.join(outf, "model_train_best.pth"), *pending_train_best)
        if pending_val_best is not None:
            ckpt.save_pth(os.path.join(outf, "model_val_best.pth"), *pending_val_best)
            pending_val_best = None
        if reparam:
            # the deploy snapshot is a fused copy; training goes on with the branches
            ckpt.save_pth(os.path.join(outf, "model_latest_deploy.pth"),
                          deploy_state(state.model), extra)
            if pending_train_best is not None:
                best, bextra = pending_train_best
                ckpt.save_pth(os.path.join(outf, "model_train_best_deploy.pth"),
                              deploy_state(state.model, best), bextra)
        pending_train_best = None
        ckpt.save_resume(outf, state.model, state.optimizer, state.step, epoch + 1)

    state, restored = guard.finalize(state)
    if restored:
        # the final checkpoint boundary wrote a collapsed model_latest:
        # supersede it with the restored endpoint
        final_extra = {"epoch": cfg.epochs, **bests}
        ckpt.save_pth(os.path.join(outf, "model_latest.pth"), state.model.state_dict(),
                      final_extra)
        if reparam:
            ckpt.save_pth(os.path.join(outf, "model_latest_deploy.pth"),
                          deploy_state(state.model), final_extra)
    if reparam:
        dep = generator_to_deploy(state.model)
        log_line(outf, 0, f"Deploy Rep-Model Params: {param_count(dep) / 1e6:.3f}M")
    log_line(outf, 0, f"Training complete in: {datetime.now() - start}")
    return {"outf": outf, "bests": bests, "params_m": n_params / 1e6, "history": history,
            "state": state}


# flags of later slices -> the ROADMAP row that ports them
def _refusal(a) -> str:
    if a.mesh_shape:
        return "--mesh_shape is not ported yet (ROADMAP A8: multi-GPU)"
    if a.profile:
        return "--profile is the JAX profiler's and is not ported"
    if a.compute_dtype == "mixed":
        return "--compute_dtype mixed is not ported for training yet (ROADMAP A1)"
    if a.host_budget_mb:
        return "--host_budget_mb (out-of-core frames) is not ported yet (ROADMAP A7)"
    if a.dataset in ("photo", "corpus"):
        return f"--dataset {a.dataset} is not ported yet (ROADMAP A7)"
    return ""


def main(argv=None) -> dict:
    parser = build_parser(eval_mode=False)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    a = parser.parse_args(argv)
    refused = _refusal(a)
    if refused:
        parser.error(refused)
    return run_training(args_to_config(a, eval_mode=False), a.device)


if __name__ == "__main__":
    main()
