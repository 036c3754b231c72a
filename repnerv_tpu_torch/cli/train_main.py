"""Train CLI, argv-compatible with the JAX package's (port of
``repnerv_tpu/cli/train_main.py``).

    python -m repnerv_tpu_torch.cli.train_main --dataset synth \\
        --synthetic_frames 16 --synthetic_hw 720 1280 --embed 1.25_40 \\
        --stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 \\
        --strides 5 2 2 2 2 --lower_width 96 --branch_type ERB --act swish \\
        --single_res --loss Fusion6 -b 1 --lr 5e-4 -e 2 \\
        --compute_dtype bfloat16 [--device cuda]

Per epoch: train over the video (with ``fused_epoch``, the default as in
the JAX package: ``make_epoch_fn`` / ``run_fused_epoch``, one CUDA graph
replay per step on the card, or ``make_streaming_epoch_fn`` when the video
is on the host or on disk, over ``--hbm_budget_mb`` or a frame directory over
``--host_budget_mb``; else ``run_epoch``'s eager steps), log PSNR / MS-SSIM to
stdout and ``rank0.txt`` in the JAX package's line format, evaluate at
``eval_freq`` and over the last 10 epochs, keep the divergence guard, and at
``ckpt_freq`` write ``model_latest.pth`` (+ train / val best) and, for
reparam branches, the deploy-state ``model_latest_deploy.pth``, plus the
resume file that a rerun with the same output directory picks up.

``--mesh_shape N`` trains data-parallel over N ranks of a
``torch.distributed`` world (``parallel/sharding.py``), started by
``torchrun --nproc_per_node N -m repnerv_tpu_torch.cli.train_main ...`` (N = 1
needs no torchrun: a world of one in the process); ``--mesh_shape D M
--mesh_axes data model`` adds tensor parallelism over M ranks of a model
axis, each rank training its shards of the model, and ``--norm bn`` takes
the global batch's statistics over the data ranks.  The fused epoch runs
when the batch divides by the data axis, else the per-step path; a video on
the host trains per step under a mesh; a model axis or ``--norm bn`` over
data ranks trains through the eager step (their collectives are not
captured).  Only rank 0 writes ``rank0.txt``, checkpoints and ``.pth``
files, in the plain layout: under a model axis every rank first joins the
gather of the shards, so a checkpoint of either kind resumes in the other.
Every rank evaluates the same frames, under a model axis on the whole
model gathered once per evaluation.

``--stop_epoch N`` (the port's own flag) trains the first N epochs of the
``-e`` schedule and stops with a checkpoint: the learning rates are those of
the whole run, so epoch N's PSNR is the whole run's at N.

``--profile`` (its help says "JAX profiler", the JAX package's words kept)
trains the whole run through the eager step, as the JAX package does, and
traces the first epoch's first 3 steps (10 with ``--debug``) with
``torch.profiler`` (``utils/profiling.py::trace``) into
``<outf>/profile/<host>_<pid>[_rank<r>].<ns>.pt.trace.json``, one file a
rank, which TensorBoard's profiler plugin or ``chrome://tracing`` reads; that
epoch gets no epoch line, evaluation or checkpoint.  On the card the trace
fails the run if the kernels launched and it holds none.
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
from ..parallel import sharding
from ..train import checkpoint as ckpt
from ..train.loop import (
    evaluate,
    init_train_state,
    make_epoch_fn,
    make_eval_step,
    make_streaming_epoch_fn,
    make_train_step,
    measure_decode_fps,
    run_epoch,
    run_fused_epoch,
)
from ..train.recovery import DivergenceGuard, snapshot
from ..utils.costs import generator_macs
from ..utils.profiling import trace
from .args import args_to_config, build_parser, exp_id


def log_line(outf: str, rank: int, msg: str):
    print(msg, flush=True)
    with open(os.path.join(outf, f"rank{rank}.txt"), "a") as f:
        f.write(msg + "\n")


def _silent(outf: str, rank: int, msg: str):
    """log_line of a rank other than 0: it writes nothing."""


def deploy_state(model, state=None) -> dict:
    """The deploy-state tensors of ``model``, or of ``model`` holding
    ``state`` (a snapshot); ``model`` itself is left as it is."""
    if state is not None:
        model = copy.deepcopy(model)
        model.load_state_dict(state)
    return generator_to_deploy(model).state_dict()


def run_training(cfg: TrainConfig, device="cuda", stop_epoch: int = 0) -> dict:
    """Train ``cfg`` on ``device``; with ``stop_epoch`` only up to that epoch
    of the ``cfg.epochs`` schedule (a checkpoint and the resume file at it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type == "cuda":
        # full-f32 convs and matmuls: TF32 would move f32 training by ~1e-3
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None
    if cfg.mesh_shape:
        mesh = sharding.make_mesh(cfg.mesh_shape, cfg.mesh_axes, device)
        device = mesh.device
    try:
        return _train(cfg, device, mesh, stop_epoch or cfg.epochs)
    finally:
        sharding.close_mesh(mesh)


def _train(cfg: TrainConfig, device: torch.device, mesh, stop_epoch: int) -> dict:
    rank0 = mesh is None or mesh.rank == 0
    log = log_line if rank0 else _silent
    outf = os.path.join(cfg.outf, cfg.suffix) if cfg.suffix else cfg.outf
    if rank0:
        if cfg.overwrite and os.path.isdir(outf):
            shutil.rmtree(outf)
        os.makedirs(outf, exist_ok=True)
        with open(os.path.join(outf, "config.json"), "w") as f:
            f.write(cfg.to_json())
    if mesh is not None and mesh.world_size > 1:
        torch.distributed.barrier()  # rank 0 has cleared the directory

    store = make_frame_store(cfg.data, device, split="train")
    # train and val share the pixels; only the gap differs
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
    if mesh is not None:
        # rank 0's values, resumed or from --weight ones included, on every
        # rank; under a model axis each rank keeps its shards
        state = sharding.shard_train_state(state, mesh)
    tp = mesh is not None and mesh.model_size > 1

    def whole(st):
        """The whole state (every rank joins the gather under a model axis)."""
        return sharding.gather_train_state(st, mesh) if tp else st

    eval_gen = None  # the whole model that evaluation runs under a model axis

    def eval_model_of(st):
        """The whole weights, gathered over the model group (every rank joins)."""
        nonlocal eval_gen
        if not tp:
            return st.model
        eval_gen = sharding.gather_model(st.model, mesh, eval_gen)
        return eval_gen

    def whole_weights(snap):
        return sharding.gather_state_dict(snap, state.model.shard_specs, mesh) if tp else snap

    log(outf, 0, f"{exp_id(cfg)}\nModel Params: {n_params / 1e6}M")
    writer = None
    if rank0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(outf, f"param_{n_params / 1e6}M", "tensorboard"))
        except ImportError:  # tensorboard is optional
            pass

    with_msssim = min(store.hw) > 160
    fused = cfg.fused_epoch and not cfg.profile
    if mesh is not None:
        if fused and not store.resident:
            # the streaming epoch is not sharded: a host video gathers per step
            log(outf, 0, "WARNING: video is host-resident (over the HBM budget); "
                "falling back from the fused whole-epoch scan to per-step "
                "dispatch under the mesh")
            fused = False
        if sharding.collective_forward(cfg, mesh):
            why = (f"a model axis of {mesh.model_size}" if tp else
                   f"--norm bn over a data axis of {mesh.data_size}")
            log(outf, 0, f"WARNING: {why} trains through the eager step: the forward's "
                "collectives are not captured in a CUDA graph (ROADMAP A12)")
        if tp:
            log(outf, 0, f"in-train evaluation under a model axis of {mesh.model_size} runs on "
                "the whole model, gathered over the model group once per evaluation")
        if fused and cfg.data.batch_size % mesh.data_size == 0:
            train_step = sharding.make_sharded_epoch_fn(cfg, steps_per_epoch, mesh,
                                                        with_msssim=with_msssim)
        else:
            if fused:
                log(outf, 0, f"WARNING: batch_size {cfg.data.batch_size} is not divisible by "
                    f"the mesh data axis ({mesh.data_size}); falling back from the fused "
                    "whole-epoch scan to per-step dispatch")
            fused = False
            train_step = sharding.make_sharded_train_step(cfg, steps_per_epoch, mesh,
                                                          with_msssim=with_msssim)
        run = run_fused_epoch if fused else run_epoch
    elif fused:
        # one CUDA graph replay per step (the JAX package's one lax.scan
        # dispatch per epoch); a video on the host or on disk streams chunks
        maker = make_epoch_fn if store.resident else make_streaming_epoch_fn
        train_step = maker(cfg, steps_per_epoch, with_msssim=with_msssim)
        run = run_fused_epoch
    else:
        train_step = make_train_step(cfg, steps_per_epoch, with_msssim=with_msssim)
        run = run_epoch
    eval_step = make_eval_step(cfg, with_msssim=with_msssim)
    guard = DivergenceGuard(cfg, log=lambda msg: log(outf, 0, msg))
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
    log(outf, 0, f"MACs: {macs / 1e9:.2f}G")

    for epoch in range(start_epoch, min(stop_epoch, cfg.epochs)):
        ep_start = datetime.now()
        if cfg.profile and epoch == start_epoch:
            # as the JAX package: the first epoch's first steps under the
            # profiler, and no guard, history, epoch line, eval or checkpoint
            with trace(os.path.join(outf, "profile"), device):
                state, _ = run_epoch(state, train_step, store, cfg, epoch,
                                     max_steps=max_steps if max_steps is not None else 3)
            log(outf, 0, f"profiler trace written to {outf}/profile")
            continue
        state, m = run(state, train_step, store, cfg, epoch, max_steps=max_steps)
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
        log(
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
        save_now = (epoch + 1) % cfg.ckpt_freq == 0 or epoch + 1 in (stop_epoch, cfg.epochs)
        if (epoch + 1) % cfg.eval_freq == 0 or epoch > cfg.epochs - 10:
            eval_model = eval_model_of(state)
            val_psnr, val_msssim = evaluate(
                eval_model, eval_step, val_store, cfg, max_steps=max_steps
            )
            if cfg.eval_fps:
                n_frames = val_store.num_samples if max_steps is None else min(
                    val_store.num_samples, max_steps * cfg.data.batch_size
                )
                bsz = min(cfg.data.batch_size, n_frames)
                t_val = val_store.t[val_store.sample_indices()[:n_frames]]
                eval_model.eval()
                try:
                    fps = measure_decode_fps(eval_model, cfg, t_val, bsz)
                finally:
                    eval_model.train()
                log(outf, 0, f"FPS: {fps:.2f}")
            is_val_best = val_psnr[-1] > bests["val_best_psnr"]
            bests["val_best_psnr"] = max(bests["val_best_psnr"], float(val_psnr[-1]))
            bests["val_best_msssim"] = max(bests["val_best_msssim"], float(val_msssim[-1]))
            if writer is not None:
                writer.add_scalar("Val/PSNR", float(val_psnr[-1]), epoch + 1)
                writer.add_scalar("Val/MSSSIM", float(val_msssim[-1]), epoch + 1)
                writer.add_scalar("Val/best_PSNR", bests["val_best_psnr"], epoch + 1)
                writer.add_scalar("Val/best_MSSSIM", bests["val_best_msssim"], epoch + 1)
            log(
                outf,
                0,
                f"Eval at epoch {epoch + 1}: PSNR {round_tensor(val_psnr, 2)} "
                f"MSSSIM {round_tensor(val_msssim, 4)}",
            )
            if is_val_best:
                pending_val_best = (snapshot(state.model), extra)

        if not save_now:
            continue
        full = whole(state)
        train_best = (None if pending_train_best is None else
                      (whole_weights(pending_train_best[0]), pending_train_best[1]))
        val_best = (None if pending_val_best is None else
                    (whole_weights(pending_val_best[0]), pending_val_best[1]))
        pending_train_best = pending_val_best = None
        if not rank0:
            continue
        ckpt.save_pth(os.path.join(outf, "model_latest.pth"), full.model.state_dict(), extra)
        if train_best is not None:
            ckpt.save_pth(os.path.join(outf, "model_train_best.pth"), *train_best)
        if val_best is not None:
            ckpt.save_pth(os.path.join(outf, "model_val_best.pth"), *val_best)
        if reparam:
            # the deploy snapshot is a fused copy; training goes on with the branches
            ckpt.save_pth(os.path.join(outf, "model_latest_deploy.pth"),
                          deploy_state(full.model), extra)
            if train_best is not None:
                ckpt.save_pth(os.path.join(outf, "model_train_best_deploy.pth"),
                              deploy_state(full.model, train_best[0]), train_best[1])
        ckpt.save_resume(outf, full.model, full.optimizer, full.step, epoch + 1)

    state, restored = guard.finalize(state)
    state = whole(state)
    if restored and rank0:
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
        log(outf, 0, f"Deploy Rep-Model Params: {param_count(dep) / 1e6:.3f}M")
    log(outf, 0, f"Training complete in: {datetime.now() - start}")
    return {"outf": outf, "bests": bests, "params_m": n_params / 1e6, "history": history,
            "state": state}


def _refusal(a) -> str:
    """What the flags need that the process does not have: checked before
    anything is written."""
    n = int(np.prod(a.mesh_shape)) if a.mesh_shape else 1
    if n > 1 and sharding.torchrun_env() is None and not torch.distributed.is_initialized():
        return (f"--mesh_shape {' '.join(map(str, a.mesh_shape))} needs {n} processes: "
                f"torchrun --nproc_per_node {n} -m repnerv_tpu_torch.cli.train_main ...")
    return ""


def main(argv=None) -> dict:
    parser = build_parser(eval_mode=False)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument(
        "--stop_epoch", type=int, default=0,
        help="stop after this epoch of the -e schedule (checkpoint and resume file "
        "written there; the same command without the flag resumes to -e)",
    )
    a = parser.parse_args(argv)
    refused = _refusal(a)
    if refused:
        parser.error(refused)
    return run_training(args_to_config(a, eval_mode=False), a.device, a.stop_epoch)


if __name__ == "__main__":
    main()
