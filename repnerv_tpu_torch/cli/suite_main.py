"""Multi-video suite CLI: fit N videos, report a per-video table (port
of ``repnerv_tpu/cli/suite_main.py``).

    python -m repnerv_tpu_torch.cli.suite_main <the train CLI's flags> \\
        --n_videos 7 [--suite_mode sequential|parallel] \\
        [--suite_out results/uvg_suite.json] [--max_refits 2] [--device cuda]

The reference's UVG workflow is one ``main_train.py`` run per video
(reference README.md:63-111).  This CLI fits the whole suite in one
command:

* ``--suite_mode sequential`` (default): one fit after the other through
  the fused epoch, each with its in-run divergence guard;
* ``--suite_mode parallel``: every video's fused epoch side by side, each
  on its own CUDA stream (``parallel/suite.py``); under torchrun the ranks
  share the videos out, rank ``r`` fitting its contiguous share, and when
  the videos do not divide over the ranks the suite runs sequentially.

Then videos whose fit collapsed are flagged (``flag_divergent``) and refit
from fresh seeds (``--max_refits``); each video is deployed, optionally
pruned, quantized and entropy-coded (``--prune_ratio``, ``--quant_bit``;
``--save_bitstream`` writes one ``.rnvb`` per video) and evaluated, and the
per-video and mean PSNR / MS-SSIM / BPP table goes to ``--suite_out`` (rank
0 writes it) and to stdout as one JSON line.

Seeds: video ``v`` draws its synthetic content (``--dataset synth``, or
``photo`` / ``corpus`` with ``--synthetic_frames``), its first init and its
shuffles from ``manual_seed + v``; refit ``a`` of video ``v`` inits from
``manual_seed + a * n_videos + v`` (``parallel/suite.py``).  A frame
directory of per-video subdirectories gives one video per subdirectory; a
flat one splits into ``n_videos`` contiguous chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..compress.pipeline import compress
from ..config import TrainConfig
from ..data.frames import (
    FrameStore,
    corpus_video,
    load_frame_dir,
    photo_video,
    pinned_copy,
    synthetic_video,
)
from ..models.generator import generator_to_deploy
from ..parallel.sharding import close_mesh, make_mesh, maybe_initialize_distributed, torchrun_env
from ..parallel.suite import (
    init_suite_states,
    make_suite_epoch_fn,
    refit_seed,
    run_suite_epoch,
    suite_seeds,
    video_sharding,
)
from ..train.loop import (
    evaluate,
    init_train_state,
    make_epoch_fn,
    make_eval_step,
    make_streaming_epoch_fn,
    run_fused_epoch,
)
from ..train.recovery import DivergenceGuard
from .args import args_to_config, build_parser


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type == "cuda":
        # full-f32 convs and matmuls: TF32 would move f32 training by ~1e-3 (C2)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _suite_stores(cfg: TrainConfig, n_videos: int, device) -> list:
    """One FrameStore per video.  Synthetic videos go to ``device``; frames
    from a directory too with ``cache_device``, else they stay in host
    memory (pinned on a card).  A directory of per-video subdirectories (the
    reference's UVG layout) gives one video per subdirectory (``--vid``
    within each); a flat one splits its (``--vid``-selected) frames into
    ``n_videos`` contiguous chunks, ``t`` normalized over the whole
    directory."""
    device = torch.device(device)
    gap = cfg.data.frame_gap
    stores = []
    if cfg.data.dataset == "synth" or (
        cfg.data.dataset in ("photo", "corpus") and cfg.data.synthetic_frames > 0
    ):
        gen = {"photo": photo_video, "corpus": corpus_video}.get(cfg.data.dataset, synthetic_video)
        h, w = cfg.data.synthetic_hw
        for v in range(n_videos):
            frames, t = gen(cfg.data.synthetic_frames, h, w, seed=cfg.manual_seed + v)
            stores.append(FrameStore(torch.from_numpy(frames).to(device), t, gap))
        return stores

    def store(frames: np.ndarray, t: np.ndarray) -> FrameStore:
        if cfg.data.cache_device:
            return FrameStore(torch.from_numpy(frames).to(device), t, gap)
        host = pinned_copy(frames) if device.type == "cuda" else frames
        return FrameStore(host, t, gap, device=device)

    root = os.path.join(cfg.data.data_dir, cfg.data.dataset.lower())
    subdirs = sorted(
        d
        for d in (os.listdir(root) if os.path.isdir(root) else [])
        if os.path.isdir(os.path.join(root, d))
    )
    if subdirs:
        if len(subdirs) < n_videos:
            raise FileNotFoundError(
                f"{root} has {len(subdirs)} video subdirectories, "
                f"--n_videos {n_videos} requested"
            )
        for name in subdirs[:n_videos]:
            stores.append(store(*load_frame_dir(os.path.join(root, name), cfg.data.vid)))
    else:
        frames, t = load_frame_dir(root, cfg.data.vid)
        if len(frames) < n_videos:
            raise ValueError(f"{len(frames)} frames cannot form {n_videos} suite videos")
        for chunk in np.array_split(np.arange(len(frames)), n_videos):
            stores.append(store(frames[chunk], t[chunk]))
    return stores


def _resident(store: FrameStore) -> FrameStore:
    """``store`` with its frames on its device (the parallel mode's epochs
    run over device-resident videos, as the JAX package's stacked videos)."""
    if store.resident:
        return store
    frames = torch.from_numpy(np.asarray(store.frames)).to(store.device)
    return FrameStore(frames, store.t, store.frame_gap)


def _measure_video(model, store: FrameStore, cfg: TrainConfig, v: int,
                   eval_steps: dict | None = None) -> dict:
    """Deploy -> (optional) compress -> PSNR / MS-SSIM / BPP of one video.
    The model is deployed first and handed to ``compress`` with a deploy
    config, which then quantizes it as it is (no second deploy); one eval
    step per (deploy, MS-SSIM) serves every video."""
    if cfg.model.branch_type != "NeRV_vanilla":
        model = generator_to_deploy(model)
    mcfg = model.cfg
    row: dict = {"video": v}
    if cfg.quant_bit != -1 or cfg.prune_ratio < 1.0:
        ccfg = dataclasses.replace(cfg, model=mcfg, finetune=False)
        # one decodable artifact per suite video, as the reference's one
        # checkpoint per UVG video (README.md:63-111)
        bitstream_path = None
        if cfg.save_bitstream and cfg.quant_bit != -1:
            outdir = os.path.join(cfg.outf or "result/suite", "bitstreams")
            os.makedirs(outdir, exist_ok=True)
            bitstream_path = os.path.join(outdir, f"video{v}_q{cfg.quant_bit}.rnvb")
        model, report = compress(model, ccfg, store, bitstream_path=bitstream_path)
        row.update(bpp=report.bpp, efficiency=report.efficiency)
        if bitstream_path:
            acct = report.extras["bitstream"]
            row.update(
                rnvb=bitstream_path,
                rnvb_bytes=int(acct["file_bytes"]),
                bpp_all_in=float(acct.get("bpp_all_in", 0.0)),
            )
    ecfg = dataclasses.replace(cfg, model=mcfg)
    with_msssim = min(store.hw) > 160
    key = (mcfg.deploy, with_msssim)
    if eval_steps is None:
        eval_steps = {}
    if key not in eval_steps:
        eval_steps[key] = make_eval_step(ecfg, with_msssim)
    psnr, msssim = evaluate(model, eval_steps[key], store, ecfg)
    eval_steps[key].release()  # the next video is another model: its key never matches
    row.update(psnr=float(psnr[-1]), msssim=float(msssim[-1]))
    return row


def flag_divergent(
    train_early: list,
    train_final: list,
    *,
    spread_db: float = 12.0,
    floor_db: float = 8.0,
) -> list:
    """Indices of suite videos whose training collapsed; any of three tests
    flags:

    * late collapse: the final train PSNR is more than 0.1 dB below the
      PSNR at 20% of the schedule (a healthy cosine fit is near monotone
      after warmup; the 0.1 dB keeps a flat, saturated fit unflagged);
    * early collapse: the final PSNR is more than ``spread_db`` below the
      suite median (content classes spread ~24 dB at fixed capacity, so
      the bound is wide);
    * floor: the final PSNR is below ``floor_db``.
    """
    if not train_final:
        return []
    med = float(np.median(train_final))
    flagged = []
    for v, fin in enumerate(train_final):
        early = train_early[v] if v < len(train_early) else None
        late = early is not None and fin < early - 0.1
        if late or fin < med - spread_db or fin < floor_db:
            flagged.append(v)
    return flagged


def _fit_one(cfg: TrainConfig, store: FrameStore, seed: int, v: int, epoch_fns: dict,
             with_msssim: bool, early_epoch: int):
    """One sequential video fit from the init ``seed``; returns (the trained
    model, the PSNR at ``early_epoch``, the final train PSNR).

    ``epoch_fns`` keeps one epoch function per step count (and store kind):
    videos of one length share it (one capture each), and a shorter video's
    learning rate paces over its own steps."""
    b = cfg.data.batch_size
    steps_v = max(store.num_samples // b, 1)
    key = (steps_v, store.resident)
    if key not in epoch_fns:
        maker = make_epoch_fn if store.resident else make_streaming_epoch_fn
        epoch_fns[key] = maker(cfg, steps_v, with_msssim=with_msssim)
    state = init_train_state(cfg, store.device, seed=seed)
    # the shuffles of video v: seed manual_seed + v, as suite_perms
    vcfg = dataclasses.replace(cfg, manual_seed=cfg.manual_seed + v)
    # the in-run half of the recovery story (train/recovery.py); the
    # flag-and-refit pass after the fit is the cross-video net
    guard = DivergenceGuard(cfg, log=lambda msg: print(f"video {v}: {msg}"))
    early = final = None
    m = None
    for epoch in range(cfg.epochs):
        state, m = run_fused_epoch(state, epoch_fns[key], store, vcfg, epoch)
        state, _ = guard.observe(epoch, float(m.psnr[-1]), state)
        if epoch + 1 == early_epoch:
            early = float(m.psnr[-1])
    if cfg.epochs > 0:
        state, restored = guard.finalize(state)
        final = guard.best_psnr if restored else float(m.psnr[-1])
    return state.model, early, final


def _refit_flagged(flagged, models, train_early, train_final, stores, cfg, epoch_fns,
                   with_msssim, early_epoch, max_refits, n_videos):
    """Refit collapsed videos from fresh seeds (``refit_seed``, at most
    ``max_refits`` attempts each), keeping the best final train PSNR over the
    attempts; ``models``, ``train_early`` and ``train_final`` are updated in
    place.  Returns per-video refit info."""
    info = {}
    for v in flagged:
        best_final, best_model = train_final[v], models[v]
        best_early, attempts = train_early[v], 0
        for attempt in range(1, max_refits + 1):
            attempts = attempt
            seed = refit_seed(cfg.manual_seed, n_videos, v, attempt)
            model, early, final = _fit_one(cfg, stores[v], seed, v, epoch_fns, with_msssim,
                                           early_epoch)
            print(
                f"refit video {v} attempt {attempt}: train PSNR "
                f"{final:.2f} dB (was {train_final[v]:.2f})"
            )
            if final is not None and final > best_final:
                best_final, best_model, best_early = final, model, early
            trial_final = list(train_final)
            trial_early = list(train_early)
            trial_final[v], trial_early[v] = best_final, best_early
            if v not in flag_divergent(trial_early, trial_final):
                break
        info[v] = {
            "initial_train_psnr": train_final[v],
            "refit_train_psnr": best_final,
            "attempts": attempts,
        }
        models[v] = best_model
        train_final[v], train_early[v] = best_final, best_early
    return info


def _all_videos(mesh, local: list) -> list:
    """The concatenation over the ranks, in rank order, of each rank's
    per-video list: the suite's order, since rank ``r`` holds the ``r``-th
    contiguous share."""
    if mesh is None:
        return list(local)
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, list(local))
    return [x for part in parts for x in part]


def _fit_parallel(cfg: TrainConfig, stores: list, local, mesh, with_msssim: bool,
                  early_epoch: int):
    """This rank's videos fitted side by side; returns (their models by suite
    index, every video's early and final train PSNR)."""
    b = cfg.data.batch_size
    n_frames_list = [int(s.frames.shape[0]) for s in stores]
    steps = max(max(s.num_samples for s in stores) // b, 1)
    if len(set(n_frames_list)) > 1:
        print(
            f"suite videos have unequal lengths {n_frames_list}; every video runs "
            f"the longest video's {steps} steps an epoch (shorter videos cycle "
            "their own frames per epoch)"
        )
    local_stores = [_resident(stores[v]) for v in local]
    device = stores[0].device
    states = init_suite_states(cfg, len(stores), device, videos=local)
    epoch_fn = make_suite_epoch_fn(cfg, steps, len(local), with_msssim=with_msssim)
    train_early = train_final = None
    psnrs = None
    for epoch in range(cfg.epochs):
        mine = []
        if local:
            states, m = run_suite_epoch(states, epoch_fn, local_stores, cfg, epoch, steps,
                                        mesh, n_frames=n_frames_list)
            mine = [float(p[-1]) for p in m["psnr"]]
        psnrs = _all_videos(mesh, mine)
        if epoch + 1 == early_epoch:
            train_early = psnrs
        if epoch % max(cfg.print_freq // steps, 1) == 0 or epoch == cfg.epochs - 1:
            ps = " ".join(f"{p:.2f}" for p in psnrs)
            print(f"epoch {epoch + 1}/{cfg.epochs} per-video PSNR: {ps}")
    if psnrs is not None:
        train_final = psnrs
    return {v: s.model for v, s in zip(local, states)}, train_early, train_final


def run_suite(cfg: TrainConfig, n_videos: int, mode: str, suite_out: str,
              max_refits: int = 2, device="cuda") -> dict:
    device = _device(device)
    mesh = None
    if mode == "parallel" and maybe_initialize_distributed(device):
        mesh = make_mesh((), ("video",), device)
        device = mesh.device
    env = torchrun_env()
    writer = mesh.rank == 0 if mesh is not None else env is None or env["rank"] == 0
    try:
        stores = _suite_stores(cfg, n_videos, device)
        with_msssim = min(stores[0].hw) > 160
        early_epoch = max(cfg.epochs // 5, 1)
        epoch_fns: dict = {}
        t0 = time.time()
        if mode == "parallel":
            n_dev = mesh.world_size if mesh is not None else 1
            axis = min(n_dev, n_videos)
            if n_videos % axis != 0:
                print(
                    f"WARNING: {n_videos} videos do not divide over {n_dev} "
                    "devices; falling back to sequential"
                )
                close_mesh(mesh)
                mesh = None
                return run_suite(cfg, n_videos, "sequential", suite_out, max_refits, device)
            local = list(video_sharding(mesh, n_videos))
            models, train_early, train_final = _fit_parallel(cfg, stores, local, mesh,
                                                             with_msssim, early_epoch)
        else:
            local = list(range(n_videos))
            models = {}
            train_early, train_final = [], []
            # the same seeds as the parallel mode's init_suite_states: the
            # two modes make the same fits
            seeds = suite_seeds(cfg.manual_seed, n_videos)
            for v, store in enumerate(stores):
                models[v], early, final = _fit_one(cfg, store, seeds[v], v, epoch_fns,
                                                   with_msssim, early_epoch)
                train_early.append(early)
                train_final.append(final)
                if final is not None:
                    print(f"video {v}: final train PSNR {final:.2f}")
            if cfg.epochs == 0:
                train_early = train_final = None

        # flag collapsed fits and refit them before any measurement, so that
        # no artifact of the table carries a collapsed fit (each rank refits
        # its own videos; every rank holds every video's PSNRs)
        refit_info = {}
        detect = bool(train_early and train_final) and cfg.epochs >= 10
        if detect:
            flagged = flag_divergent(train_early, train_final)
            for v in flagged:
                synthetic = cfg.data.dataset in ("synth", "photo", "corpus") and (
                    cfg.data.dataset == "synth" or cfg.data.synthetic_frames > 0
                )
                hint = (
                    f"; reproduce it standalone via --content_seed "
                    f"{cfg.manual_seed + v}" if synthetic else ""
                )
                print(
                    f"WARNING: video {v} collapsed — train PSNR "
                    f"{train_final[v]:.2f} dB at the end vs "
                    f"{train_early[v]:.2f} dB at epoch {early_epoch} "
                    f"(suite median {float(np.median(train_final)):.2f}).  "
                    f"Likely an init/content interaction; refitting with a "
                    f"fresh init key (up to {max_refits} attempts){hint}."
                )
            if flagged and max_refits > 0:
                mine = [v for v in flagged if v in local]
                info = _refit_flagged(mine, models, train_early, train_final, stores, cfg,
                                      epoch_fns, with_msssim, early_epoch, max_refits, n_videos)
                done = _all_videos(mesh, [(v, info[v], train_early[v], train_final[v])
                                          for v in mine])
                for v, vinfo, early, final in done:
                    refit_info[v] = vinfo
                    train_early[v], train_final[v] = early, final

        fit_s = time.time() - t0
        eval_steps: dict = {}
        rows = _all_videos(mesh, [_measure_video(models[v], stores[v], cfg, v, eval_steps)
                                  for v in local])
    finally:
        close_mesh(mesh)
    if detect:
        still_bad = set(flag_divergent(train_early, train_final))
        for v, r in enumerate(rows):
            r["train_psnr"] = train_final[v]
            if v in still_bad:
                r["diverged"] = True
            if v in refit_info:
                r["refit"] = refit_info[v]
    result = {
        "mode": mode,
        "n_videos": n_videos,
        "epochs": cfg.epochs,
        "fit_seconds": fit_s,
        "videos": rows,
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_msssim": float(np.mean([r["msssim"] for r in rows])),
    }
    if all("bpp" in r for r in rows):
        result["mean_bpp"] = float(np.mean([r["bpp"] for r in rows]))
    if writer:
        os.makedirs(os.path.dirname(suite_out) or ".", exist_ok=True)
        with open(suite_out, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
    return result


def main(argv=None):
    p = build_parser(eval_mode=False)
    p.add_argument("--n_videos", type=int, default=7, help="suite size (UVG: 7)")
    p.add_argument(
        "--suite_mode",
        default="sequential",
        choices=["sequential", "parallel"],
        help="parallel = every video's fit side by side (on one card: one stream "
        "each; under torchrun: a share of the videos per rank)",
    )
    p.add_argument("--suite_out", default="results/uvg_suite.json")
    p.add_argument(
        "--max_refits", type=int, default=2,
        help="bounded fresh-init retries for videos the divergence "
        "detector flags (0 disables auto-refit)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    a = p.parse_args(argv)
    cfg = args_to_config(a, eval_mode=False)
    return run_suite(cfg, a.n_videos, a.suite_mode, a.suite_out, a.max_refits, a.device)


if __name__ == "__main__":
    main()
