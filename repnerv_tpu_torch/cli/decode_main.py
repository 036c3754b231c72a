"""Standalone decoder: ``.rnvb`` artifact -> frames, on an NVIDIA GPU (port
of ``repnerv_tpu/cli/decode_main.py``).

    python -m repnerv_tpu_torch.cli.decode_main model.rnvb --frames 132 \
        [--out frames_dir] [--decode_int8] [--batch N] [--device cuda]

Frame timestamps follow the training convention t_i = i/N.  Without
``--out`` it measures decode throughput on the card (CUDA events); with
``--out`` it writes pred_{i}.png, on any device.  On the card a batch's
decode is one CUDA graph replay (``train/loop.py::make_video_decode_fn``).
``--decode_int8`` runs the trailing blocks through the int8 stage,
calibrated on the first ``min(8, N)`` frames.

``--mesh_shape N`` decodes over the N ranks of a ``torch.distributed``
world (``torchrun --nproc_per_node N``; N = 1 needs no torchrun): the batch
is rounded to a multiple of N, each rank decodes its columns of every batch,
the throughput's checksum is summed over the ranks, and with ``--out`` the
frames are gathered and rank 0 writes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict

import numpy as np
import torch

from ..compress.bitstream import read_bitstream
from ..config import ModelConfig, TrainConfig, output_hw
from ..models.embedding import positional_encoding
from ..models.generator import Generator, calibrate_int8, generator_to_deploy
from ..parallel import sharding
from ..train.checkpoint import load_state
from ..train.loop import decode_batch_cap, make_decode_fn, measure_decode_fps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("artifact", help=".rnvb file written by --save_bitstream")
    p.add_argument(
        "--frames", type=int, required=True, help="number of frames N to decode (t_i = i/N)"
    )
    p.add_argument(
        "--out", default="", help="directory for pred_{i}.png dumps; omit to only measure decode"
    )
    p.add_argument(
        "--batch", type=int, default=0,
        help="frames per batch (default: auto, capped by pixel count)",
    )
    p.add_argument(
        "--decode_int8", action="store_true",
        help="int8 trailing stages (calibrated on the first frames)",
    )
    p.add_argument(
        "--mesh_shape", type=int, nargs="*", default=None,
        help="decode over this many ranks (torchrun --nproc_per_node N; 1 needs no torchrun)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def serving_model(
    state: Dict[str, np.ndarray], mcfg: ModelConfig, device: torch.device
) -> Generator:
    """Build the generator on ``device``, load ``state`` and, for a
    train-state artifact, fuse the branches for serving."""
    model = load_state(Generator(mcfg, device=device), state)
    if not mcfg.deploy and mcfg.branch_type != "NeRV_vanilla":
        # train-state artifacts hold the branch tensors; serve the fused
        # single-conv graph (exact, as the reparam tests show)
        model = generator_to_deploy(model)
    return model


def main(argv=None) -> dict:
    parser = build_parser()
    a = parser.parse_args(argv)
    if a.frames <= 0:
        parser.error(f"--frames must be positive (got {a.frames})")
    n_ranks = int(np.prod(a.mesh_shape)) if a.mesh_shape else 1
    if n_ranks > 1 and sharding.torchrun_env() is None and not torch.distributed.is_initialized():
        parser.error(f"--mesh_shape {' '.join(map(str, a.mesh_shape))} needs {n_ranks} "
                     f"processes: torchrun --nproc_per_node {n_ranks} -m "
                     "repnerv_tpu_torch.cli.decode_main ...")
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    # full-f32 convs and matmuls: TF32 would move f32 decodes by ~1e-3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None
    if a.mesh_shape is not None:
        mesh = sharding.make_mesh(tuple(a.mesh_shape), ("data",), device)
        device = mesh.device
    try:
        return _decode(a, device, mesh, parser)
    finally:
        sharding.close_mesh(mesh)


def _decode(a, device: torch.device, mesh, parser) -> dict:
    rank0 = mesh is None or mesh.rank == 0
    state, mcfg, header = read_bitstream(a.artifact)
    if a.decode_int8:
        mcfg = dataclasses.replace(mcfg, decode_int8=True)
    model = serving_model(state, mcfg, device)
    mcfg = model.cfg
    print(
        f"loaded {a.artifact}: {header['codec']} codec, {header['quant_bit']}-bit, "
        f"branch={mcfg.branch_type}, deploy={header['model_cfg']['deploy']}, "
        f"compute={mcfg.compute_dtype}, device={device}"
    )
    if a.decode_int8:
        calib_t = torch.arange(min(8, a.frames), dtype=torch.float32, device=device) / a.frames
        model = calibrate_int8(model, positional_encoding(calib_t, mcfg.embed))
        if model.int8:
            print("int8 decode calibrated")
        else:
            print("WARNING: int8 calibration skipped; using non-int8 path")

    h, w = output_hw(mcfg)
    n = a.frames
    if mesh is not None:
        n_dev = mesh.data_size
        # the batch splits over the data axis: a multiple of it
        if n < n_dev:
            parser.error(f"--frames {n} < data-axis size {n_dev}")
        bsz = max(a.batch or decode_batch_cap(h, w) * n_dev, n_dev)
        bsz = min((bsz // n_dev) * n_dev, (n // n_dev) * n_dev)
        if rank0:
            print(f"decoding over a {dict(zip(mesh.axis_names, mesh.shape))} mesh, batch {bsz}")
    else:
        bsz = min(a.batch or decode_batch_cap(h, w), n)
    t_all = np.arange(n, dtype=np.float32) / n
    result = {"frames": n, "hw": [h, w], "batch": bsz}
    cfg = TrainConfig(model=mcfg)
    if a.out:
        from PIL import Image

        if rank0:
            os.makedirs(a.out, exist_ok=True)
        decode = make_decode_fn(cfg) if mesh is None else sharding.make_sharded_decode(cfg, mesh)
        t0 = time.perf_counter()
        # the last chunk is padded to bsz, so one graph decodes every chunk
        for i0 in range(0, n, bsz):
            chunk = t_all[i0 : i0 + bsz]
            t = torch.from_numpy(np.pad(chunk, (0, bsz - len(chunk)), mode="edge")).to(device)
            frames = decode(model, t)
            if not rank0:
                continue
            arr = np.clip(frames.cpu().numpy()[: len(chunk)] * 255, 0, 255)
            for b in range(len(chunk)):
                Image.fromarray(arr[b].astype(np.uint8)).save(
                    os.path.join(a.out, f"pred_{i0 + b}.png")
                )
        wall = time.perf_counter() - t0
        if rank0:
            print(f"wrote {n} frames to {a.out} in {wall:.2f}s (incl. PNG encode)")
        result["dump_seconds"] = wall
    else:
        fps = measure_decode_fps(model, cfg, t_all, bsz, mesh=mesh)
        n_timed = max(n // bsz, 1) * bsz
        print(f"decoded {n_timed} frames at {fps:.1f} fps on {torch.cuda.get_device_name(device)}")
        result["fps"] = fps
    return result


if __name__ == "__main__":
    main()
