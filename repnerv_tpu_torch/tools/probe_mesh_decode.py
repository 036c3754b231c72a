"""Where ``decode_main --mesh_shape 1`` loses time against the plain decode.

    python -m repnerv_tpu_torch.tools.probe_mesh_decode --out FILE.json

The flagship ERB generator (720p, deployed, seed 0) decodes 32 frames in
batches of 8, as ``chip_smoke.py``'s ``[mesh]`` turns, in bf16 and in int8,
in one process.  Three forms of the timed decode:

* ``plain``: ``decode_video``'s checksums (``measure_decode_fps`` without a
  mesh);
* ``collective``: the sharded decode as it was timed before: this rank's
  checksums and one ``all_reduce`` of them inside each window, after a
  warm-up decode whose all-reduce starts NCCL's communicator;
* ``local``: the sharded decode's window now: this rank's checksums only
  (``make_sharded_video_decode_fn(local=True)``), reduced after the loop
  (``measure_decode_fps`` with a mesh).

First as ``decode_main --mesh_shape 1`` runs them: each sharded turn in a
world of one of its own, started just before and closed after (fps, in
turns: plain, collective, local, local, collective, plain, twice).  Then in
one world that stays alive, one window a call between two CUDA events (ms,
in turns), and a ``torch.profiler`` timeline (CPU and CUDA) of ``plain``,
of ``collective`` and of ``collective`` in a world just started: the
window's length, the device's busy time in it, the gaps between device
work of more than 20 us with what the host was doing in them (the host
events that overlap each gap, by name), and the work by stream.  Prints one
line per measurement and writes the whole to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..models.embedding import positional_encoding
from ..models.generator import Generator, calibrate_int8, generator_to_deploy
from ..parallel import sharding
from ..train.loop import DECODE_REPS, decode_time_batches, decode_video, measure_decode_fps
from ..utils.profiling import trace

FRAMES, BATCH = 32, 8
REPS = 20  # timed windows a variant a turn
GAP_US = 20.0


def window_ms(fn) -> float:
    """One call of ``fn()`` between two CUDA events, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timeline(fn, path: str, reps: int = 3) -> dict:
    """torch.profiler's chrome trace (``utils/profiling.py::trace`` into
    the directory ``path``) of ``reps`` windows of ``fn()``, read per window
    (the host span of each call, from its record_function range): device
    busy ms, the gaps between device work over ``GAP_US`` and the host
    events inside them, the device work by stream."""
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with trace(path, "cuda") as rec:
        for i in range(reps):
            with record_function(f"window{i}"):
                fn()
            torch.cuda.synchronize()
    with open(rec.path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                                  "user_annotation")]
    marks = sorted((e for e in host if str(e.get("name", "")).startswith("window")),
                   key=lambda e: e["ts"])
    out = []
    for k, m in enumerate(marks):
        t0 = float(m["ts"])
        t1 = float(marks[k + 1]["ts"]) if k + 1 < len(marks) else float("inf")
        mine = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in dev
                      if t0 <= float(e["ts"]) < t1)
        if not mine:
            continue
        busy, gaps, end = 0.0, [], mine[0][0]
        for a, b, e in mine:
            if a > end + GAP_US:
                gaps.append((end, a))
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        in_gaps = collections.Counter()
        for a, b in gaps:
            for e in host:
                if e is m or str(e.get("name", "")).startswith("window"):
                    continue
                lo, hi = max(a, float(e["ts"])), min(b, float(e["ts"]) + float(e["dur"]))
                if hi > lo:
                    in_gaps[e["name"]] += hi - lo
        streams = collections.Counter()
        for a, b, e in mine:
            streams[str(e.get("args", {}).get("stream", "?"))] += b - a
        out.append({
            "device_span_ms": (end - mine[0][0]) / 1e3,
            "device_busy_ms": busy / 1e3,
            "host_call_ms": float(m["dur"]) / 1e3,
            "device_after_host_call_ms": (end - (t0 + float(m["dur"]))) / 1e3,
            "gaps": len(gaps), "gap_ms": sum(b - a for a, b in gaps) / 1e3,
            "largest_gaps_us": sorted((round(b - a, 1) for a, b in gaps), reverse=True)[:5],
            "host_in_gaps_us": {k: round(v, 1) for k, v in in_gaps.most_common(8)},
            "device_us_by_stream": {k: round(v, 1) for k, v in streams.items()},
            "non_decode_device": sorted({e["name"][:60] for a, b, e in mine
                                         if "nccl" in e["name"].lower()
                                         or e.get("cat") != "kernel"}),
        })
    return {"windows": out}


def fps_collective_in_window(model: Generator, cfg: TrainConfig, t_mat: torch.Tensor, mesh,
                             reps: int = DECODE_REPS) -> float:
    """``measure_decode_fps`` with a mesh as it was before the checksums left
    its window: the all-reduce of each rep's checksums inside the window."""
    run = sharding.make_sharded_video_decode_fn(cfg, mesh)
    run(model, t_mat)  # warm-up: its all-reduce starts NCCL's communicator
    return t_mat.numel() / min(window_ms(lambda: run(model, t_mat)) for _ in range(reps)) * 1e3


def model_of(int8: bool) -> Generator:
    cfg = ModelConfig(branch_type="ERB", compute_dtype="bfloat16", decode_int8=int8)
    model = generator_to_deploy(Generator(cfg, seed=0, device="cuda")).eval()
    if int8:
        calib = torch.arange(8, dtype=torch.float32, device="cuda") / FRAMES
        model = calibrate_int8(model, positional_encoding(calib, cfg.embed))
    return model


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="JSON file for the measurements")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_mesh_decode needs a CUDA device")
    traces = tempfile.mkdtemp()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}
    t_np = decode_time_batches(np.arange(FRAMES, dtype=np.float32) / FRAMES, BATCH)
    t_mat = torch.from_numpy(t_np).cuda()
    t_flat = t_np.reshape(-1)
    for int8 in (False, True):
        name = "int8" if int8 else "bfloat16"
        model = model_of(int8)
        cfg = TrainConfig(model=model.cfg)

        def plain():
            return decode_video(model, cfg, t_mat, keep_frames=False)

        def times(fn):
            fn()
            return [window_ms(fn) for _ in range(REPS)]

        res = {"plain_no_world": times(plain)}
        fresh = {"plain": [], "collective": [], "local": []}
        for turn in ("plain", "collective", "local", "local", "collective", "plain") * 2:
            if turn == "plain":
                fresh[turn].append(measure_decode_fps(model, cfg, t_flat, BATCH))
                continue
            mesh = sharding.make_mesh((1,), ("data",), "cuda")
            try:
                fresh[turn].append(fps_collective_in_window(model, cfg, t_mat, mesh)
                                   if turn == "collective" else
                                   measure_decode_fps(model, cfg, t_flat, BATCH, mesh=mesh))
            finally:
                sharding.close_mesh(mesh)
        res["fresh_world_fps"] = fresh
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        try:
            local = sharding.make_sharded_video_decode_fn(cfg, mesh, local=True)

            def shard_local():
                return local(model, t_mat)

            def collective():
                ys = local(model, t_mat)
                dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=mesh.data_group)
                return ys

            variants = {"plain": plain, "collective": collective, "local": shard_local}
            for turn in ("plain", "collective", "local", "local", "collective", "plain"):
                res.setdefault(turn, []).extend(times(variants[turn]))
            for v in ("plain", "collective"):
                res[f"timeline_{v}"] = timeline(variants[v],
                                                os.path.join(traces, f"{name}_{v}"))
        finally:
            sharding.close_mesh(mesh)
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        try:
            run = sharding.make_sharded_video_decode_fn(cfg, mesh)
            run(model, t_mat)  # the communicator starts here
            res["timeline_collective_fresh"] = timeline(
                lambda: run(model, t_mat), os.path.join(traces, f"{name}_fresh"))
        finally:
            sharding.close_mesh(mesh)
        for v in ("plain_no_world", "plain", "collective", "local"):
            ms = res[v]
            print(f"[probe-mesh] {name} {v}: window ms mean {statistics.mean(ms):.4f} "
                  f"median {statistics.median(ms):.4f} min {min(ms):.4f} over {len(ms)} "
                  f"({FRAMES / min(ms) * 1e3:.2f} fps at the fastest)", flush=True)
        for v in ("plain", "collective", "collective_fresh"):
            for i, w in enumerate(res[f"timeline_{v}"]["windows"]):
                print(f"[probe-mesh] {name} {v} profiled window {i}: {json.dumps(w)}", flush=True)
        print(f"[probe-mesh] {name} fps, a world of one started for each sharded turn, in turns: "
              + "; ".join(f"{k} mean {statistics.mean(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})"
                          for k, v in fresh.items()), flush=True)
        result[name] = res
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(traces)
    with open(a.out, "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
