"""The serving traffic: one client, a closed loop.

Each request is one call of ``train/loop.py::make_decode_fn``'s
``decode(model, t)`` on a batch of consecutive frame times of the video,
t = i / n, then a synchronise; the batches cycle over the video, the last
padded with its last time as ``cli/decode_main.py`` pads it, and the frames
stay on the card.  The model is the configuration's training model with the
benchmark's weights, folded by ``generator_to_deploy`` as ``decode_main``
serves a train-state artifact, and with ``int8`` in the mix calibrated by
``calibrate_int8`` on the first frames as ``decode_main`` does.

The check compares the frames of a sample of the window's requests, drawn
from the seed (a reservoir over the requests as they complete, and always
the first padded batch and the last request), with the reference's frames.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, generator_to_deploy
from repnerv_tpu_torch.train.loop import make_decode_fn
from repnerv_tpu_torch.kernels.build import load_library
from repnerv_tpu_torch.utils.profiling import trace

from harness import arith, inputs
from harness.program import load_weights, train_config
from reference import model as ref_model

SAMPLE = 6  # requests in the reservoir, besides the padded batch and the last one


class Mix:
    """The ``decode`` kind of traffic: ``batch_size`` frame times a request
    (``int8_from_block``: the int8 tail from that block on)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.int8 = traffic.get("int8_from_block")
        over = {} if self.int8 is None else {"decode_int8": True, "int8_from_block": self.int8}
        self.tcfg = train_config(cfg, traffic, seed, **over)
        self.parts: Dict[str, float] = {}
        self.rng = random.Random(int(inputs.generator(seed, "sample", "cpu").initial_seed()))
        self.kept: Dict[int, tuple] = {}  # request index -> (t [B], frames [B, H, W, 3])
        self.served = 0  # requests so far

    def _part(self, name: str, since: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = now - since
        return now

    def setup(self) -> None:
        m, n = self.cfg["model"], self.cfg["video"]["frames"]
        t = time.perf_counter()
        if self.device.type == "cuda":
            load_library()  # builds the kernels in the checkout's first run
            t = self._part("kernel_library", t)
        self.p0 = inputs.weights(ref_model.param_shapes(m), self.seed, self.device)
        t = self._part("weights", t)
        model = Generator(self.tcfg.model, seed=0, device=self.device)
        self.model = generator_to_deploy(load_weights(model, self.p0)).eval()
        del model
        if self.int8 is not None:
            calib = inputs.frame_times(n)[: min(8, n)].to(self.device)
            self.calib_t = calib
            self.model = calibrate_int8(self.model, positional_encoding(calib, m["embed"]))
            if not self.model.int8:
                raise RuntimeError("calibrate_int8 declined the model: no int8 stage would run")
        t = self._part("model", t)
        b = self.traffic["batch_size"]
        times = inputs.frame_times(n).numpy()
        self.real = []  # frames of each batch that are the video's, not padding
        rows = []
        for i0 in range(0, n, b):
            chunk = times[i0 : i0 + b]
            self.real.append(len(chunk))
            rows.append(np.pad(chunk, (0, b - len(chunk)), mode="edge"))
        self.t_batches = torch.from_numpy(np.stack(rows)).to(self.device)
        self.decode = make_decode_fn(self.tcfg)
        for k in range(len(rows)):  # every batch once: the eager batch, the capture, replays
            self.decode(self.model, self.t_batches[k])
        self._part("first_batch_capture_and_a_pass", t)

    def _request(self) -> tuple:
        """One request; returns (seconds, real frames)."""
        k = self.served % len(self.real)
        t = time.perf_counter()
        out = self.decode(self.model, self.t_batches[k])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t
        i = self.served
        self.served += 1
        self.last = (self.t_batches[k], out)
        if k == len(self.real) - 1 and "padded" not in self.kept:
            self.kept["padded"] = self.last
        elif i < SAMPLE:
            self.kept[i] = self.last
        else:
            j = self.rng.randrange(i + 1)
            if j < SAMPLE:
                self.kept[j] = self.last
        return dt, self.real[k]

    def window(self, seconds: float) -> dict:
        lat: List[float] = []
        frames = 0
        t0 = time.perf_counter()
        while True:
            dt, n = self._request()
            lat.append(dt)
            frames += n
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        ms = np.asarray(lat) * 1e3
        return {"decode_fps": frames / elapsed, "decode_p95_ms": float(np.percentile(ms, 95)),
                "attempted": len(lat), "failed": 0, "seconds": elapsed,
                "about": {"requests": len(lat), "ms_median": float(np.median(ms)),
                          "ms_p99": float(np.percentile(ms, 99)), "ms_max": float(ms.max())}}

    def traced(self, trace_dir: str) -> dict:
        """``slice`` requests untraced, timed by the host's clock, then as
        many traced: what the per-layer readers read."""
        from torch.profiler import record_function

        from harness.trace import read_slice

        n_req = self.traffic["trace_requests"]
        frames = 0
        t = time.perf_counter()
        for _ in range(n_req):
            frames += self._request()[1]
        seconds = time.perf_counter() - t
        with trace(trace_dir, self.device) as rec:
            with record_function("bench.slice"):
                for _ in range(n_req):
                    self._request()
        first = None if self.int8 is None else len(self.cfg["model"]["strides"]) + self.int8
        m, b = self.cfg["model"], self.traffic["batch_size"]
        return {"kind": "decode", "batches": n_req, "frames": frames, "seconds": seconds,
                "frame_s_at_peak": arith.frame_seconds_at_peak(m, first),
                "bounds": arith.decode_bounds(m, b, first),
                "slice": read_slice(rec.path, "bench.slice"), "attempted": 2 * n_req,
                "failed": 0}

    def release(self) -> None:
        """Let the program's state go before the reference runs."""
        self.kept["last"] = self.last
        self.model = self.decode = self.last = None

    def check(self, prec=None) -> Dict[str, float]:
        """The reference's frames of the kept requests against the
        program's (``prec``: the reference one precision lower in the
        program's place, the control: fp8, and an int4 tail where the mix
        serves int8)."""
        from harness.checks import frame_numbers

        m = self.cfg["model"]
        pairs = []
        with ref_model.exact_f32(), torch.no_grad():
            folded = ref_model.deploy_fold(self.p0, m)
            tables = ctl_tables = None
            if self.int8 is not None:
                tables = ref_model.int8_tables(self.p0, m, folded, self.calib_t, self.int8)
                if prec is not None:
                    ctl_tables = ref_model.int8_tables(self.p0, m, folded, self.calib_t,
                                                       self.int8, bits=4)
            for t, frames in self.kept.values():
                want = ref_model.deploy_forward(self.p0, m, folded, t, int8=tables)
                if prec is not None:
                    frames = ref_model.deploy_forward(self.p0, m, folded, t, prec=prec,
                                                      int8=ctl_tables).permute(0, 2, 3, 1)
                pairs.append((frames, want.permute(0, 2, 3, 1)))
        return frame_numbers(pairs)
