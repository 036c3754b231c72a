"""The training traffic: one video, one job, a closed loop.

The window drives ``train/loop.py::run_fused_epoch`` over ``make_epoch_fn``'s
``FusedEpoch`` (one CUDA graph replay a step, frames on the card), the
recipe's whole epochs in its shuffled order and learning-rate schedule, and
a val sweep through ``make_eval_step`` after every ``eval_freq``-th epoch,
as ``cli/train_main.py`` runs them; checkpoints and logging are left out.

Set-up runs epoch 0 through the same ``FusedEpoch`` call, in four pieces:
its first step (eager, then the capture), the second and the third (one
replay each), and the rest.  The first three steps are the ones the
reference follows; their losses and MS-SSIM, Adam's first moment after
steps 1, 2 and 3 (from which the gradients of step 1 and of step 3, a
replay, are worked out) and the parameters after three are read as they
happen.  A val sweep warms up the eval path's shapes.

The first val sweep of the window (where the window holds none, the last
one before the check) is checked too: its per-frame PSNR and MS-SSIM, and
the weights it ran on, which the reference evaluates again.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from repnerv_tpu_torch.data.frames import FrameStore
from repnerv_tpu_torch.train.loop import (
    epoch_rows, evaluate, init_train_state, make_epoch_fn, make_eval_step, run_fused_epoch)
from repnerv_tpu_torch.kernels.build import load_library
from repnerv_tpu_torch.utils.profiling import trace

from harness import arith, inputs
from harness.checks import eval_numbers, leaf_gaps, leaf_norms, train_numbers
from harness.program import load_weights, train_config
from reference import model as ref_model
from reference import train as ref_train

CHECKED_STEPS = 3  # set-up's steps that the reference follows


def first_moments(opt: torch.optim.Optimizer, params: Dict[str, torch.Tensor]) -> dict:
    """Adam's first moment of each leaf, a copy (zeros where Adam never
    stepped the leaf)."""
    return {name: opt.state[p]["exp_avg"].detach().double().clone()
            if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p, dtype=torch.float64)
            for name, p in params.items()}


class Mix:
    """The ``train`` kind of traffic: ``batch_size`` frames a step and a val
    sweep after every ``eval_freq``-th epoch."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = cfg, seed
        self.device = torch.device(device)
        self.tcfg = train_config(cfg, traffic, seed)
        self.eval_freq = traffic["eval_freq"]
        self.parts: Dict[str, float] = {}
        self.swept = None  # the sweep the check compares (``_sweep``)

    def _part(self, name: str, since: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = now - since
        return now

    def setup(self) -> None:
        v, m = self.cfg["video"], self.cfg["model"]
        t = time.perf_counter()
        if self.device.type == "cuda":
            load_library()  # builds the kernels in the checkout's first run
            t = self._part("kernel_library", t)
        self.frames = inputs.video(v["frames"], v["height"], v["width"], self.seed, self.device)
        self.store = FrameStore(frames=self.frames,
                                t=inputs.frame_times(v["frames"]).numpy(), frame_gap=1)
        self.val_store = dataclasses.replace(self.store, frame_gap=self.tcfg.data.test_gap)
        self.val_rows = self.val_store.sample_indices()  # a sweep's frames, in its order
        t = self._part("frames", t)
        self.p0 = inputs.weights(ref_model.param_shapes(m), self.seed, self.device)
        t = self._part("weights", t)
        self.state = init_train_state(self.tcfg, self.device, seed=0)
        load_weights(self.state.model, self.p0)
        b = self.tcfg.data.batch_size
        self.steps_per_epoch = max(self.store.num_samples // b, 1)
        with_msssim = min(self.store.hw) > 160  # train_main's rule
        self.epoch_fn = make_epoch_fn(self.tcfg, self.steps_per_epoch, with_msssim=with_msssim)
        self.eval_step = make_eval_step(self.tcfg, with_msssim=with_msssim)
        t = self._part("model_and_optimizer", t)

        self.rows0 = epoch_rows(self.store, self.tcfg, 0)
        prog = {"loss": [], "msssim": [], "grads": []}
        params = dict(self.state.model.named_parameters())
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        m_prev = None
        k = 0
        for n in (1, 1, 1, len(self.rows0) - CHECKED_STEPS):
            self.state, aux = self.epoch_fn(self.state, self.store, self.rows0[k : k + n], None)
            k += n
            if k <= CHECKED_STEPS:
                prog["loss"] += aux["loss"].tolist()
                # the last head's MS-SSIM (the frame's), 0 where it is not computed
                prog["msssim"] += aux["msssim"][:, -1].tolist() if "msssim" in aux else [0.0] * n
                # Adam's first moment m_k = beta1 m_(k-1) + (1 - beta1) g_k gives
                # back the gradient the optimizer got at step k
                m = first_moments(self.state.optimizer, params)
                if k in (1, CHECKED_STEPS):
                    prog["grads"].append({
                        name: float((v if m_prev is None else v - beta1 * m_prev[name]).norm())
                        / (1.0 - beta1) for name, v in m.items()})
                m_prev = m
            if k == CHECKED_STEPS:
                prog["change"] = {name: float((p.detach() - self.p0[name]).double().norm())
                                  for name, p in params.items()}
                m_prev = m = None
            t = self._part("first_step_and_capture" if k == 1 else f"steps_to_{k}", t)
        self.prog = prog
        self._sweep(in_window=False)
        self._part("val_sweep_warmup", t)
        self.epoch = 1

    def _epoch(self) -> tuple:
        """One epoch of the window; returns (frames trained, failed)."""
        self.state, m = run_fused_epoch(self.state, self.epoch_fn, self.store, self.tcfg,
                                        self.epoch)
        n = self.steps_per_epoch * self.tcfg.data.batch_size
        return n, (0 if math.isfinite(m.loss) else n)

    def _sweep(self, in_window: bool = True) -> None:
        """A val sweep through ``evaluate``.  Until the check holds a sweep
        of the window, it keeps this one's per-frame metrics and a copy of
        the weights it ran on, on the device (no wait for the card)."""
        swept = []

        def eval_step(model, frames, t):
            outs, aux = self.eval_step(model, frames, t)
            swept.append(aux)
            return outs, aux

        evaluate(self.state.model, eval_step, self.val_store, self.tcfg)
        self.eval_step.release()  # training moves the weights: the next sweep captures anew
        if self.swept is None or not self.swept["in_window"]:
            with torch.no_grad():
                self.swept = {
                    "in_window": in_window,
                    "weights": {k: p.detach().clone()
                                for k, p in self.state.model.named_parameters()},
                    # the last head's (the frame's) metrics, a row a frame (its batch's)
                    "psnr": torch.cat([a["psnr"][:, -1] for a in swept]),
                    "msssim": torch.cat([a["msssim"][:, -1] for a in swept])
                    if "msssim" in swept[0] else None}

    def window(self, seconds: float) -> dict:
        """Whole epochs from epoch 1 on, a val sweep after every
        ``eval_freq``-th, until ``seconds`` have passed."""
        frames = failed = 0
        epoch_s, sweep_s = [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            n, bad = self._epoch()
            frames, failed = frames + n, failed + bad
            epoch_s.append(time.perf_counter() - t)
            if (self.epoch + 1) % self.eval_freq == 0:
                t = time.perf_counter()
                self._sweep()
                sweep_s.append(time.perf_counter() - t)
            self.epoch += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        b = self.tcfg.data.batch_size
        return {"train_frames_per_s": frames / elapsed, "attempted": frames // b,
                "failed": failed // b, "seconds": elapsed,
                "about": {"epochs": len(epoch_s), "epoch_s_median": float(np.median(epoch_s)),
                          "epoch_s_min": min(epoch_s), "epoch_s_max": max(epoch_s),
                          "sweeps_s": sweep_s, "epochs_s": [round(e, 4) for e in epoch_s]}}

    def traced(self, trace_dir: str) -> dict:
        """An untraced epoch timed by the host's clock, a traced one, and a
        val sweep with its capture timed by the host's clock: what the
        per-layer readers read."""
        from torch.profiler import record_function

        from harness.trace import read_slice

        t = time.perf_counter()
        n, _ = self._epoch()
        epoch_s = time.perf_counter() - t
        self.epoch += 1
        with trace(trace_dir, self.device) as rec:
            with record_function("bench.slice"):
                self._epoch()
        self.epoch += 1
        t = time.perf_counter()
        self._sweep()
        sweep_s = time.perf_counter() - t
        m = self.cfg["model"]
        return {"kind": "train", "steps": self.steps_per_epoch, "frames": n, "epoch_s": epoch_s,
                "flops_per_frame": arith.deploy_flops_per_frame(m), "sweep_s": sweep_s,
                "bounds": arith.train_bounds(m, *self.store.hw),
                "slice": read_slice(rec.path, "bench.slice"), "attempted": 2 * self.steps_per_epoch,
                "failed": 0}

    def release(self) -> None:
        """Let the program's state go before the reference runs."""
        self.state = self.epoch_fn = self.eval_step = self.store = self.val_store = None

    def check(self, prec=None) -> Dict[str, float]:
        """The reference's first steps and its eval of the checked sweep's
        weights against the program's (``prec``: the reference in a lower
        precision in the program's place, the control)."""
        t = self.cfg["train"]
        rows = [list(map(int, r)) for r in self.rows0[:CHECKED_STEPS]]
        times = inputs.frame_times(self.cfg["video"]["frames"]).to(self.device)
        m = self.cfg["model"]
        ref = ref_train.steps(self.p0, m, t, self.frames, times, rows, self.steps_per_epoch)
        sw = self.swept
        val_rows = list(map(int, self.val_rows))
        b = self.tcfg.data.batch_size
        ref_sweep = ref_train.sweep(sw["weights"], m, self.frames, times, val_rows, b)
        if prec is None:
            prog = self.prog
            prog_sweep = {"psnr": sw["psnr"].tolist(),
                          "msssim": None if sw["msssim"] is None else sw["msssim"].tolist()}
        else:
            ctl = ref_train.steps(self.p0, m, t, self.frames, times, rows,
                                  self.steps_per_epoch, prec=prec)
            prog = {"loss": ctl["loss"], "msssim": ctl["msssim"],
                    "grads": [leaf_norms(ctl["grads"][i]) for i in (0, CHECKED_STEPS - 1)],
                    "change": leaf_norms({k: v - self.p0[k] for k, v in ctl["params"].items()})}
            prog_sweep = ref_train.sweep(sw["weights"], m, self.frames, times, val_rows, b, prec)
        self.leaves = {"grad": leaf_gaps(prog["grads"][0], leaf_norms(ref["grads"][0])),
                       "grad3": leaf_gaps(prog["grads"][1],
                                          leaf_norms(ref["grads"][CHECKED_STEPS - 1])),
                       "change": leaf_gaps(prog["change"], leaf_norms(
                           {k: ref["params"][k] - self.p0[k] for k in self.p0}))}
        return {**train_numbers(prog, ref, self.p0), **eval_numbers(prog_sweep, ref_sweep)}
