"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), each held to its
limit in ``limits/<cell>.json``.

Training (the first three steps that set-up drives through the window's
own call): each step's loss and MS-SSIM as a relative gap; the gradients of
step 1 (eager) and of step 3 (a graph replay), read from Adam's first
moment, and the parameters' change after three steps, each as the worst
leaf's gap between the program's norm and the reference's, over the larger
of the reference's norm of that leaf and of the median leaf; and the median
leaf's gap of the change, which a small bias leaf's round-off under Adam
does not move.  Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change: round-off alone moves them
under Adam.  A val sweep of the window: each frame's PSNR as the largest
gap in dB and its MS-SSIM as the largest relative gap, against the
reference's eval of the weights the sweep ran on.  A cell compares the
numbers its limits name.

Decoding: the frames of a sample of the window's requests against the
reference's frames of the same times, as the root mean square of the
difference and its largest magnitude.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

Numbers = Dict[str, float]
TINY_GRAD = 1e-3  # of the median leaf's reference gradient norm


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's |program's norm - reference's| over the larger of the
    leaf's and the median leaf's reference norm."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Numbers:
    """``prog``: "loss", "msssim" (3 each), "grads" (the leaf norms of the
    gradients of step 1 and of the last step) and "change" (leaf norms);
    ``ref``: ``reference.train.steps``'s result from ``p0``."""
    g_ref = leaf_norms(ref["grads"][0])
    c_ref = leaf_norms({k: ref["params"][k] - p0[k] for k in p0})
    med = statistics.median(g_ref.values())
    moved = {k for k, v in g_ref.items() if v >= TINY_GRAD * med}
    return {
        "loss_gap": max(rel(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "msssim_gap": max(rel(a, b) for a, b in zip(prog["msssim"], ref["msssim"])),
        "grad_gap": worst_leaf(prog["grads"][0], g_ref),
        "grad3_gap": worst_leaf(prog["grads"][-1], leaf_norms(ref["grads"][-1])),
        "change_gap": worst_leaf(prog["change"], c_ref, moved),
        # steady from seed to seed where one small leaf's round-off is not
        "change_median_gap": statistics.median(leaf_gaps(prog["change"], c_ref, moved).values()),
    }


def eval_numbers(prog: dict, ref: dict) -> Numbers:
    """``prog``, ``ref``: a sweep's "psnr" and "msssim" (None where the
    frames are too small for it), a value a frame in the same order."""
    if len(prog["psnr"]) != len(ref["psnr"]) or (prog["msssim"] is None) != (
            ref["msssim"] is None):
        raise ValueError(f"the sweep evaluated {len(prog['psnr'])} frames, the reference "
                         f"{len(ref['psnr'])}, MS-SSIM {prog['msssim'] is not None} against "
                         f"{ref['msssim'] is not None}")
    ms = zip(prog["msssim"] or [], ref["msssim"] or [])
    return {"eval_psnr_gap": max(abs(a - b) for a, b in zip(prog["psnr"], ref["psnr"])),
            "eval_msssim_gap": max((rel(a, b) for a, b in ms), default=0.0)}


def frame_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> Numbers:
    """``pairs`` of (the program's frames, the reference's), same layout."""
    sq, n, top = 0.0, 0, 0.0
    for got, want in pairs:
        d = (got.float() - want.float())
        sq += float(d.double().square().sum())
        n += d.numel()
        top = max(top, float(d.abs().max()))
    return {"frame_rms_gap": math.sqrt(sq / max(n, 1)), "frame_max_gap": top}


def verdict(numbers: Numbers, limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite
    fails)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
