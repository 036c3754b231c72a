"""Faults planted in the program's timed path, to show that the check
catches each fault a cell can have (``tests/test_bench_faults.py`` on the
CPU; ``readings.py --fault`` on the card at the cell's own size).

* training (-b 1, one chip): ``state_unchanged``, a step whose update does
  nothing; ``loss_altered``, the loss scaled by 1.01 where it is produced;
  ``sweep_altered``, the val sweep's PSNR scaled by 1.01 where the eval
  step produces it.  Half of a batch of one frame, and an
  exchange between chips, do not exist in these cells.
* decoding (8 frames a request, one chip): ``half_batch_left_out``, the
  first half of the batch decoded twice in place of the whole;
  ``answer_altered``, one frame of the batch mirrored left to right where
  it is produced.  A decode keeps no state from request to request.
"""

from __future__ import annotations

import contextlib

import torch

from repnerv_tpu_torch.train import loop


def _no_update(real):
    def apply_update(state, masks, lr):
        """A step that returns its state unchanged."""
    return apply_update


def _altered_loss(real):
    def multi_scale_loss(*args, **kw):
        return real(*args, **kw) * 1.01
    return multi_scale_loss


def _altered_sweep(real):
    def _make_eval_batch(cfg, with_msssim):
        batch = real(cfg, with_msssim)

        def altered_batch(model, frames, t):
            outs, aux = batch(model, frames, t)
            return outs, {**aux, "psnr": aux["psnr"] * 1.01}
        return altered_batch
    return _make_eval_batch


def _half_batch(real):
    def decode_batch(model, cfg, t):
        half = real(model, cfg, t[: (t.shape[0] + 1) // 2])
        return torch.cat([half, half])[: t.shape[0]]
    return decode_batch


def _altered_answer(real):
    def decode_batch(model, cfg, t):
        out = real(model, cfg, t)
        return torch.cat([out[:1].flip(2), out[1:]])
    return decode_batch


# fault -> (the traffic kind it breaks, the function of train/loop.py it
# replaces, the replacement made from the real one)
FAULTS = {
    "state_unchanged": ("train", "apply_update", _no_update),
    "loss_altered": ("train", "multi_scale_loss", _altered_loss),
    "sweep_altered": ("train", "_make_eval_batch", _altered_sweep),
    "half_batch_left_out": ("decode", "decode_batch", _half_batch),
    "answer_altered": ("decode", "decode_batch", _altered_answer),
}


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` in the program for the duration."""
    _, name, make = FAULTS[fault]
    real = getattr(loop, name)
    setattr(loop, name, make(real))
    try:
        yield
    finally:
        setattr(loop, name, real)
