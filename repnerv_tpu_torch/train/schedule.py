"""Learning-rate schedule: fractional-epoch warmup + cosine / step / const
(port of ``repnerv_tpu/train/schedule.py``).

* ``frac_epoch = epoch + iter / steps_per_epoch``
* warmup (frac_epoch < warmup): ``0.1 + 0.9 * frac_epoch / warmup``
* cosine: ``0.5 * (cos(pi * (frac_epoch - warmup) / (epochs - warmup)) + 1)``
* step: ``0.1 ** sum(frac_epoch >= lr_steps)``; const / plateau: 1.

Computed on the host in float32 with the JAX package's operation order, so
the step's learning rate is the same f32 number on both sides.  The eager
step writes it into the optimizer's learning-rate tensor; the fused epoch
sends the epoch's ``lr_table`` to the device once and its captured step
reads its own entry there.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

_F32 = np.float32


def lr_multiplier(
    frac_epoch,
    *,
    epochs: int,
    warmup_epochs: float,
    lr_type: str = "cosine",
    lr_steps: Sequence[float] = (),
) -> np.float32:
    frac_epoch = _F32(frac_epoch)
    if lr_type == "cosine":
        denom = max(epochs - warmup_epochs, 1e-9)
        mult = _F32(0.5) * (np.cos(_F32(math.pi) * (frac_epoch - _F32(warmup_epochs)) / _F32(denom))
                            + _F32(1.0))
    elif lr_type == "step":
        n = int(np.sum(frac_epoch >= np.asarray(lr_steps, _F32))) if len(lr_steps) else 0
        mult = _F32(0.1) ** n
    elif lr_type in ("const", "plateau"):
        mult = _F32(1.0)
    else:
        raise NotImplementedError(lr_type)
    if warmup_epochs > 0 and frac_epoch < warmup_epochs:
        mult = _F32(0.1) + _F32(0.9) * frac_epoch / _F32(warmup_epochs)
    return _F32(mult)


def lr_at_step(
    step: int,
    *,
    base_lr: float,
    steps_per_epoch: int,
    epochs: int,
    warmup_epochs: float,
    lr_type: str = "cosine",
    lr_steps: Sequence[float] = (),
    samples_per_epoch: Optional[int] = None,
) -> np.float32:
    """LR at the global step (step = epoch * steps_per_epoch + i).  With
    ``samples_per_epoch`` (the dataset length) the intra-epoch fraction
    advances by 1/samples per batch, the reference's ``adjust_lr``
    denominator (``lr_frac_mode="sample"``); else by 1/steps_per_epoch."""
    step = _F32(step)
    if samples_per_epoch is None:
        frac_epoch = step / _F32(steps_per_epoch)
    else:
        ep = np.floor(step / _F32(steps_per_epoch))
        frac_epoch = ep + (step - ep * _F32(steps_per_epoch)) / _F32(samples_per_epoch)
    mult = lr_multiplier(
        frac_epoch, epochs=epochs, warmup_epochs=warmup_epochs, lr_type=lr_type, lr_steps=lr_steps
    )
    return _F32(_F32(base_lr) * mult)


def lr_table(first_step: int, n_steps: int, **schedule) -> np.ndarray:
    """The learning rates of the global steps ``first_step`` ..
    ``first_step + n_steps - 1`` as f32 [n_steps]: ``lr_at_step`` of each
    (``schedule`` is its keyword arguments), element for element."""
    return np.array([lr_at_step(first_step + i, **schedule) for i in range(n_steps)], _F32)
