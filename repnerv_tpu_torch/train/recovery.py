"""In-run divergence detection and restore-best recovery (port of
``repnerv_tpu/train/recovery.py``).

Every improving epoch snapshots the model's state on the device (a
``clone()`` of each tensor: no host transfer, no disk write).  An epoch
whose train PSNR is NaN or more than ``recover_drop_db`` below the running
best is a collapse: the snapshot is copied back into the parameters and
Adam's moments and step counts are zeroed (fresh moments; the collapsed
ones are part of the degenerate point), both in place, so that a captured
train step (``loop.make_epoch_fn``) goes on with the same tensors; the
global step carries on, so the LR schedule goes on where it was.
Bounded by ``max_recoveries``; ``finalize`` never returns a collapsed
endpoint.  ``recover_drop_db <= 0`` disables the guard.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..config import TrainConfig
from .loop import TrainState


def snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An on-device copy of the model's state."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class DivergenceGuard:
    """Host-side collapse detector + restore-best recovery for one run."""

    def __init__(self, cfg: TrainConfig, log: Optional[Callable[[str], None]] = None):
        self.drop_db = float(cfg.recover_drop_db)
        self.max_recoveries = int(cfg.max_recoveries)
        self.enabled = self.drop_db > 0
        self._log = log if log is not None else print
        self.best_psnr = -math.inf
        self.best_epoch = -1
        self._best_state: Optional[Dict[str, torch.Tensor]] = None
        self.recoveries = 0
        self.last_psnr = -math.inf

    def _collapsed(self, psnr: float) -> bool:
        if self._best_state is None:
            return False
        return math.isnan(psnr) or psnr < self.best_psnr - self.drop_db

    def _restore(self, state: TrainState) -> TrainState:
        with torch.no_grad():
            state.model.load_state_dict(self._best_state)  # copies into the parameters
            for st in state.optimizer.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()  # zero moments at step 0: a fresh Adam
        return state

    def observe(self, epoch: int, psnr: float, state: TrainState):
        """Feed one epoch's train PSNR; returns ``(state, recovered)``."""
        if not self.enabled:
            return state, False
        psnr = float(psnr)
        self.last_psnr = psnr
        if self._collapsed(psnr):
            if self.recoveries >= self.max_recoveries:
                self._log(
                    f"DIVERGED at epoch {epoch + 1}: train PSNR {psnr:.2f} dB "
                    f"is {self.best_psnr - psnr:.2f} dB below the best "
                    f"({self.best_psnr:.2f} at epoch {self.best_epoch + 1}) "
                    f"but the {self.max_recoveries} recovery budget is spent; "
                    "continuing unrecovered (finalize still restores best)"
                )
                return state, False
            self.recoveries += 1
            self._log(
                f"DIVERGED at epoch {epoch + 1}: train PSNR {psnr:.2f} dB "
                f"fell {self.best_psnr - psnr:.2f} dB below the best "
                f"({self.best_psnr:.2f} at epoch {self.best_epoch + 1}); "
                f"restoring the best snapshot with fresh optimizer state "
                f"(recovery {self.recoveries}/{self.max_recoveries})"
            )
            return self._restore(state), True
        if psnr > self.best_psnr:
            self.best_psnr = psnr
            self.best_epoch = epoch
            self._best_state = snapshot(state.model)
        return state, False

    def finalize(self, state: TrainState):
        """Never return a collapsed endpoint: ``(state, restored)``."""
        if not self.enabled or not self._collapsed(self.last_psnr):
            return state, False
        self._log(
            f"final epoch train PSNR {self.last_psnr:.2f} dB is collapsed; "
            f"returning the best snapshot ({self.best_psnr:.2f} dB from "
            f"epoch {self.best_epoch + 1}) instead"
        )
        return self._restore(state), True
