"""Small utilities from the reference surface (port of
``repnerv_tpu/utils/misc.py``; its compile cache is the JAX package's own)."""

from __future__ import annotations

from typing import List


def split_channels(num_channels: int, num_splits: int = 6) -> List[int]:
    """Even channel split with the remainder spread over the first groups
    (the reference's utils.py; unused by the paper config)."""
    base = num_channels // num_splits
    remain = num_channels % num_splits
    sizes = [base] * num_splits
    for i in range(remain):
        sizes[i] += 1
    return sizes
