"""Frame-index positional encoding (port of ``repnerv_tpu/models/embedding.py``).

``PE(t)[2i] = sin(t * base**i * pi)``, ``PE(t)[2i+1] = cos(...)`` for
``i < levels``, or the raw scalar for spec ``'none'``.
"""

from __future__ import annotations

import math

import torch


def parse_pe_spec(pe_spec: str):
    """Return (base, levels) or None for 'none'."""
    if pe_spec.lower() == "none":
        return None
    base, levels = pe_spec.split("_")
    return float(base), int(levels)


def positional_encoding(
    t: torch.Tensor, pe_spec: str, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Encode normalized frame indices ``t`` [B] to [B, embed_length] on
    ``t``'s device."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if t.ndim == 0:
        t = t[None]
    spec = parse_pe_spec(pe_spec)
    if spec is None:
        return t[:, None].to(dtype)
    base, levels = spec
    # f32 rounding order of the reference: (t * base**i) * pi, each product
    # rounded to f32; at level 39 the phase is ~2.3e4 and the order shows
    bases = torch.tensor(
        [base**i for i in range(levels)], dtype=torch.float32, device=t.device
    )
    pi = torch.tensor(math.pi, dtype=torch.float32, device=t.device)
    phase = (t[:, None] * bases[None, :]) * pi  # [B, levels]
    # interleave [sin0, cos0, sin1, cos1, ...]
    out = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
    return out.reshape(t.shape[0], 2 * levels).to(dtype)
