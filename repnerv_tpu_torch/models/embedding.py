"""Frame-index positional encoding (port of ``repnerv_tpu/models/embedding.py``).

``PE(t)[2i] = sin(t * base**i * pi)``, ``PE(t)[2i+1] = cos(...)`` for
``i < levels``, or the raw scalar for spec ``'none'``.
"""

from __future__ import annotations

import functools
import math

import torch


def parse_pe_spec(pe_spec: str):
    """Return (base, levels) or None for 'none'."""
    if pe_spec.lower() == "none":
        return None
    base, levels = pe_spec.split("_")
    return float(base), int(levels)


@functools.lru_cache(maxsize=None)
def _phase_factors(base: float, levels: int, device: torch.device):
    """(base**i rounded to f32 [levels], pi in f32) on ``device``, made once
    per device: a copy from host memory on every call would make the
    stream wait.  Read-only."""
    bases = torch.tensor([base**i for i in range(levels)], dtype=torch.float32, device=device)
    return bases, torch.tensor(math.pi, dtype=torch.float32, device=device)


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
    bases, pi = _phase_factors(base, levels, t.device)
    phase = (t[:, None] * bases[None, :]) * pi  # [B, levels]
    # interleave [sin0, cos0, sin1, cos1, ...]
    out = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
    return out.reshape(t.shape[0], 2 * levels).to(dtype)


def transformer_positional_table(d_model: int, max_len: int) -> torch.Tensor:
    """Sinusoidal table [max_len, d_model] of the reference's
    ``PositionalEncodingTrans``: column 2i is sin(p * 10000^(-2i/d)), 2i+1 its
    cos, in f32.  Unused by the paper config; part of the reference surface."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros(max_len, d_model, dtype=torch.float32)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def transformer_positional_encoding(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``round(t * max_len)`` (half to even)."""
    index = torch.round(torch.as_tensor(t, dtype=torch.float32) * table.shape[0]).long()
    return table[index]
