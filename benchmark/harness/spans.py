"""Per-layer readings from the program's own spans: the summary by span of
the last traced block (``repnerv_tpu_torch/utils/profiling.py``'s
``last_trace()``), which a cell's traced slice leaves behind.

A span path joins the names of the spans open around it with "/"; a
replayed op's path runs through its replay span
(``graph.replay:<id>/step.forward/reparam.fuse``).  A reading is None when
the program has no spans (no ``last_trace``), when no path holds the span,
or when a replayed graph's ops could not be matched to its label table
(``Trace.unattributed``): a share is never guessed."""

from __future__ import annotations

from typing import Optional


def last_trace():
    """The program's last ``Trace``, or None where the program has none."""
    try:
        from repnerv_tpu_torch.utils.profiling import last_trace as last
    except ImportError:  # a program without spans
        return None
    return last()


def device_s(name: str) -> Optional[float]:
    """Device seconds charged to the span ``name`` and the spans inside it,
    wherever it ran."""
    tr = last_trace()
    if tr is None or tr.unattributed:
        return None
    hit = [s.device_s for path, s in tr.spans.items() if name in path.split("/")]
    return sum(hit) if hit else None


def host_s(name: str) -> Optional[float]:
    """Host seconds inside the span ``name`` (the spans inside it included)."""
    tr = last_trace()
    if tr is None:
        return None
    hit = [s.host_s for path, s in tr.spans.items() if path.rsplit("/", 1)[-1] == name]
    return sum(hit) if hit else None


def per(ctx: dict, kind: str, seconds: Optional[float]) -> Optional[float]:
    """``seconds`` in ms a step (``kind`` "train") or a request's batch
    ("decode") of the traced slice; None in another kind of cell."""
    if ctx.get("kind") != kind or seconds is None:
        return None
    return seconds * 1e3 / ctx["steps" if kind == "train" else "batches"]
