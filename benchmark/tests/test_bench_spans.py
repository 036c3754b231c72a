"""The readers of the per-layer metrics that come from the program's spans
(``harness/spans.py``, ``metrics/step_*_ms.py``, ``decode_prepare_ms``) on
a hand-made ``Trace`` summary: each reading per step or request, None in
the other kind of cell, where its span is absent, where a replayed graph
was left unattributed, and for a program without spans."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.spec import Spec  # noqa: E402
from repnerv_tpu_torch.utils import profiling  # noqa: E402
from repnerv_tpu_torch.utils.profiling import SpanTime, Trace  # noqa: E402

REPLAY = "bench.slice/graph.replay:step.3"
TRAIN = {"kind": "train", "steps": 4}
DECODE = {"kind": "decode", "batches": 5}
# device ms a step / a batch, host ms a request
WANT = {"step_fusion_ms": 0.5, "step_pack_ms": 0.25, "step_loss_ms": 1.0,
        "step_backward_ms": 2.0, "step_adam_ms": 0.75, "step_metrics_ms": 0.125,
        "decode_prepare_ms": 0.4}


def _trace(unattributed=()):
    s = {
        "bench.slice": SpanTime(1, 1.0, 0.1, 0.001),
        REPLAY: SpanTime(4, 0.002, 0.002, 0.0),
        f"{REPLAY}/step.forward": SpanTime(4, device_s=0.004),
        f"{REPLAY}/step.forward/reparam.fuse": SpanTime(20, device_s=0.002),
        f"{REPLAY}/step.forward/train_tail.pack_weights": SpanTime(16, device_s=0.001),
        f"{REPLAY}/step.loss": SpanTime(4, device_s=0.004),
        f"{REPLAY}/step.backward": SpanTime(4, device_s=0.008),
        f"{REPLAY}/step.adam": SpanTime(4, device_s=0.001),
        f"{REPLAY}/step.adam/Optimizer.step#Adam.step": SpanTime(4, device_s=0.002),
        f"{REPLAY}/step.metrics": SpanTime(8, device_s=0.0005),
        # a decode slice: 5 requests
        "bench.slice/decode.prepare": SpanTime(5, 0.002, 0.0015),
        "bench.slice/decode.prepare/decode.key": SpanTime(5, 0.0005, 0.0005),
    }
    return Trace(profiler=None, spans=s, unattributed=list(unattributed))


def _read(name, ctx):
    return Spec().reader(name)(ctx)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_its_span_per_step_or_request(name, monkeypatch):
    monkeypatch.setattr(profiling, "_LAST", _trace())
    ctx, other = (DECODE, TRAIN) if name == "decode_prepare_ms" else (TRAIN, DECODE)
    assert _read(name, ctx) == pytest.approx(WANT[name])
    assert _read(name, other) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_without_its_span_or_a_program_with_spans(name, monkeypatch):
    ctx = DECODE if name == "decode_prepare_ms" else TRAIN
    monkeypatch.setattr(profiling, "_LAST", Trace(profiler=None, spans={
        "bench.slice": SpanTime(1, 1.0, 1.0, 0.004)}))
    assert _read(name, ctx) is None
    monkeypatch.setattr(profiling, "_LAST", None)  # no traced block yet
    assert _read(name, ctx) is None
    monkeypatch.delattr(profiling, "last_trace")  # the program before spans
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", sorted(set(WANT) - {"decode_prepare_ms"}))
def test_an_unattributed_graph_gives_no_device_reading(name, monkeypatch):
    monkeypatch.setattr(profiling, "_LAST", _trace(unattributed=["step.3"]))
    assert _read(name, TRAIN) is None


def test_host_time_does_not_need_the_graphs(monkeypatch):
    monkeypatch.setattr(profiling, "_LAST", _trace(unattributed=["decode.2"]))
    assert _read("decode_prepare_ms", DECODE) == pytest.approx(0.4)
