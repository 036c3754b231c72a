"""The benchmark's copied arithmetic: FLOPs a frame against the port's
``generator_macs(cfg, deploy=True)``, and the bounds' parts.

    python -m pytest -q benchmark/tests
"""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import arith  # noqa: E402
from harness.program import model_config  # noqa: E402
from repnerv_tpu_torch.utils.costs import generator_macs  # noqa: E402

CONFIGS = sorted((HERE / "configs").glob("*.json"))


def load(path):
    return json.loads(Path(path).read_text())


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_flops_a_frame_are_the_ports_deploy_macs_twice(path):
    cfg = load(path)
    want = generator_macs(model_config(cfg), deploy=True)["flops"]
    assert arith.deploy_flops_per_frame(cfg["model"]) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_the_720p_flagship_widths_make_201_88_gflop_a_frame(path):
    assert arith.deploy_flops_per_frame(load(path)["model"]) / 1e9 == pytest.approx(201.88,
                                                                                      abs=0.005)


def test_a_frame_at_peak_counts_int8_stages_at_the_int8_peak():
    m = load(HERE / "configs" / "erb-720p.json")["model"]
    bf16 = arith.frame_seconds_at_peak(m)
    assert bf16 == pytest.approx(arith.deploy_flops_per_frame(m) / arith.PEAK_OPS["bf16"])
    tail = sum(arith.stage_ops(1, g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"])
               for g in arith.stages(m)[3:])
    int8 = arith.frame_seconds_at_peak(m, 3)
    assert bf16 - int8 == pytest.approx(tail / arith.PEAK_OPS["bf16"] - tail / arith.PEAK_OPS["int8"])


def test_the_kernel_stages_are_blocks_1_to_4():
    m = load(HERE / "configs" / "erb-720p.json")["model"]
    st = arith.stages(m)
    assert [g["kernel"] for g in st] == [False, True, True, True, True]
    assert [(g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]) for g in st[1:]] == [
        (45, 80, 26, 96, 2, 0), (90, 160, 96, 96, 2, 0), (180, 320, 96, 96, 2, 0),
        (360, 640, 96, 96, 2, 3)]


def test_roofline_takes_the_larger_bound():
    r = arith.roofline(989e9, 3.35e9, "bf16")  # 1 ms of operations, 1 ms of bytes
    assert r["bound_ms"] == pytest.approx(1.0)
    r = arith.roofline(989e9, 2 * 3.35e9, "bf16")
    assert r["bound_ms"] == pytest.approx(2.0) and r["bound_by"] == "bytes"
    s = arith.sum_bounds([arith.roofline(2 * 989e9, 0, "bf16"), arith.roofline(0, 3.35e9, "bf16")])
    assert s["bound_ms"] == pytest.approx(3.0) and s["bound_by"] == "operations"


def test_the_train_and_decode_bounds_are_the_per_call_bounds_summed():
    m = load(HERE / "configs" / "erb-720p.json")["model"]
    kern = [g for g in arith.stages(m) if g["kernel"]]
    b = arith.train_bounds(m, 720, 1280)
    assert b["K3"] == pytest.approx(sum(arith.k3_bound(g)["bound_ms"] for g in kern))
    # K3's operations alone: 3 x 201.88 GFLOP is the step, the forward of
    # blocks 1-4 with the head is nearly all of one third of it
    ops = sum(arith.stage_ops(1, g["h"], g["w"], g["cin"], g["c"], g["s"], g["head"]) for g in kern)
    assert b["K3"] >= ops / arith.PEAK_OPS["bf16"] * 1e3
    d = arith.decode_bounds(m, 8, 3)
    assert d["K1"] == pytest.approx(sum(arith.k1_bound(g, 8)["bound_ms"] for g in kern[:2]))
    assert d["K2"] == pytest.approx(sum(arith.k2_bound(g, 8)["bound_ms"] for g in kern[2:]))
    assert arith.decode_bounds(m, 8)["K2"] == 0.0
