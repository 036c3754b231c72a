"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a cell's parts by file name alone."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.spec import Spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_the_file_has_exactly_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for group, keys in ENTRY_KEYS.items():
        for e in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_every_name_and_unit_is_made_of_allowed_characters(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_file_under_the_folder_is_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_/.-]+$", str(p.relative_to(REPO))), p


def test_metrics_and_cells_hang_together():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert all(w["config"] in configs for w in cells.values())
    assert {w["config"] for w in cells.values()} == configs
    assert all(w["chips"] in (1, 4) for w in cells.values())
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    spec = Spec()
    for cell in cells:
        reported = {m["name"] for m in spec.metrics(cell, trace=False)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = spec.metrics(cell, trace=True)
        assert layers
        for m in layers:  # a per-layer metric moves a metric its cells report
            assert m["moves"] in reported, (cell, m["name"])
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        assert (HERE / "limits" / f"{cell}.json").is_file()
        traffic = spec.traffic(cells[cell]["traffic"])
        assert (HERE / "drivers" / f"{traffic['kind']}.py").is_file()


def test_the_command_names_only_files_under_its_paths():
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_new_configuration_mix_metric_and_cell_are_found_by_file_name(tmp_path):
    folder = tmp_path / "benchmark"
    for sub in ("traffic", "drivers", "metrics", "limits", "configs"):
        shutil.copytree(HERE / sub, folder / sub)
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((HERE / "configs" / "erb-720p.json").read_text())
    cfg["name"] = "erb-1080p"
    (folder / "configs" / "erb-1080p.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "decode-b4.json").write_text(json.dumps({"kind": "decode",
                                                                   "batch_size": 4}))
    (folder / "metrics" / "frames_a_request.py").write_text("def read(ctx):\n    return 4.0\n")
    (folder / "limits" / "erb1080-decode-b4.json").write_text(json.dumps({"limits": {"x": 1}}))
    bench["configs"].append({"name": "erb-1080p", "source": "x",
                             "file": "benchmark/configs/erb-1080p.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "erb1080-decode-b4", "config": "erb-1080p",
                               "traffic": "decode-b4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_a_request", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "decode_fps",
                               "workloads": ["erb1080-decode-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tmp_path, folder)
    cell = spec.cell("erb1080-decode-b4")
    assert spec.config(cell["config"])["name"] == "erb-1080p"
    assert spec.traffic(cell["traffic"]) == {"kind": "decode", "batch_size": 4}
    assert spec.limits("erb1080-decode-b4") == {"x": 1}
    names = [m["name"] for m in spec.metrics("erb1080-decode-b4", trace=True)]
    assert names == ["frames_a_request"]
    assert spec.reader("frames_a_request")({}) == 4.0
    assert spec.reader("idle_share.decode")({"kind": "train"}) is None
    assert spec.driver("decode").__module__ == "bench_driver_decode"


def test_a_new_kind_of_traffic_is_found_by_file_name(tmp_path):
    """A traffic file whose ``kind`` is new, with its driver beside the
    others: found, and run by ``harness/cell.py``, with no edit."""
    folder = tmp_path / "benchmark"
    for sub in ("traffic", "drivers", "metrics", "limits", "configs"):
        shutil.copytree(HERE / sub, folder / sub)
    (folder / "drivers" / "seek-b1.py").write_text(
        "class Mix:\n"
        "    parts = {}\n"
        "    def __init__(self, cfg, traffic, seed, device):\n"
        "        self.traffic = traffic\n"
        "    def setup(self):\n"
        "        pass\n"
        "    def window(self, seconds):\n"
        "        return {'decode_fps': 1.5, 'decode_p95_ms': 2.5, 'attempted': 3, 'failed': 0,\n"
        "                'about': {}}\n"
        "    def release(self):\n"
        "        pass\n"
        "    def check(self):\n"
        "        return {'frame_rms_gap': 0.0, 'frame_max_gap': 0.0}\n")
    (folder / "traffic" / "seek-b1.json").write_text(json.dumps({"kind": "seek-b1"}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "erb720-decode-bf16.seek", "config": "erb-720p",
                               "traffic": "seek-b1", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("decode_fps", "decode_p95_ms"):
            m["workloads"].append("erb720-decode-bf16.seek")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(folder / "limits" / "erb720-decode-bf16.json",
                folder / "limits" / "erb720-decode-bf16.seek.json")
    spec = Spec(tmp_path, folder)
    assert spec.driver("seek-b1").__name__ == "Mix"
    from harness import cell as run_cell

    result, _ = run_cell.run(spec, "erb720-decode-bf16.seek", 7, 1.0, False, "cpu", 0.0)
    assert result["correct"] and result["attempted"] == 3
    assert result["metrics"]["decode_fps"] == {"value": 1.5, "unit": "frames/s"}
