"""The quality recipe of ROADMAP C14 (repnerv_tpu_torch/tools/quality.py) on
the CPU: its flags are the JAX package's README quick start on the
synthetic video, and the tool reads back what the port's train CLI logs.
The 300-epoch runs themselves need the card (PERF.md, "Quality on the
card"; chip_smoke.py phase 12)."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repnerv_tpu.cli.args as jargs
import repnerv_tpu_torch.cli.args as pargs
from repnerv_tpu_torch.cli import train_main
from repnerv_tpu_torch.tools import quality

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# README.md's quick start (the paper config), on the synthetic video
QUICK_START = (
    "-e 300 --lower_width 96 --num_blocks 1 --dataset synth --frame_gap 1 --embed 1.25_40 "
    "--stem_dim_num 512_1 --reduction 2 --fc_hw_dim 9_16_26 --expansion 1 --single_res "
    "--loss Fusion6 --warmup 0.2 --lr_type cosine --strides 5 2 2 2 2 --conv_type conv -b 1 "
    "--lr 0.0005 --norm none --act swish --branch_type ERB"
).split()
# what the C14 runs add to it: the 132-frame video, bf16, BENCHMARKS.md's
# checkpoint cadence
ADDED = {"synthetic_frames": 132, "compute_dtype": "bfloat16", "ckpt_freq": 25, "eval_freq": 25}
TINY = ("--synthetic_frames 3 --synthetic_hw 24 32 --embed 1.25_4 --stem_dim_num 16_1 "
        "--fc_hw_dim 3_4_6 --strides 2 2 2 --lower_width 4 -e 6 --device cpu "
        "--compute_dtype float32")


@pytest.mark.parametrize("branch", ["ERB", "NeRV_vanilla"])
def test_recipe_is_the_jax_quick_start(branch):
    """The recipe's config, through the port's parser, is the JAX parser's
    config of the quick start with only the four C14 additions changed."""
    jcfg = jargs.args_to_config(jargs.build_parser().parse_args(
        QUICK_START + ["--branch_type", branch]))
    pa = pargs.build_parser().parse_args(quality.RECIPE + ["--branch_type", branch])
    pcfg = pargs.args_to_config(pa)
    want = dataclasses.asdict(jcfg)
    want["model"]["compute_dtype"] = ADDED["compute_dtype"]
    want["data"]["synthetic_frames"] = ADDED["synthetic_frames"]
    want["ckpt_freq"], want["eval_freq"] = ADDED["ckpt_freq"], ADDED["eval_freq"]
    assert dataclasses.asdict(pcfg) == want
    assert pa.manualSeed == 1 and pcfg.manual_seed == 1


def test_parse_rank0_reads_the_train_clis_lines(tmp_path, monkeypatch):
    """Every epoch's lr and last-stage train PSNR / MS-SSIM and every
    evaluation of a train_main run, as the CLI logged them (2 decimals)."""
    monkeypatch.chdir(tmp_path)
    argv = (quality.RECIPE + ["--branch_type", "ERB", "--outf", "q", "--stop_epoch", "3"]
            + TINY.split())
    res = train_main.main(argv)
    got = quality.parse_rank0(os.path.join(res["outf"], "rank0.txt"))
    assert sorted(got["epochs"]) == [1, 2, 3]
    for h in res["history"]:
        e = got["epochs"][h["epoch"]]
        assert e["psnr"] == round(h["psnr"][-1], 2)
        assert e["lr"] == pytest.approx(h["lr"], rel=1e-2)
        assert e["s"] >= 0
    assert sorted(got["evals"]) == [1, 2, 3]  # -e 6: the last 10 epochs evaluate


def test_quality_tool_runs_the_recipe_and_writes_its_summary(tmp_path):
    """The tool's train run (a) as a process of the port's CLI, stopped at
    epoch 2 of the schedule, twice: one summary entry a repeat, equal
    histories (the CPU's arithmetic is the same both times)."""
    out = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-m", "repnerv_tpu_torch.tools.quality", "--work", "w",
                    "--out", str(out), "--runs", "a", "--stop_epoch", "2", "--repeats", "2",
                    f"--extra={TINY}"], cwd=tmp_path, env=env, check=True, timeout=300,
                   capture_output=True)
    summary = json.loads(out.read_text())
    assert set(summary["runs"]) == {"a_s1_r0", "a_s1_r1"}
    r0, r1 = summary["runs"]["a_s1_r0"], summary["runs"]["a_s1_r1"]
    assert sorted(r0["epochs"]) == ["1", "2"]
    for k in ("1", "2"):
        for key in ("lr", "psnr", "msssim"):
            assert r0["epochs"][k][key] == r1["epochs"][k][key], (k, key)
    assert r0["wall_s"] > 0
    assert "--stop_epoch" not in r0["argv"] and r0["argv"][-len(TINY.split()):] == TINY.split()
