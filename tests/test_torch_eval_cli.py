"""The port's eval / compress CLI (repnerv_tpu_torch/cli/eval_main.py)
against the JAX package's, on the CPU at a tiny size.

A tiny ERB model is trained once through the port's train CLI; then both
eval CLIs run on that result directory with the same flags, and their
result lines (the JSON line each appends to its result file), ``.rnvb``
bytes, PNG dumps and ``rd_sweep.json`` are compared.  The fps numbers are
device metrics: on the port they are stubbed (the measurement raises off
the card), and not compared.  Tolerances:

* PATH B and ``--rd_sweep`` (the same weights on both sides): BPP,
  efficiency and the bitstream bytes equal; PSNR within 1e-3 dB (f32
  forwards summing in other orders); PNGs within one 8-bit level;
* ``--decode_int8``: PSNR within 1e-2 dB (an int8 count may differ at a .5
  boundary, tests/test_torch_decode_int8.py);
* PATH A (2 masked finetune epochs whose sums run in another order): PSNR
  within 1e-3 dB, the 2-epoch trajectory test's bound
  (tests/test_torch_train.py); BPP within 1% (a finetuned weight that sits
  on a code boundary may land on the neighbouring code and change its
  Huffman length).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from repnerv_tpu_torch.cli import eval_main, train_main

# 8 frames: the JAX eval CLI's fps measurement needs at least one decode
# batch (8) of val frames (ROADMAP C10)
ARGV = (
    "--dataset synth --synthetic_frames 8 --synthetic_hw 24 32 --embed 1.25_4 "
    "--stem_dim_num 16_1 --fc_hw_dim 3_4_6 --expansion 1 --strides 2 2 2 "
    "--lower_width 4 --branch_type ERB --act swish --single_res --loss Fusion6 "
    "-b 1 --lr 5e-3 -e 2 --outf run"
).split()
OUTF = os.path.join("result", "run")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalcli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        train_main.main(ARGV + ["--device", "cpu"])
    finally:
        os.chdir(cwd)
    return root


@pytest.fixture
def in_run(trained, monkeypatch):
    monkeypatch.chdir(trained)
    monkeypatch.setattr(eval_main, "measure_decode_fps", lambda *a, **k: 1.0)
    monkeypatch.setattr(eval_main, "measure_micro_fps", lambda *a, **k: 1.0)
    return trained


def _last_result(pattern):
    files = glob.glob(os.path.join(OUTF, pattern))
    assert len(files) == 1, files
    return json.loads(open(files[0]).read().strip().splitlines()[-1])


def _both(argv, pattern):
    """Run the JAX CLI, then the port's, on the same directory: (jax result,
    port result, jax artifact bytes or None)."""
    from repnerv_tpu.cli import eval_main as jeval

    jeval.main(ARGV + argv)
    ref = _last_result(pattern)
    art = glob.glob(os.path.join(OUTF, "*.rnvb"))
    ref_bytes = {p: open(p, "rb").read() for p in art}
    got = eval_main.main(ARGV + argv + ["--device", "cpu"])
    assert got == _last_result(pattern)  # the port appended its own line
    return ref, got, ref_bytes


def _png(d, i):
    return np.asarray(Image.open(os.path.join(d, f"pred_{i}.png")), np.int32)


def test_path_b_bitstream_and_dump_match_jax(in_run):
    argv = ["--prune_ratio", "0.2", "--quant_bit", "8", "--save_bitstream", "--dump_images",
            "--dump_gt"]
    from repnerv_tpu.cli import eval_main as jeval

    jeval.main(ARGV + argv)
    ref = _last_result("only_prune0.20_quant8.txt")
    art = os.path.join(OUTF, "model_pr0.20_q8.rnvb")
    ref_bytes = open(art, "rb").read()
    vis = os.path.join(OUTF, "visualize")
    ref_png = [_png(vis, i) for i in range(8)]
    got = eval_main.main(ARGV + argv + ["--device", "cpu"])
    assert got == _last_result("only_prune0.20_quant8.txt")
    assert open(art, "rb").read() == ref_bytes
    for k in ("prune_ratio", "quant_bit", "avg_bits", "efficiency", "bpp", "bitstream_bytes",
              "bpp_all_in", "macs_g"):
        assert got[k] == ref[k], k
    assert got["val_psnr"][-1] == pytest.approx(ref["val_psnr"][-1], abs=1e-3)
    for i in range(8):
        assert np.abs(_png(vis, i) - ref_png[i]).max() <= 1
        assert os.path.exists(os.path.join(vis, f"gt_{i}.png"))


def test_decode_int8_matches_jax(in_run, monkeypatch):
    import repnerv_tpu.models.generator as jgen
    import repnerv_tpu.pallas_kernels.decode_int8 as d8

    orig = d8.fused_conv_ps_act_int8
    monkeypatch.setattr(d8, "fused_conv_ps_act_int8",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)
    from repnerv_tpu_torch.kernels import decode_int8 as k8

    calls = []
    real = k8.decode_stage_int8
    monkeypatch.setattr(k8, "decode_stage_int8", lambda *a, **k: calls.append(1) or real(*a, **k))
    argv = ["--prune_ratio", "0.4", "--quant_bit", "6", "--decode_int8"]
    ref, got, _ = _both(argv, "only_prune0.40_quant6.txt")
    assert calls  # the port's evaluation went through the int8 stage
    assert got["bpp"] == ref["bpp"] and got["efficiency"] == ref["efficiency"]
    assert got["val_psnr"][-1] == pytest.approx(ref["val_psnr"][-1], abs=1e-2)


def test_path_a_finetune_matches_jax(in_run):
    argv = ["--prune_ratio", "0.3", "--quant_bit", "8", "--finetune", "--finetune_epochs", "2"]
    ref, got, _ = _both(argv, "finetune_e2_pr0.30_q8.txt")
    assert got["prune_ratio"] == ref["prune_ratio"]
    assert got["val_psnr"][-1] == pytest.approx(ref["val_psnr"][-1], abs=1e-3)
    assert got["bpp"] == pytest.approx(ref["bpp"], rel=1e-2)


def test_rd_sweep_matches_jax(in_run):
    from repnerv_tpu.cli import eval_main as jeval

    argv = ["--rd_sweep", "--rd_prune_ratios", "1.0", "0.4", "--rd_quant_bits", "8", "4"]
    ref = jeval.main(ARGV + argv)
    got = eval_main.main(ARGV + argv + ["--device", "cpu"])
    assert json.load(open(os.path.join(OUTF, "rd_sweep.json"))) == got
    assert len(got["rows"]) == len(ref["rows"]) == 4
    for g, r in zip(got["rows"], ref["rows"]):
        for k in ("prune_ratio", "prune_actual", "quant_bit", "bpp", "efficiency"):
            assert g[k] == r[k], k
        assert g["psnr"] == pytest.approx(r["psnr"], abs=1e-3)


@pytest.mark.parametrize(
    "extra,row",
    [
        (["--mesh_shape", "2"], "A8"),
        (["--host_budget_mb", "64"], "A7"),
        (["--dataset", "corpus"], "A7"),
        (["--finetune", "--compute_dtype", "mixed"], "A1"),
    ],
)
def test_eval_cli_refuses_later_slices(tmp_path, monkeypatch, capsys, extra, row):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        eval_main.main(ARGV + extra + ["--device", "cpu"])
    assert e.value.code == 2
    assert row in capsys.readouterr().err


def test_eval_cli_needs_a_card_by_default(in_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_main.main(ARGV + ["--prune_ratio", "0.2", "--quant_bit", "8"])
    # and the fps measurements fail off the card instead of timing the CPU
    monkeypatch.undo()
    from repnerv_tpu_torch.models.generator import Generator
    from repnerv_tpu_torch.train.loop import measure_decode_fps

    cfg = train_main.args_to_config(train_main.build_parser().parse_args(ARGV))
    gen = Generator(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_main.measure_micro_fps(gen, cfg, torch.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_decode_fps(gen, cfg, np.zeros(2, np.float32), 2)
