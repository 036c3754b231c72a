"""The port's train CLI (repnerv_tpu_torch/cli/train_main.py) on the CPU at a
tiny size: the rank0 log in the JAX package's line format (read back by the
repo's own collector, tools/outofcore_metal.py), the .pth files, a deploy
snapshot that the port's decode path loads and that equals the trained
model, resume, and the flags of later slices refused."""

import importlib.util
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.cli import train_main
from repnerv_tpu_torch.config import ModelConfig
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = (
    "--dataset synth --synthetic_frames 4 --synthetic_hw 24 32 --embed 1.25_4 "
    "--stem_dim_num 16_1 --fc_hw_dim 3_4_6 --expansion 1 --strides 2 2 2 "
    "--lower_width 4 --branch_type ERB --act swish --single_res --loss Fusion6 "
    "-b 1 --lr 5e-3 --device cpu --outf run"
).split()


def _collector():
    spec = importlib.util.spec_from_file_location(
        "ooc_metal", os.path.join(REPO, "tools", "outofcore_metal.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_logs_checkpoints_deploys_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes under result/<outf>
    res = train_main.main(ARGV + ["-e", "2"])
    outf = res["outf"]
    assert outf == os.path.join("result", "run")
    assert [h["epoch"] for h in res["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in res["history"])

    log = open(os.path.join(outf, "rank0.txt")).read()
    assert "Model Params:" in log and "MACs:" in log and "Training complete in:" in log
    assert "Deploy Rep-Model Params:" in log
    row = _collector().parse_log(log)
    assert row["final_train_psnr"] == pytest.approx(res["history"][-1]["psnr"][-1], abs=0.01)
    assert row["final_eval_psnr"] is not None

    for name in ("model_latest.pth", "model_train_best.pth", "model_val_best.pth",
                 "model_latest_deploy.pth", "model_train_best_deploy.pth", ckpt.RESUME_FILE):
        assert os.path.exists(os.path.join(outf, name)), name
    state, extra = ckpt.load_pth(os.path.join(outf, "model_latest.pth"))
    assert extra["epoch"] == 2 and "val_best_psnr" in extra

    # the deploy snapshot loads into a deploy generator and decodes the same
    # frames as the trained model
    cfg = res["state"].model.cfg
    dep_state, _ = ckpt.load_pth(os.path.join(outf, "model_latest_deploy.pth"))
    dep = ckpt.load_state(Generator(ModelConfig(**{**cfg.__dict__, "deploy": True})), dep_state)
    trained = ckpt.load_state(Generator(cfg), state)
    emb = positional_encoding(torch.tensor([0.0, 0.5]), cfg.embed)
    with torch.no_grad():
        np.testing.assert_allclose(dep(emb)[-1].numpy(), trained(emb)[-1].numpy(), atol=1e-5)

    # resume: a rerun with more epochs continues from the saved epoch and step
    res2 = train_main.main(ARGV + ["-e", "3"])
    assert [h["epoch"] for h in res2["history"]] == [3]
    assert res2["state"].step == 12
    assert "Epoch[3/3]" in open(os.path.join(outf, "rank0.txt")).read()


@pytest.mark.parametrize(
    "extra,row",
    [
        (["--mesh_shape", "2"], "torchrun --nproc_per_node 2"),
    ],
)
def test_train_cli_refuses_later_slices(tmp_path, monkeypatch, capsys, extra, row):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        train_main.main(ARGV + ["-e", "1"] + extra)
    assert e.value.code == 2
    assert row in capsys.readouterr().err
    assert not os.path.exists("result")


@pytest.mark.parametrize("extra", [["--compute_dtype", "mixed"],
                                   ["--compute_dtype", "mixed", "--remat"]])
def test_train_cli_trains_in_mixed(tmp_path, monkeypatch, extra):
    """--compute_dtype mixed trains to the end through the fused epoch (it
    was refused before the port had its custom VJPs): finite losses, the
    .pth files, and the same history as the eager epoch runner's."""
    monkeypatch.chdir(tmp_path)
    res = train_main.main(ARGV + ["-e", "2"] + extra)
    hist = res["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["psnr"][-1]) for h in hist)
    assert res["state"].model.cfg.compute_dtype == "mixed"
    for name in ("model_latest.pth", "model_latest_deploy.pth", ckpt.RESUME_FILE):
        assert os.path.exists(os.path.join(res["outf"], name)), name

    real = train_main.run_training
    monkeypatch.setattr(train_main, "run_training",
                        lambda cfg, device, *rest: real(replace(cfg, fused_epoch=False), device,
                                                        *rest))
    eager = train_main.main(ARGV + ["-e", "2", "--outf", "eager"] + extra)["history"]
    assert [(h["loss"], h["psnr"]) for h in eager] == [(h["loss"], h["psnr"]) for h in hist]


def test_train_cli_stop_epoch_is_the_whole_runs_start(tmp_path, monkeypatch):
    """--stop_epoch 2 of -e 4 trains the first two epochs of the 4-epoch
    schedule (the same learning rates, losses and PSNRs as the whole run's
    first two, to the bit), writes the checkpoint and the resume file at
    epoch 2, and the same command without the flag resumes to epoch 4."""
    monkeypatch.chdir(tmp_path)
    whole = train_main.main(ARGV + ["-e", "4", "--outf", "whole"])["history"]
    part = train_main.main(ARGV + ["-e", "4", "--outf", "part", "--stop_epoch", "2"])
    assert [h["epoch"] for h in part["history"]] == [1, 2]
    assert part["history"] == whole[:2]
    _, extra = ckpt.load_pth(os.path.join(part["outf"], "model_latest.pth"))
    assert extra["epoch"] == 2
    assert os.path.exists(os.path.join(part["outf"], ckpt.RESUME_FILE))
    log = open(os.path.join(part["outf"], "rank0.txt")).read()
    assert "Epoch[2/4]" in log and "Epoch[3/4]" not in log
    rest = train_main.main(ARGV + ["-e", "4", "--outf", "part"])
    assert [h["epoch"] for h in rest["history"]] == [3, 4]
    assert rest["state"].step == 16


def test_train_cli_needs_a_card_by_default(tmp_path, monkeypatch):
    """--device defaults to cuda: without a card the CLI raises, naming
    CUDA, instead of training on the CPU, and writes nothing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    assert len(argv) == len(ARGV) - 2
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.main(argv + ["-e", "1"])
    assert not os.path.exists("result")
