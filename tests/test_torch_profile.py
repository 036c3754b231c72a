"""``--profile`` and ``utils/profiling.py::trace`` of the port against the JAX
package's, on the CPU at a tiny size.

* ``trace`` writes a trace file under its directory, as the JAX package's
  does (``tests/test_runtime.py::test_profiler_trace_writes``); it raises
  when asked for a card that is absent, and when the kernel wrappers
  launched and the written trace holds no kernel;
* the JAX train CLI and the port's, with the same argv and ``--profile``,
  follow the same schedule: the traced first epoch writes no epoch line,
  eval or checkpoint, the "profiler trace written" line, the same epoch and
  eval lines and learning rates after it, the same step counter and the
  same files, with a trace under ``<outf>/profile`` in both (the weights
  start from other generators, so PSNRs are not compared);
* tracing changes no number: the traced epoch leaves the weights and Adam's
  state equal to the bit to ``run_epoch(..., max_steps=3)`` untraced; its
  log names the top program spans by device, idle and host time;
* under ``--mesh_shape 1`` (a gloo world of one) the traced run equals the
  run without the mesh, and its trace file names rank 0.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repnerv_tpu_torch.cli import train_main
from repnerv_tpu_torch.cli.args import args_to_config, build_parser
from repnerv_tpu_torch.data.frames import make_frame_store
from repnerv_tpu_torch.kernels import ssim_blur
from repnerv_tpu_torch.train.loop import init_train_state, make_train_step, run_epoch
from repnerv_tpu_torch.utils import profiling
from repnerv_tpu_torch.utils.profiling import kernel_events, trace

FLAGS = (
    "--dataset synth --synthetic_hw 24 32 --embed 1.25_4 --stem_dim_num 16_1 "
    "--fc_hw_dim 3_4_6 --expansion 1 --strides 2 2 2 --lower_width 4 --branch_type ERB "
    "--act swish --single_res --loss Fusion6 -b 1 --lr 5e-3 -e 3 --profile --outf run"
).split()


def _files(root):
    return [f for _, _, files in os.walk(root) for f in files]


def test_trace_writes_a_trace_file_like_jax(tmp_path):
    """The port's trace on the CPU writes one ``*.pt.trace.json`` of the
    block's ops under its directory, where the JAX package's writes its
    ``plugins/profile`` files; no launches, no kernel count off the card."""
    import jax.numpy as jnp

    from repnerv_tpu.utils.profiling import trace as jtrace

    with jtrace(str(tmp_path / "jax")):
        jnp.sum(jnp.ones((32, 32))).block_until_ready()
    with trace(str(tmp_path / "port"), "cpu") as rec:
        torch.ones(32, 32).sum()
    assert _files(tmp_path / "jax") and _files(tmp_path / "port")
    assert os.listdir(tmp_path / "port") == [os.path.basename(rec.path)]
    assert rec.path.endswith(".pt.trace.json") and os.path.getsize(rec.path) > 0
    assert rec.launched == 0 and rec.kernels is None
    assert any("aten::sum" in e.key for e in rec.profiler.key_averages())
    assert kernel_events(rec.path) == {}  # the host's ops only


def test_trace_needs_a_card_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path), "cuda"):
            pass
    assert not os.path.exists(tmp_path / "profile")


def test_trace_refuses_a_trace_without_kernels(tmp_path, monkeypatch):
    """On a card, a block whose wrappers launched and whose written trace
    holds no kernel event raises and names both counts (here the profiler
    of a CPU build records no kernel and one K5 launch is counted)."""
    monkeypatch.setattr(profiling, "_cuda_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(profiling, "_prime", lambda device: None)  # fills on a card
    with pytest.warns(UserWarning, match="CUDA"):  # the CPU build's profiler says so
        with pytest.raises(RuntimeError, match=r"no kernel event.*launched 1 kernels"):
            with trace(str(tmp_path), "cuda"):
                ssim_blur.LAUNCHES += 1
    ssim_blur.LAUNCHES -= 1
    assert len(_files(tmp_path)) == 1  # the file is written, and refused
    with pytest.warns(UserWarning, match="CUDA"):
        with trace(str(tmp_path), "cuda") as rec:  # nothing launched: no claim to check
            torch.ones(3).sum()
    assert rec.launched == 0 and rec.kernels == {}


def _log(outf):
    return open(os.path.join(outf, "rank0.txt")).read().splitlines()


def _schedule(lines):
    """The log's schedule: each epoch line's ``Epoch[k/E] lr:x``, each eval
    line's ``Eval at epoch k``, and the profiler line."""
    out = []
    for line in lines:
        if "Epoch[" in line:
            out.append(re.search(r"Epoch\[\d+/\d+\] lr:\S+", line).group())
        elif line.startswith("Eval at epoch"):
            out.append(line.split(":")[0])
        elif line.startswith("profiler trace written"):
            out.append(line)
    return out


# (flags, frames, traced steps, steps an epoch): a step a frame at -b 1;
# --debug: 10 at most, traced or not
@pytest.mark.parametrize("extra,frames,traced,steps", [([], 4, 3, 4), (["--debug"], 12, 10, 10)])
def test_train_cli_profile_follows_the_jax_schedule(tmp_path, monkeypatch, extra, frames,
                                                     traced, steps):
    from repnerv_tpu.cli import train_main as jtrain
    from repnerv_tpu.train import checkpoint as jckpt

    monkeypatch.chdir(tmp_path)
    argv = FLAGS + ["--synthetic_frames", str(frames)] + extra
    jtrain.main(argv)
    outf = os.path.join("result", "debug" if extra else "run")
    jax_log, jax_files = _log(outf), sorted(os.listdir(outf))
    jax_step = int(jckpt.load_orbax(outf, "orbax_latest", None)["step"])
    assert _files(os.path.join(outf, "profile"))
    os.rename(outf, outf + "_jax")

    res = train_main.main(argv + ["--device", "cpu"])
    assert res["outf"] == outf
    log = _log(outf)
    assert _schedule(log) == _schedule(jax_log)
    assert f"profiler trace written to {outf}/profile" in log
    assert [h["epoch"] for h in res["history"]] == [2, 3]  # epoch 1 is the traced one
    assert not any("Epoch[1/3]" in line or line.startswith("Eval at epoch 1:") for line in log)
    assert res["state"].step == jax_step == traced + 2 * steps
    assert sorted(os.listdir(outf)) == sorted(
        ["resume_latest.pt" if f == "orbax_latest" else f for f in jax_files])
    written = os.listdir(os.path.join(outf, "profile"))
    assert len(written) == 1 and written[0].endswith(".pt.trace.json")


def _config(argv):
    return args_to_config(build_parser(eval_mode=False).parse_args(argv), eval_mode=False)


def test_traced_epoch_changes_no_number(tmp_path, monkeypatch):
    """``-e 1 --profile``: the run is the traced epoch alone; its weights
    and Adam state equal an untraced ``run_epoch(..., max_steps=3)`` from the
    same seed, to the bit."""
    monkeypatch.chdir(tmp_path)
    argv = FLAGS + ["--synthetic_frames", "4", "-e", "1"]
    res = train_main.main(argv + ["--device", "cpu"])
    assert res["history"] == [] and res["state"].step == 3
    assert not os.path.exists(os.path.join(res["outf"], "model_latest.pth"))
    # the log names the top program spans; on the CPU no device time, no idle
    (line,) = [x for x in _log(res["outf"]) if x.startswith("profiled spans ")]
    host = line.split("by host ms: ")[1].split(", ")
    assert line.startswith("profiled spans by device ms: none; by idle ms: none; by host ms: ")
    assert len(host) == 5 and {h.rsplit(" ", 1)[0] for h in host} >= {"step.backward"}
    assert all(float(h.rsplit(" ", 1)[1]) > 0 for h in host)

    cfg = _config(argv)
    store = make_frame_store(cfg.data, "cpu", split="train")
    state = init_train_state(cfg, "cpu")
    step = make_train_step(cfg, store.num_samples, with_msssim=False)
    state, _ = run_epoch(state, step, store, cfg, 0, max_steps=3)
    assert state.step == 3
    got = res["state"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    ref_opt, got_opt = state.optimizer.state_dict(), got.optimizer.state_dict()
    assert ref_opt["param_groups"] == got_opt["param_groups"]
    for i, moments in ref_opt["state"].items():
        for k, v in moments.items():
            assert torch.equal(got_opt["state"][i][k], v), (i, k)


def test_profile_over_a_world_of_one(tmp_path, monkeypatch):
    """``--mesh_shape 1 --profile``: a gloo world of one traces on rank 0
    (its file says so) and trains what the run without the mesh trains."""
    assert not dist.is_initialized()
    monkeypatch.chdir(tmp_path)
    argv = FLAGS + ["--synthetic_frames", "4", "--device", "cpu"]
    plain = train_main.main(argv + ["--outf", "plain"])
    mesh1 = train_main.main(argv + ["--outf", "mesh", "--mesh_shape", "1"])
    assert not dist.is_initialized()
    assert mesh1["history"] == plain["history"] and mesh1["state"].step == 11
    for k, v in plain["state"].model.state_dict().items():
        assert torch.equal(mesh1["state"].model.state_dict()[k], v), k
    (name,) = os.listdir(os.path.join(mesh1["outf"], "profile"))
    assert re.search(r"_rank0\.\d+\.pt\.trace\.json$", name)
    assert "_rank" not in os.listdir(os.path.join(plain["outf"], "profile"))[0]


@pytest.mark.gpu
def test_trace_on_the_card_holds_every_launched_kernel(tmp_path):
    """On the card: K5 launched 5 times in a traced block, and the written
    trace holds its 5 kernel events."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K5 kernel and CUPTI's kernel events")
    img = torch.rand(1, 720, 1280, device="cuda")
    win = ssim_blur.window_tuple(11, 1.5)
    ssim_blur.moments_forward(img, img, win)  # build and warm up
    with trace(str(tmp_path), "cuda") as rec:
        for _ in range(5):
            ssim_blur.moments_forward(img, img, win)
    assert rec.launched == 5
    assert sum(n for k, n in rec.kernels.items() if "blur_tiles" in k) == 5
    assert np.isfinite(rec.profiler.key_averages().total_average().cpu_time_total)
