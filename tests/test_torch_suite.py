"""The port's multi-video suite (repnerv_tpu_torch/parallel/suite.py,
repnerv_tpu_torch/cli/suite_main.py) against the JAX package's, on the CPU
at a tiny size.

* ``suite_perms`` and ``flag_divergent`` equal the JAX functions' outputs,
  byte for byte; ``_suite_stores`` gives the JAX CLI's frames and ``t``
  for each source (synth, photo, corpus, a tree of per-video directories, a
  flat directory split).
* The port's parallel suite epoch (one ``FusedEpoch`` per video) against
  the JAX package's ``make_suite_epoch_fn`` over a ``("video",)`` mesh of 2
  virtual devices from the same per-video weights, with equal and with
  unequal lengths: per-epoch loss atol 1e-5, PSNR atol 1e-3 dB, lr rel
  1e-6, final weights within 1e-4 of each tensor's largest |value| (the
  bounds of tests/test_torch_fused_epoch.py).
* The port's parallel mode equals its sequential mode bit for bit.
* The CLI in both modes: the JAX CLI's JSON keys in its order, each row's
  ``.rnvb`` decodes to the evaluated weights, the unequal-length line, the
  fall-back to sequential, and the refit path (refit seeds, the best fit
  kept); a suite row from given weights equals the JAX CLI's row.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.cli import suite_main
from repnerv_tpu_torch.compress.bitstream import read_bitstream
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.parallel import sharding
from repnerv_tpu_torch.parallel import suite as psuite
from repnerv_tpu_torch.train import checkpoint as ckpt
from repnerv_tpu_torch.train import loop

SUITE_ARGV = (
    "--dataset synth --synthetic_frames 8 --synthetic_hw 8 8 --embed 1.25_8 "
    "--stem_dim_num 16_1 --fc_hw_dim 2_2_4 --expansion 1 --strides 2 2 "
    "--lower_width 4 -b 4 --lr 5e-3 --loss L2 --act swish --single_res --n_videos 2"
).split()


def _cfgs(**over):
    """The JAX package's tiny suite config (tests/test_model_train.py) and
    the port's copy of it."""
    from test_model_train import tiny_train
    from test_torch_config_codecs import port_train_cfg

    jcfg = tiny_train(**over)
    return jcfg, port_train_cfg(jcfg)


def _with_data(cfg, **data):
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))


# ---------------------------------------------------------------------------
# suite_perms, flag_divergent, seeds, stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames,gap,epoch", [
    (8, 1, 3),  # equal lengths
    ([5, 9], 1, 0),  # unequal: the short video cycles
    (16, 2, 5),  # frame_gap 2
    ([16, 3], 4, 0),  # a video shorter than the gap
])
def test_suite_perms_match_jax(n_frames, gap, epoch):
    from repnerv_tpu.parallel.suite import suite_perms as jax_perms

    jcfg, pcfg = _cfgs()
    jcfg, pcfg = _with_data(jcfg, frame_gap=gap), _with_data(pcfg, frame_gap=gap)
    counts = n_frames if isinstance(n_frames, list) else [n_frames] * 2
    steps = max(max(counts) // gap // jcfg.data.batch_size, 1)
    if min(counts) < gap:
        for fn, cfg in ((jax_perms, jcfg), (psuite.suite_perms, pcfg)):
            with pytest.raises(ValueError, match="frame_gap"):
                fn(cfg, 2, n_frames, steps, epoch)
        return
    ref = jax_perms(jcfg, 2, n_frames, steps, epoch)
    got = psuite.suite_perms(pcfg, 2, n_frames, steps, epoch)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("early,final", [
    ([30.0, 30.0, 29.0], [31.0, 25.0, 30.5]),  # late collapse
    ([10.0, 10.0, 10.0, 10.0], [35.86, 35.0, 34.0, 20.0]),  # early outlier
    ([7.0, 8.0], [7.5, 8.5]),  # under the floor
    ([20.0, 21.0, 19.0], [30.0, 31.0, 29.95]),  # clean
])
def test_flag_divergent_matches_jax(early, final):
    from repnerv_tpu.cli.suite_main import flag_divergent as jax_flag

    assert suite_main.flag_divergent(early, final) == jax_flag(early, final)
    assert suite_main.flag_divergent(early, final, spread_db=5.0, floor_db=9.0) == jax_flag(
        early, final, spread_db=5.0, floor_db=9.0)


@pytest.mark.parametrize("n_videos", [1, 2, 7])
def test_refit_seeds_differ_from_every_first_draw(n_videos):
    first = psuite.suite_seeds(3, n_videos)
    assert first == [3 + v for v in range(n_videos)]
    refits = [psuite.refit_seed(3, n_videos, v, a) for v in range(n_videos) for a in (1, 2, 3)]
    assert len(set(refits)) == len(refits)
    assert not set(refits) & set(first)
    with pytest.raises(ValueError):
        psuite.refit_seed(3, n_videos, 0, 0)


def _png_tree(root, lengths, hw=(8, 10)):
    """Per-video subdirectories; a pixel encodes (video, frame)."""
    from PIL import Image

    for v, n in enumerate(lengths):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(np.full((*hw, 3), 40 * v + i, np.uint8)).save(d / f"f{i:02d}.png")


@pytest.mark.parametrize("source", ["synth", "photo", "corpus", "subdirs", "flat"])
def test_suite_stores_match_jax(source, tmp_path):
    from PIL import Image

    from repnerv_tpu.cli.suite_main import _suite_stores as jax_stores

    jcfg, pcfg = _cfgs()
    if source in ("synth", "photo", "corpus"):
        data = dict(dataset=source, synthetic_frames=3, synthetic_hw=(16, 24))
    else:
        if source == "subdirs":
            _png_tree(tmp_path / "uvgtiny", [4, 3])
        else:
            (tmp_path / "uvgtiny").mkdir()
            for i in range(6):
                Image.fromarray(np.full((8, 10, 3), i, np.uint8)).save(
                    tmp_path / "uvgtiny" / f"f{i:02d}.png")
        data = dict(dataset="uvgtiny", data_dir=str(tmp_path), synthetic_frames=0,
                    cache_device=False)
    ref = jax_stores(_with_data(jcfg, **data), 2)
    got = suite_main._suite_stores(_with_data(pcfg, **data), 2, "cpu")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        frames = g.frames.numpy() if g.resident else np.asarray(g.frames)
        np.testing.assert_array_equal(frames, np.asarray(r.frames))
        np.testing.assert_array_equal(g.t, r.t)
        assert g.frame_gap == r.frame_gap
        assert g.resident == (source in ("synth", "photo", "corpus"))


# ---------------------------------------------------------------------------
# The parallel suite epoch
# ---------------------------------------------------------------------------


def _videos(cfg, lengths, hw=(8, 8)):
    return [synthetic_video(n, *hw, seed=cfg.manual_seed + v) for v, n in enumerate(lengths)]


@pytest.mark.parametrize("lengths", [[8, 8], [8, 4]])
def test_parallel_suite_epoch_matches_jax(lengths):
    """JAX: the stacked states over a ("video",) mesh of 2 virtual devices,
    the zero-padded stack, one vmapped scan an epoch.  The port: one
    FusedEpoch per video from the same weights, the same suite_perms."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repnerv_tpu.parallel.suite import (
        init_suite_states,
        make_suite_epoch_fn,
        run_suite_epoch,
        shard_suite,
    )

    jcfg, pcfg = _cfgs(epochs=3)
    vids = _videos(jcfg, lengths)
    b = jcfg.data.batch_size
    steps = max(lengths) // b
    max_n = max(lengths)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("video",))

    def pad(x):
        return np.concatenate([x, np.zeros((max_n - len(x),) + x.shape[1:], x.dtype)])

    videos = shard_suite(jnp.stack([jnp.asarray(pad(f)) for f, _ in vids]), mesh)
    t_all = shard_suite(jnp.stack([jnp.asarray(pad(t.astype(np.float32))) for _, t in vids]),
                        mesh)
    jstates = init_suite_states(jax.random.PRNGKey(jcfg.manual_seed), jcfg, 2)
    starts = [ckpt.state_from_jax_params(jax.tree.map(lambda x: np.asarray(x[v]),
                                                      jstates.params), pcfg.model)
              for v in range(2)]
    jstates = shard_suite(jstates, mesh)
    jfn = make_suite_epoch_fn(jcfg, steps, mesh=mesh)

    states = []
    for start in starts:
        model = ckpt.load_state(Generator(pcfg.model), start).train()
        states.append(loop.TrainState(model, loop.make_optimizer(pcfg, model), 0))
    stores = [FrameStore(frames=torch.from_numpy(f), t=t) for f, t in vids]
    pfn = psuite.make_suite_epoch_fn(pcfg, steps, 2)
    for epoch in range(3):
        jstates, ref = run_suite_epoch(jstates, jfn, videos, t_all, jcfg, epoch, steps, mesh,
                                       n_frames=lengths)
        states, got = psuite.run_suite_epoch(states, pfn, stores, pcfg, epoch, steps,
                                             n_frames=lengths)
        np.testing.assert_allclose(got["loss"], ref["loss"], atol=1e-5)
        np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6)
    from test_torch_train import _check_grads

    for v in range(2):
        final = {k: t.numpy() for k, t in states[v].model.state_dict().items()}
        ref_v = ckpt.state_from_jax_params(
            jax.tree.map(lambda x: np.asarray(x[v]), jstates.params), pcfg.model)
        _check_grads(final, ref_v, 1e-4)
    assert [s.step for s in states] == [3 * steps] * 2


@pytest.mark.parametrize("branch,loss", [("NeRV_vanilla", "L2"), ("ERB", "Fusion6")])
def test_parallel_mode_equals_sequential_bit_for_bit(branch, loss):
    """Equal-length videos: init_suite_states + run_suite_epoch against one
    fused epoch after the other (the sequential fit's seeds and shuffles):
    every epoch's metrics and the final weights equal to the bit."""
    from test_model_train import tiny_model

    # the SSIM of Fusion6 takes 16 x 16 frames (an 11-tap window)
    hw, fc = ((16, 16), "4_4_4") if loss == "Fusion6" else ((8, 8), "2_2_4")
    _, pcfg = _cfgs(epochs=3, loss_type=loss, model=tiny_model(branch_type=branch, fc_hw_dim=fc))
    pcfg = _with_data(pcfg, batch_size=2)
    vids = _videos(pcfg, [6, 6], hw)
    stores = [FrameStore(frames=torch.from_numpy(f), t=t) for f, t in vids]
    steps = 3
    par = psuite.init_suite_states(pcfg, 2, "cpu")
    fn = psuite.make_suite_epoch_fn(pcfg, steps, 2, with_msssim=True)
    seq = [loop.init_train_state(pcfg, "cpu", seed=s) for s in psuite.suite_seeds(pcfg.manual_seed, 2)]
    seq_fn = loop.make_epoch_fn(pcfg, steps, with_msssim=True)
    for epoch in range(3):
        par, m = psuite.run_suite_epoch(par, fn, stores, pcfg, epoch, steps)
        for v in range(2):
            vcfg = dataclasses.replace(pcfg, manual_seed=pcfg.manual_seed + v)
            seq[v], ms = loop.run_fused_epoch(seq[v], seq_fn, stores[v], vcfg, epoch)
            assert m["loss"][v] == ms.loss and m["lr"][v] == ms.lr
            np.testing.assert_array_equal(m["psnr"][v], ms.psnr)
            np.testing.assert_array_equal(m["msssim"][v], ms.msssim)
    for v, (p, s) in enumerate(zip(par, seq)):
        host = psuite.extract_video_params(par, v)
        for k, w in s.model.state_dict().items():
            assert torch.equal(p.model.state_dict()[k], w), k
            np.testing.assert_array_equal(host[k], w.numpy())


def test_video_sharding_shares_the_videos_out():
    def mesh(rank, world):
        return sharding.Mesh((world,), ("video",), rank, world, torch.device("cpu"))

    assert list(psuite.video_sharding(None, 3)) == [0, 1, 2]
    assert [list(psuite.video_sharding(mesh(r, 2), 4)) for r in range(2)] == [[0, 1], [2, 3]]
    # more ranks than videos: the first ranks a video each, the rest none
    assert [list(psuite.video_sharding(mesh(r, 4), 2)) for r in range(4)] == [[0], [1], [], []]
    assert psuite.shard_suite(["a", "b", "c", "d"], mesh(1, 2)) == ["c", "d"]
    data = sharding.Mesh((2,), ("data",), 1, 2, torch.device("cpu"))
    assert list(psuite.video_sharding(data, 2)) == [0, 1]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _check_rows_decode(result):
    """Each row's .rnvb decodes to weights whose PSNR over the video is the
    row's (the evaluated weights)."""
    for row in result["videos"]:
        state, mcfg, _ = read_bitstream(row["rnvb"])
        model = ckpt.load_state(Generator(mcfg), state)
        frames, t = synthetic_video(8, 8, 8, seed=1 + row["video"])
        store = FrameStore(frames=torch.from_numpy(frames), t=t)
        cfg = suite_main.args_to_config(suite_main.build_parser().parse_args(SUITE_ARGV[:-2]))
        cfg = dataclasses.replace(cfg, model=mcfg)
        psnr, _ = loop.evaluate(model, loop.make_eval_step(cfg, False), store, cfg)
        assert float(psnr[-1]) == row["psnr"]


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_suite_cli_table_keys_match_jax(mode, tmp_path, monkeypatch):
    """Both CLIs on the same flags (ERB, prune 0.5, 8 bits, .rnvb): the same
    JSON keys in the same order, top level and per row."""
    from repnerv_tpu.cli.suite_main import main as jax_main

    monkeypatch.chdir(tmp_path)
    argv = SUITE_ARGV + ["--branch_type", "ERB", "--prune_ratio", "0.5", "--quant_bit", "8",
                         "--save_bitstream", "-e", "4", "--suite_mode", mode]
    ref = jax_main(argv + ["--suite_out", "jax.json", "--outf", "jax"])
    got = suite_main.main(argv + ["--suite_out", "port.json", "--outf", "port",
                                  "--device", "cpu"])
    assert list(got) == list(ref)
    for g, r in zip(got["videos"], ref["videos"]):
        assert list(g) == list(r)
    assert json.load(open("port.json")) == got
    assert got["mode"] == mode and len(got["videos"]) == 2
    assert all(np.isfinite(r["psnr"]) and r["bpp"] > 0 for r in got["videos"])
    _check_rows_decode(got)


def test_suite_cli_parallel_equals_sequential(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = SUITE_ARGV + ["--branch_type", "ERB", "--quant_bit", "8", "-e", "3",
                         "--device", "cpu"]
    seq = suite_main.main(argv + ["--suite_out", "s.json"])
    par = suite_main.main(argv + ["--suite_out", "p.json", "--suite_mode", "parallel"])
    assert par["videos"] == seq["videos"]
    assert (par["mean_psnr"], par["mean_bpp"]) == (seq["mean_psnr"], seq["mean_bpp"])


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_suite_cli_unequal_lengths(mode, tmp_path, monkeypatch, capsys):
    """Per-video subdirectories of 8 and 4 frames (the UVG layout): in
    parallel mode every video runs the long video's steps, and it says so."""
    _png_tree(tmp_path / "uvgtiny", [8, 4], hw=(8, 8))
    monkeypatch.chdir(tmp_path)
    result = suite_main.main([
        "--dataset", "uvgtiny", "--data_dir", str(tmp_path), "--embed", "1.25_8",
        "--stem_dim_num", "16_1", "--fc_hw_dim", "2_2_4", "--expansion", "1",
        "--strides", "2", "2", "--lower_width", "4", "-e", "4", "-b", "4", "--lr", "5e-3",
        "--loss", "L2", "--act", "swish", "--single_res", "--branch_type", "NeRV_vanilla",
        "--n_videos", "2", "--suite_mode", mode, "--suite_out", "s.json", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert ("suite videos have unequal lengths [8, 4]" in out) == (mode == "parallel")
    assert len(result["videos"]) == 2
    assert all(np.isfinite(r["psnr"]) for r in result["videos"])


def test_suite_cli_falls_back_to_sequential(tmp_path, monkeypatch, capsys):
    """3 videos over 2 ranks do not divide: JAX's WARNING, then the
    sequential suite."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(suite_main, "maybe_initialize_distributed", lambda device: True)
    monkeypatch.setattr(suite_main, "make_mesh", lambda shape, axes, device: sharding.Mesh(
        (2,), ("video",), 0, 2, torch.device("cpu")))
    result = suite_main.main(SUITE_ARGV[:-1] + ["3", "-e", "2", "--suite_mode", "parallel",
                                                "--suite_out", "s.json", "--device", "cpu"])
    assert ("WARNING: 3 videos do not divide over 2 devices; falling back to sequential"
            in capsys.readouterr().out)
    assert result["mode"] == "sequential" and len(result["videos"]) == 3


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_suite_cli_refit_uses_refit_seeds_and_keeps_the_best(mode, tmp_path, monkeypatch):
    """A forced flag on video 1: it is refit from refit_seed(seed, 2, 1, 1),
    the better fit is kept (its train PSNR, its refit record, its weights
    in the table), and the refit stops once no flag remains."""
    monkeypatch.chdir(tmp_path)
    real_flag, real_fit = suite_main.flag_divergent, suite_main._fit_one
    calls = {"flag": 0, "seeds": [], "refit": None}

    def flag(early, final, **kw):
        calls["flag"] += 1
        return [1] if calls["flag"] == 1 else real_flag(early, final, **kw)

    def fit(cfg, store, seed, v, *args):
        model, early, final = real_fit(cfg, store, seed, v, *args)
        calls["seeds"].append((v, seed))
        if seed == psuite.refit_seed(cfg.manual_seed, 2, 1, 1):
            calls["refit"] = model
            final = 99.0
        return model, early, final

    monkeypatch.setattr(suite_main, "flag_divergent", flag)
    monkeypatch.setattr(suite_main, "_fit_one", fit)
    measured = []
    real_measure = suite_main._measure_video
    monkeypatch.setattr(suite_main, "_measure_video", lambda model, store, cfg, v, steps: (
        measured.append((v, model)) or real_measure(model, store, cfg, v, steps)))
    result = suite_main.main(SUITE_ARGV + ["-e", "10", "--suite_mode", mode,
                                           "--suite_out", "s.json", "--device", "cpu"])
    refit = psuite.refit_seed(1, 2, 1, 1)
    first = [(0, 1), (1, 2)] if mode == "sequential" else []
    assert calls["seeds"] == first + [(1, refit)]
    row = result["videos"][1]
    assert row["train_psnr"] == 99.0
    assert row["refit"]["refit_train_psnr"] == 99.0 and row["refit"]["attempts"] == 1
    assert "refit" not in result["videos"][0]
    assert dict(measured)[1] is calls["refit"]


def test_suite_row_equals_jax_from_the_same_weights(tmp_path, monkeypatch):
    """_measure_video on the same trained-state weights (ERB, prune 0.5, 8
    bits, .rnvb): the deploy first, then compress with a deploy config
    (compress(..., deploy_after=False) in the JAX package; the port's compress
    deploys no deployed model) give the JAX row: the same keys, BPP,
    efficiency and .rnvb size equal, the decoded weights within f32 rounding
    of the two deploys, PSNR within 1e-3 dB."""
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.cli.suite_main import _measure_video as jax_measure
    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.models.generator import init_generator
    from test_model_train import tiny_model

    monkeypatch.chdir(tmp_path)
    jcfg, pcfg = _cfgs(model=tiny_model(branch_type="ERB"))
    over = dict(prune_ratio=0.5, quant_bit=8, save_bitstream=True)
    jcfg = dataclasses.replace(jcfg, outf="jax", **over)
    pcfg = dataclasses.replace(pcfg, outf="port", **over)
    params = init_generator(jax.random.PRNGKey(4), jcfg.model)
    frames, t = synthetic_video(8, 8, 8, seed=1)
    ref = jax_measure(params, JStore(jnp.asarray(frames), t, 1), jcfg, 0)
    model = ckpt.load_state(Generator(pcfg.model),
                            ckpt.state_from_jax_params(jax.tree.map(np.asarray, params),
                                                       pcfg.model)).train()
    got = suite_main._measure_video(model, FrameStore(torch.from_numpy(frames), t), pcfg, 0)
    assert list(got) == list(ref)
    for k in ("video", "bpp", "efficiency", "rnvb_bytes", "bpp_all_in"):
        assert got[k] == ref[k], k
    # the two deploys sum the branches in other f32 orders: the decoded
    # weights within 1e-6 of each tensor's largest |value|
    mine, _, _ = read_bitstream(got["rnvb"])
    theirs, _, _ = read_bitstream(ref["rnvb"])
    assert list(mine) == list(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(mine[k], v, rtol=0, atol=1e-6 * max(np.abs(v).max(), 1e-30))
    assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-3)


def test_suite_cli_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        suite_main.main(SUITE_ARGV + ["-e", "1"])
