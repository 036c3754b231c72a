"""The port's out-of-core frame ladder (repnerv_tpu_torch/data/frames.py
``make_frame_store``, ``DirFrames``; train/loop.py ``make_streaming_epoch_fn``)
and its photo and corpus generators, case by case as tests/test_outofcore.py
drives the JAX package's, at that file's tiny sizes.

The ladder: 1. the video fits the device budget -> a uint8 tensor on the
device; 2. over it (or ``cache_device`` off) -> a host array; 3. a frame
directory over ``host_budget_mb`` -> ``DirFrames`` (decoded from disk).

Bounds:
* the streaming epoch against the port's resident epoch, and every run from
  a host or disk store against the same run from a resident store: equal
  bits (the step reads the same uint8 frames and runs the same operations);
* against the JAX streaming epoch: the bounds of
  tests/test_torch_fused_epoch.py (per-epoch loss atol 1e-5, PSNR atol 1e-3
  dB, lr rtol 1e-6, final weights within 1e-4 of each tensor's largest
  |value|);
* the photo and corpus videos, ``DirFrames``: equal bytes.

The ``gpu`` test needs the card (the CUDA graph, the side-stream copies); it
skips here and runs on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_outofcore.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data import frames as tframes
from repnerv_tpu_torch.data.frames import DirFrames, FrameStore, synthetic_video
from repnerv_tpu_torch.train import loop

from test_torch_fused_epoch import (  # noqa: F401  (fixtures)
    CARD,
    _check_trajectory,
    _jax_setup,
    cuda,
    kernel_gates,
)

TINY = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                   lower_width=4, branch_type="ERB")
# 160x192 frames: a model whose output is the frame size (tests/test_outofcore.py)
DISK = dict(fc_hw_dim="5_6_8", strides=(4, 4, 2), lower_width=6)


def _cfg(dtype="float32", batch_size=1, model=TINY, **data) -> TrainConfig:
    return TrainConfig(model=dataclasses.replace(model, compute_dtype=dtype),
                       data=DataConfig(batch_size=batch_size, **data), epochs=2, warmup=0.5,
                       lr=5e-3, loss_type="Fusion6")


def _weights(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _assert_same_weights(a, b):
    wa, wb = _weights(a), _weights(b)
    for k, v in wa.items():
        assert torch.equal(wb[k], v), k


def _write_frame_dir(root, frames, name="lazyvid"):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(os.path.join(d, f"f{i:04d}.png"))
    return d


# ---------------------------------------------------------------------------
# The ladder's rungs, and DirFrames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,rung", [
    ("small video", 1),  # 8 x 12 x 16 x 3 = 4.6 KiB < 1 MiB
    ("large video", 2),  # 8 x 256 x 512 x 3 = 3 MiB > 1 MiB
    ("cache_device off", 2),
    ("frame dir over host budget", 3),
])
def test_make_frame_store_picks_the_rung_as_jax(tmp_path, case, rung):
    import jax

    from repnerv_tpu.config import DataConfig as JaxDataConfig
    from repnerv_tpu.data import frames as jframes

    kw = dict(dataset="synth", data_dir=str(tmp_path), synthetic_frames=8,
              synthetic_hw=(12, 16), hbm_budget_mb=1)
    if case == "large video":
        kw["synthetic_hw"] = (256, 512)
    elif case == "cache_device off":
        kw["cache_device"] = False
    elif case == "frame dir over host budget":
        _write_frame_dir(tmp_path, synthetic_video(6, 256, 512, seed=3)[0])
        kw.update(dataset="lazyvid", host_budget_mb=1)
    store = tframes.make_frame_store(DataConfig(**kw), "cpu")
    ref = jframes.make_frame_store(JaxDataConfig(**kw))
    port_rung = 1 if store.resident else 2 if isinstance(store.frames, np.ndarray) else 3
    jax_rung = (1 if isinstance(ref.frames, jax.Array)
                else 2 if isinstance(ref.frames, np.ndarray) else 3)
    assert port_rung == jax_rung == rung
    assert store.frames.shape == tuple(ref.frames.shape)
    rows = np.array([5, 0, 3])
    got = store.frames[torch.from_numpy(rows)].numpy() if store.resident else store.frames[rows]
    np.testing.assert_array_equal(got, np.asarray(ref.frames[rows]))
    np.testing.assert_array_equal(store.t, ref.t)
    np.testing.assert_array_equal(store.gather(rows).numpy(), np.asarray(ref.gather(rows)))


def test_dirframes_lazy_equals_eager_and_jax(tmp_path):
    from repnerv_tpu.data import frames as jframes

    # 6 frames at 256x512 = 2.25 MiB decoded > the 1 MiB host budget; one
    # portrait frame is stored transposed and read back as landscape
    frames, _ = synthetic_video(6, 256, 512, seed=3)
    d = _write_frame_dir(tmp_path, frames)
    Image.fromarray(frames[4].transpose(1, 0, 2).copy()).save(os.path.join(d, "f0004.png"))
    cfg = DataConfig(dataset="lazyvid", data_dir=str(tmp_path))
    eager = tframes.make_frame_store(dataclasses.replace(cfg, hbm_budget_mb=0), "cpu")
    lazy = tframes.make_frame_store(dataclasses.replace(cfg, host_budget_mb=1), "cpu")
    assert isinstance(lazy.frames, DirFrames) and len(lazy.frames) == 6
    assert lazy.frames.shape == tuple(eager.frames.shape) and lazy.frames.nbytes == frames.nbytes
    paths, _ = tframes.list_frame_paths(d)
    ref = jframes.DirFrames(paths)
    rows = np.array([0, 3, 5, 4])
    np.testing.assert_array_equal(lazy.frames[rows], eager.frames.numpy()[rows])
    np.testing.assert_array_equal(lazy.frames[rows], ref[rows])
    np.testing.assert_array_equal(lazy.frames[2], ref[2])
    np.testing.assert_array_equal(lazy.frames[4], frames[4])
    np.testing.assert_array_equal(lazy.t, eager.t)
    np.testing.assert_array_equal(lazy.frame(1), frames[1])
    np.testing.assert_array_equal(lazy.gather(rows).numpy(), eager.gather(rows).numpy())


# ---------------------------------------------------------------------------
# The streaming epoch
# ---------------------------------------------------------------------------

# (stream_chunk_mb, frame size, chunks an epoch): 0 floors the chunk at one
# step (a chunk edge at every step, the ring of 2 reused at every other);
# 192 x 512 frames at -b 1 put 3 steps in 1 MiB: chunks of 3, 3, 2, the
# third reusing the first's ring slots
CHUNKINGS = {"one-step chunks": (0, (12, 16), 8), "short last chunk": (1, (192, 512), 3)}


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_epoch_equals_resident_epoch_bit_for_bit(dtype, chunking):
    """Equal bits after 2 epochs: every epoch's metrics and the weights."""
    chunk_mb, hw, n_chunks = CHUNKINGS[chunking]
    cfg = _cfg(dtype, stream_chunk_mb=chunk_mb)
    video, t = synthetic_video(8, *hw, seed=2)
    device_store = FrameStore(frames=torch.from_numpy(video), t=t)
    host_store = FrameStore(frames=video, t=t)
    assert host_store.device == device_store.device
    steps = device_store.num_samples
    a = loop.init_train_state(cfg, "cpu", seed=0)
    resident = loop.make_epoch_fn(cfg, steps)
    b = loop.init_train_state(cfg, "cpu", seed=0)
    streaming = loop.make_streaming_epoch_fn(cfg, steps)
    assert streaming.streaming and not resident.streaming
    for epoch in range(2):
        a, m1 = loop.run_fused_epoch(a, resident, device_store, cfg, epoch)
        b, m2 = loop.run_fused_epoch(b, streaming, host_store, cfg, epoch)
        assert (m2.loss, m2.lr) == (m1.loss, m1.lr)
        np.testing.assert_array_equal(m2.psnr, m1.psnr)
        np.testing.assert_array_equal(m2.msssim, m1.msssim)
    assert loop.stream_chunk_steps(host_store, cfg) == -(-steps // n_chunks)
    assert streaming.chunk_copies == 2 * n_chunks
    assert a.step == b.step == 2 * steps
    _assert_same_weights(a.model, b.model)


def test_epoch_functions_refuse_the_other_kind_of_store():
    cfg = _cfg()
    video, t = synthetic_video(4, 12, 16, seed=2)
    state = loop.init_train_state(cfg, "cpu", seed=0)
    with pytest.raises(ValueError, match="make_streaming_epoch_fn"):
        loop.run_fused_epoch(state, loop.make_epoch_fn(cfg, 4), FrameStore(video, t), cfg, 0)
    with pytest.raises(ValueError, match="make_epoch_fn"):
        loop.run_fused_epoch(state, loop.make_streaming_epoch_fn(cfg, 4),
                             FrameStore(torch.from_numpy(video), t), cfg, 0)
    assert state.step == 0


@pytest.mark.parametrize("mode,batch_size", [("batch", 1), ("sample", 2)])
def test_streaming_epoch_matches_jax_streaming_epoch(kernel_gates, mode, batch_size):
    """The port's streaming epoch against the JAX package's
    (``make_streaming_epoch_fn`` + ``run_fused_epoch``) from the same
    weights, one step a chunk on both sides; the JAX kernels in interpret
    mode, the port's plain versions."""
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.train import loop as jloop

    from repnerv_tpu_torch.models.generator import Generator
    from repnerv_tpu_torch.train import checkpoint as ckpt

    tcfg, ptcfg, params, start = _jax_setup(batch_size, mode)
    tcfg.data.stream_chunk_mb = 0
    ptcfg.data.stream_chunk_mb = 0
    video, t_all = synthetic_video(4, 12, 16, seed=2)
    steps = 4 // batch_size

    jstate = jloop.TrainState(params, jloop.make_optimizer(tcfg).init(params),
                              jnp.asarray(0, jnp.int32))
    jfn = jloop.make_streaming_epoch_fn(tcfg, steps, with_msssim=False)
    jstore = JStore(frames=video, t=t_all)  # numpy: host-resident
    ref = []
    for epoch in range(2):
        jstate, m = jloop.run_fused_epoch(jstate, jfn, jstore, tcfg, epoch)
        ref.append((m.loss, float(m.psnr[-1]), m.lr))

    model = ckpt.load_state(Generator(ptcfg.model), start).train()
    state = loop.TrainState(model, loop.make_optimizer(ptcfg, model), 0)
    fn = loop.make_streaming_epoch_fn(ptcfg, steps, with_msssim=False)
    store = FrameStore(frames=video, t=t_all)
    got = []
    for epoch in range(2):
        state, m = loop.run_fused_epoch(state, fn, store, ptcfg, epoch)
        got.append((m.loss, float(m.psnr[-1]), m.lr))
    assert fn.chunk_copies == 2 * steps
    _check_trajectory(got, ref, state, jax.tree.map(np.asarray, jstate.params), ptcfg)


@pytest.mark.parametrize("rung", ["host", "disk"])
def test_run_epoch_and_evaluate_from_host_or_disk_equal_resident(tmp_path, rung):
    """The eager epoch and the eval sweep copy one batch at a time from a
    host array or a DirFrames: equal bits with the resident store's."""
    cfg = _cfg(batch_size=2)
    video, t = synthetic_video(6, 12, 16, seed=4)
    resident = FrameStore(frames=torch.from_numpy(video), t=t)
    if rung == "host":
        other = FrameStore(frames=video, t=t)
    else:
        paths, _ = tframes.list_frame_paths(_write_frame_dir(tmp_path, video))
        other = FrameStore(frames=DirFrames(paths), t=t)
    step = loop.make_train_step(cfg, 3, with_msssim=False)
    a = loop.init_train_state(cfg, "cpu", seed=0)
    b = loop.init_train_state(cfg, "cpu", seed=0)
    for epoch in range(2):
        a, m1 = loop.run_epoch(a, step, resident, cfg, epoch)
        b, m2 = loop.run_epoch(b, step, other, cfg, epoch)
        assert (m2.loss, m2.lr) == (m1.loss, m1.lr)
    _assert_same_weights(a.model, b.model)
    ev = loop.make_eval_step(cfg, with_msssim=False)
    for store in (resident, other):
        store.frame_gap = 1
    p1, _ = loop.evaluate(a.model, ev, resident, cfg)
    p2, _ = loop.evaluate(a.model, ev, other, cfg)
    np.testing.assert_array_equal(p1, p2)


def test_train_and_eval_from_disk(tmp_path):
    """Rung 3 end to end, as tests/test_outofcore.py: train through the
    streaming epoch and evaluate straight from a DirFrames; PSNR rises by
    more than 1 dB over the first epoch's."""
    frames, _ = synthetic_video(12, 160, 192, seed=5)  # 1.05 MiB decoded > 1 MiB
    _write_frame_dir(tmp_path, frames)
    cfg = dataclasses.replace(
        _cfg(batch_size=4, model=dataclasses.replace(TINY, **DISK), dataset="lazyvid",
             data_dir=str(tmp_path), hbm_budget_mb=1, host_budget_mb=1, stream_chunk_mb=1),
        epochs=10, loss_type="L2")
    store = tframes.make_frame_store(cfg.data, "cpu")
    assert isinstance(store.frames, DirFrames)
    fn = loop.make_streaming_epoch_fn(cfg, store.num_samples // 4)
    state = loop.init_train_state(cfg, "cpu", seed=0)
    first = None
    for epoch in range(cfg.epochs):
        state, m = loop.run_fused_epoch(state, fn, store, cfg, epoch)
        first = float(m.psnr[-1]) if first is None else first
    assert fn.chunk_copies == 2 * cfg.epochs  # 3 steps: chunks of 2 and 1
    psnr, _ = loop.evaluate(state.model, loop.make_eval_step(cfg, with_msssim=False), store, cfg)
    assert float(psnr[-1]) > first + 1.0, (first, psnr)


# the train CLI's flags at 160x192: 12 frames, -b 4, 3 steps an epoch; a
# 1 MiB chunk holds 2 (360 KiB each): chunks of 2 and 1
CLI_ARGV = (
    "--dataset synth --synthetic_frames 12 --synthetic_hw 160 192 --embed 1.25_4 "
    "--stem_dim_num 16_1 --fc_hw_dim 5_6_8 --expansion 1 --strides 4 4 2 --lower_width 6 "
    "--branch_type ERB --act swish --single_res --loss L2 -b 4 --lr 5e-3 -e 2 "
    "--stream_chunk_mb 1 --device cpu"
).split()


def test_train_cli_on_a_host_store_with_a_short_last_chunk(tmp_path, monkeypatch):
    """``--hbm_budget_mb 1`` spills the video to the host and the CLI trains
    through the streaming epoch (a short last chunk every epoch): the .pth
    files, ``Epoch[2/2]`` in rank0.txt, and the history of the same run from
    a resident video, to the bit."""
    from repnerv_tpu_torch.cli import train_main

    monkeypatch.chdir(tmp_path)
    made = []
    real = train_main.make_streaming_epoch_fn

    def spy(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(train_main, "make_streaming_epoch_fn", spy)
    res = train_main.main(CLI_ARGV + ["--hbm_budget_mb", "1", "--outf", "host"])
    assert len(made) == 1 and made[0].chunk_copies == 4
    out = res["outf"]
    for name in ("model_latest.pth", "model_latest_deploy.pth", "resume_latest.pt"):
        assert os.path.exists(os.path.join(out, name)), name
    assert "Epoch[2/2]" in open(os.path.join(out, "rank0.txt")).read()
    ref = train_main.main(CLI_ARGV + ["--hbm_budget_mb", "0", "--outf", "device"])
    assert len(made) == 1
    assert res["history"] == ref["history"]
    _assert_same_weights(res["state"].model, ref["state"].model)


@pytest.mark.parametrize("qat", [False, True])
def test_finetune_from_a_host_store_equals_resident(qat):
    """PATH A (prune 0.5 -> 2 masked finetune epochs) or QAT (8 bits) from a
    host store, one step a chunk: the streaming finetune gives the same
    weights and report as the resident one."""
    from repnerv_tpu_torch.compress.pipeline import compress, model_state
    from repnerv_tpu_torch.models.generator import Generator

    cfg = dataclasses.replace(_cfg(stream_chunk_mb=0), quant_bit=8, finetune=True,
                              finetune_epochs=2, prune_ratio=1.0 if qat else 0.5,
                              finetune_qat=qat)
    video, t = synthetic_video(4, 12, 16, seed=6)
    model = Generator(cfg.model, seed=3)
    out = []
    for store in (FrameStore(frames=torch.from_numpy(video), t=t), FrameStore(frames=video, t=t)):
        compressed, report = compress(model, cfg, store)
        out.append((model_state(compressed), report))
    (s1, r1), (s2, r2) = out
    assert r2.finetune_epochs == 2 and r2.bpp == r1.bpp > 0 and r2.extras.get("qat") == (qat or None)
    assert list(s1) == list(s2)
    for k in s1:
        np.testing.assert_array_equal(s2[k], s1[k], err_msg=k)


def test_eval_cli_from_a_host_store_equals_resident(tmp_path, monkeypatch):
    """eval_main PATH B with the PNG dumps (targets too) and ``--rd_sweep``
    with ``--hbm_budget_mb 1`` (a host store): the same results and the same
    images as from the resident store."""
    from repnerv_tpu_torch.cli import eval_main, train_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(eval_main, "measure_decode_fps", lambda *a, **k: 1.0)
    monkeypatch.setattr(eval_main, "measure_micro_fps", lambda *a, **k: 1.0)
    argv = CLI_ARGV + ["-e", "1", "--outf", "run"]
    train_main.main(argv)
    flags = ["--prune_ratio", "0.4", "--quant_bit", "8", "--dump_images", "--dump_gt"]
    results, images = [], []
    for budget in ("0", "1"):
        results.append(eval_main.main(argv + flags + ["--hbm_budget_mb", budget]))
        vis = os.path.join("result", "run", "visualize")
        images.append({f: np.asarray(Image.open(os.path.join(vis, f))) for f in os.listdir(vis)})
        results.append(eval_main.main(argv + ["--rd_sweep", "--rd_prune_ratios", "1.0", "0.4",
                                              "--rd_quant_bits", "8", "--hbm_budget_mb", budget]))
    assert results[2] == results[0] and results[3] == results[1]
    assert len(images[0]) == 24 and images[0].keys() == images[1].keys()
    for f in images[0]:
        np.testing.assert_array_equal(images[1][f], images[0][f], err_msg=f)
    video, _ = synthetic_video(12, 160, 192, seed=0)
    np.testing.assert_array_equal(images[1]["gt_5.png"], video[5])


# ---------------------------------------------------------------------------
# The photo and corpus generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_corpus_video_equals_jax_byte_for_byte(seed):
    """Seeds 0-7: every class (photo, MRI, terrain, text) in both variants."""
    from repnerv_tpu.data import frames as jframes

    got, t = tframes.corpus_video(3, 64, 96, seed=seed)
    ref, t_ref = jframes.corpus_video(3, 64, 96, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (3, 64, 96, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t, t_ref)


@pytest.mark.parametrize("motion", ["normal", "slow", "static"])
def test_photo_video_equals_jax_byte_for_byte(motion):
    from repnerv_tpu.data import frames as jframes

    for seed in (0, 5):
        got, t = tframes.photo_video(3, 64, 96, seed=seed, motion=motion)
        ref, t_ref = jframes.photo_video(3, 64, 96, seed=seed, motion=motion)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(t, t_ref)


# ---------------------------------------------------------------------------
# On the card: the streaming graph
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["pinned", "staged"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_streaming_graph_equals_resident_graph_on_the_card(cuda, dtype, tol, source):
    """Per-step losses of an epoch of the streaming graph (chunks of 4 and
    2 of a 6-step epoch over a ring of 6; then one-step chunks over a ring
    of 2, each half reused every other step) against the resident graph's
    from the same weights, within chip_smoke.py's GRAPH_TOL; the launches of
    a replayed step are the resident graph's, and the next epoch replays the
    same graph.  ``pinned``: frames copied straight from a pinned host array;
    ``staged``: from an array that is not pinned, through the staging
    buffers."""
    cfg = TrainConfig(model=dataclasses.replace(CARD, compute_dtype=dtype),
                      data=DataConfig(batch_size=1), epochs=2, warmup=0.5, lr=5e-3,
                      loss_type="Fusion6")
    video, t = synthetic_video(6, 144, 256, seed=2)
    device_store = FrameStore(frames=torch.from_numpy(video).to(cuda), t=t)
    host = tframes.pinned_copy(video) if source == "pinned" else video.copy()
    host_store = FrameStore(frames=host, t=t, device="cuda")
    assert host_store.device == cuda
    perm = loop.epoch_rows(device_store, cfg, 0)
    a = loop.init_train_state(cfg, cuda, seed=0)
    resident = loop.make_epoch_fn(cfg, 6)
    a, ref = resident(a, device_store, perm, None)
    ref = ref["loss"].cpu()
    for chunk in (4, 1):
        b = loop.init_train_state(cfg, cuda, seed=0)
        streaming = loop.make_streaming_epoch_fn(cfg, 6)
        b, aux = streaming(b, host_store, perm, None, chunk)
        got = aux["loss"].cpu()
        rel = ((got - ref).abs() / ref.abs()).max().item()
        assert rel <= tol, (chunk, rel)
        assert streaming.replay_counts == resident.replay_counts
        assert streaming.chunk_copies == -(-6 // chunk)
        assert b.step == 6
        graph = streaming.graph
        b, _ = streaming(b, host_store, loop.epoch_rows(device_store, cfg, 1), None, chunk)
        assert streaming.graph is graph  # the next epoch replays, it captures nothing
