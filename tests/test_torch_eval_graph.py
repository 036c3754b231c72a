"""The port's eval step (repnerv_tpu_torch/train/loop.py: ``make_eval_step``,
an ``EvalStep``, called once a batch by ``evaluate``) against the JAX
package's jitted ``make_eval_step`` + ``evaluate`` on the CPU, where the step
is ``build_eval_step_fn``'s eager step, and the CUDA graph against that
eager step on the card.

* Against JAX, 5 frames at B = 2 (the short last batch included), a tiny
  ERB training model in train mode and its deployed form: the sweep's PSNR
  within 1e-3 dB (tests/test_torch_train.py's trajectory bound: f32 frames
  within 1e-5, the same arithmetic summed in other orders), each batch's
  per-frame PSNR rows as well.
* ``eval_graph_key`` moves with each thing the capture holds (a parameter
  changed in place, the mode, the batch size, the frame shape, MS-SSIM, an
  int8 table, another module) and stays when nothing changes.
* On the card: graph metrics equal the eager step's to the bit (cuDNN held
  to its deterministic algorithms) for an ERB training model in f32 and
  bf16, a deploy model and an int8 model; one capture a sweep, a replay a
  batch counted as an eager batch's launches, the short last batch eager;
  a recapture after a weight changes in place, and after the fused epoch's
  replays trained a deploy model (whose K1 weights are packed by version);
  ``release`` gives the graph's pool back.
* train_main releases the eval graph after each sweep (on the CPU).

The ``gpu`` tests skip here and run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_eval_graph.py
(JAX is imported inside the CPU parity tests).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.kernels import launches
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, generator_to_deploy
from repnerv_tpu_torch.train import loop

# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def _jax_models(deploy: bool):
    """A tiny ERB generator (8x8 frames) of the JAX package from a seed,
    deployed or not, and the port's with the same weights (train mode for a
    training model, as train_main evaluates it; eval mode for a deploy one)."""
    import jax

    from repnerv_tpu.models.generator import generator_to_deploy as jdeploy
    from repnerv_tpu.models.generator import init_generator

    from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_model_cfg

    jcfg = tiny_model(branch_type="ERB", fc_hw_dim="2_2_4", strides=(2, 2))
    params = init_generator(jax.random.PRNGKey(5), jcfg)
    if deploy:
        params, jcfg = jdeploy(params, jcfg)
    pcfg = port_model_cfg(jcfg)
    gen = load_state(Generator(pcfg), state_from_jax_params(jax.tree.map(np.asarray, params),
                                                            pcfg))
    return params, jcfg, gen.train(not deploy)


@pytest.mark.parametrize("deploy", [False, True])
def test_evaluate_matches_jax_evaluate(deploy):
    """``evaluate`` over the port's ``make_eval_step`` against the JAX
    package's, 5 frames at B = 2: the sweep's PSNR, and each batch's
    per-frame rows [B, n_stage]; the model's mode is left as it was."""
    import jax.numpy as jnp

    from repnerv_tpu.config import TrainConfig as JaxTrainConfig
    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.train import loop as jloop

    params, jcfg, gen = _jax_models(deploy)
    jtcfg = JaxTrainConfig(model=jcfg)
    jtcfg.data.batch_size = 2
    video, t_all = synthetic_video(5, 8, 8, seed=4)
    jstep = jloop.make_eval_step(jtcfg, with_msssim=False)
    ref_psnr, ref_msssim = jloop.evaluate(params, jstep, JStore(frames=jnp.asarray(video),
                                                                t=t_all), jtcfg)
    cfg = TrainConfig(model=gen.cfg, data=DataConfig(batch_size=2))
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    step = loop.make_eval_step(cfg, with_msssim=False)
    assert isinstance(step, loop.EvalStep)
    psnr, msssim = loop.evaluate(gen, step, store, cfg)
    assert gen.training == (not deploy)
    assert psnr.shape == ref_psnr.shape == (1,)
    np.testing.assert_allclose(psnr, ref_psnr, atol=1e-3)
    np.testing.assert_array_equal(msssim, np.zeros_like(psnr))
    for lo, hi in ((0, 2), (2, 4), (4, 5)):
        _, ref = jstep(params, jnp.asarray(video[lo:hi]), jnp.asarray(t_all[lo:hi]))
        _, got = step(gen, torch.from_numpy(video[lo:hi]), torch.from_numpy(t_all[lo:hi]))
        assert tuple(got["psnr"].shape) == np.asarray(ref["psnr"]).shape == (hi - lo, 1)
        np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(ref["psnr"]), atol=1e-3)
    assert step.captured.graph is None and step.captured.captures == 0


def _tiny(**over) -> ModelConfig:
    return ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                       lower_width=4, branch_type="ERB", **over)


@pytest.mark.parametrize("training", [True, False])
def test_cpu_eval_step_is_the_eager_body(training):
    """On a CPU model the step is ``build_eval_step_fn``'s eager step (its
    body in eval mode), to the bit, without autograd; the mode is put back,
    and nothing is captured."""
    gen = Generator(_tiny(), seed=3).train(training)
    cfg = TrainConfig(model=gen.cfg)
    video, t = synthetic_video(2, 12, 16, seed=1)
    frames, t = torch.from_numpy(video), torch.from_numpy(t)
    step = loop.make_eval_step(cfg, with_msssim=True)
    outs, aux = step(gen, frames, t)
    assert gen.training == training
    ref_outs, ref_aux = loop.build_eval_step_fn(cfg, True)(gen, frames, t)
    assert gen.training == training
    assert all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
    assert set(aux) == {"psnr", "msssim"}
    assert all(torch.equal(aux[k], ref_aux[k]) for k in aux)
    assert not any(o.requires_grad for o in outs)
    assert step.captured.captures == 0 and step.captured.graph is None


def _key(gen, shape=(2, 12, 16, 3), msssim=True):
    return loop.eval_graph_key(gen, shape, msssim)


def _change(case, gen):
    """``gen`` (or a key argument) after one change of what a capture holds."""
    if case == "weight in place":
        with torch.no_grad():
            next(gen.parameters()).mul_(2.0)
    elif case == "mode":
        gen.train()
    elif case == "batch":
        return gen, (3, 12, 16, 3), True
    elif case == "frame shape":
        return gen, (2, 24, 32, 3), True
    elif case == "msssim":
        return gen, (2, 12, 16, 3), False
    elif case == "another module":
        return copy.deepcopy(gen), (2, 12, 16, 3), True
    elif case == "int8 table":
        gen = calibrate_int8(gen, positional_encoding(torch.arange(2.0) / 2, gen.cfg.embed))
        return gen, (2, 12, 16, 3), True
    return gen, (2, 12, 16, 3), True


@pytest.mark.parametrize("case", ["weight in place", "mode", "batch", "frame shape", "msssim",
                                  "another module", "int8 table"])
def test_eval_graph_key_moves_with_what_the_capture_holds(case):
    gen = generator_to_deploy(Generator(_tiny(compute_dtype="bfloat16", decode_int8=True),
                                        seed=2)).eval()
    key = _key(gen)
    gen2, shape, msssim = _change(case, gen)
    assert loop.eval_graph_key(gen2, shape, msssim) != key


def test_eval_graph_key_stays_when_nothing_changes():
    """Reading the weights, a forward and a CPU eval step move no part of the
    key; a train-mode model's key taken in eval mode is the eval model's."""
    gen = Generator(_tiny(), seed=2).eval()
    key = _key(gen)
    video, t = synthetic_video(2, 12, 16, seed=1)
    step = loop.make_eval_step(TrainConfig(model=gen.cfg))
    step(gen, torch.from_numpy(video), torch.from_numpy(t))
    _ = [p.sum() for p in gen.parameters()]
    assert _key(gen) == key
    gen.train()
    gen.eval()
    assert _key(gen) == key


def test_a_freed_modules_key_matches_no_new_module():
    """A capture holds the module's weights by address; once the module is
    freed, a new one (which may take its id, and its tensors' addresses) is
    not the captured one, whatever its weights."""
    import gc

    a = Generator(_tiny(), seed=2).eval()
    key = _key(a)
    del a
    gc.collect()
    for _ in range(3):
        b = Generator(_tiny(), seed=2).eval()
        assert _key(b) != key
        del b
        gc.collect()


def test_train_main_releases_the_eval_graph_after_each_sweep(tmp_path, monkeypatch):
    """train_main trains between sweeps, so a sweep's graph could never
    replay again: it lets the graph go right after each sweep rather than
    hold its pool through the next epochs."""
    from test_torch_train_cli import ARGV

    from repnerv_tpu_torch.cli import train_main

    monkeypatch.chdir(tmp_path)
    events = []
    sweep, release = train_main.evaluate, loop.EvalStep.release
    monkeypatch.setattr(train_main, "evaluate",
                        lambda *a, **k: events.append("sweep") or sweep(*a, **k))
    monkeypatch.setattr(loop.EvalStep, "release",
                        lambda self: events.append("release") or release(self))
    res = train_main.main(ARGV + ["-e", "2"])
    assert [h["epoch"] for h in res["history"]] == [1, 2]
    assert events == ["sweep", "release"] * 2


# ---------------------------------------------------------------------------
# On the card: the CUDA graph
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


# 180x320 frames, so MS-SSIM has its 5 levels (K5: 5 launches a batch); blocks
# 1 and 2 (3600 and 14400 input pixels) take K1 on a deploy model
CARD = ModelConfig(embed="1.25_8", stem_dim_num="64_1", fc_hw_dim="9_16_16", strides=(5, 2, 2),
                   lower_width=16, branch_type="ERB")


def _card_model(kind: str, device) -> Generator:
    dtype = "float32" if kind.endswith("f32") else "bfloat16"
    cfg = dataclasses.replace(CARD, compute_dtype=dtype, decode_int8=kind == "int8")
    gen = Generator(cfg, seed=8, device=device)
    if kind.startswith("train"):
        return gen.train()
    gen = generator_to_deploy(gen).eval()
    if kind == "int8":
        calib = torch.arange(4, dtype=torch.float32, device=device) / 4
        gen = calibrate_int8(gen, positional_encoding(calib, cfg.embed))
    return gen


def _card_store(device) -> FrameStore:
    video, t = synthetic_video(5, 180, 320, seed=3)
    return FrameStore(frames=torch.from_numpy(video).to(device), t=t)


def _k(counts) -> tuple:
    return tuple(counts[f"repnerv_tpu_torch.kernels.{m}", "LAUNCHES"]
                 for m in ("decode", "decode_int8", "ssim_blur"))


def _eager_sweep(gen, cfg, store):
    """The eager eval step (``build_eval_step_fn``) over the sweep's batches
    [0, 2), [2, 4), [4, 5): the metrics of each batch."""
    eager = loop.build_eval_step_fn(cfg, True)
    out = []
    for lo, hi in ((0, 2), (2, 4), (4, 5)):
        rows = torch.arange(lo, hi, device=store.device)
        t = torch.from_numpy(store.t[lo:hi]).to(store.device)
        out.append(eager(gen, store.gather(rows), t)[1])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train-f32", "train-bf16", "deploy-bf16", "int8"])
def test_eval_graph_equals_eager_on_the_card(cuda, kind):
    """Two sweeps of 5 frames at B = 2: per-frame PSNR and MS-SSIM equal
    the eager step's to the bit; one capture, then one replay a batch,
    counted as an eager batch's launches (5 K5, and 2 K1 or 2 K2 on a
    deploy or int8 model); the short last batch runs eagerly; outputs of a
    call survive later calls; the mode is put back."""
    gen = _card_model(kind, cuda)
    cfg = TrainConfig(model=gen.cfg, data=DataConfig(batch_size=2))
    store = _card_store(cuda)
    ref = _eager_sweep(gen, cfg, store)
    before = launches.snapshot()
    _eager_sweep(gen, cfg, store)
    eager_counts = _k(launches.since(before))
    per_batch = {"train-f32": (0, 0, 5), "train-bf16": (0, 0, 5), "deploy-bf16": (2, 0, 5),
                 "int8": (0, 2, 5)}[kind]
    assert eager_counts == tuple(3 * v for v in per_batch)
    step = loop.make_eval_step(cfg, with_msssim=True)
    t_all = torch.from_numpy(store.t).to(cuda)
    for sweep in range(2):
        got = []
        before = launches.snapshot()
        for lo, hi in ((0, 2), (2, 4), (4, 5)):
            rows = torch.arange(lo, hi, device=cuda)
            got.append(step(gen, store.gather(rows), t_all[rows])[1])
        assert _k(launches.since(before)) == eager_counts
        for g, r in zip(got, ref):
            assert torch.equal(g["psnr"], r["psnr"]) and torch.equal(g["msssim"], r["msssim"])
        if sweep == 0:
            first = got
    assert step.captured.captures == 1 and _k(step.captured.counts) == per_batch
    assert step.captured.key[1] == 2 and step.pool_bytes > 0
    for g, r in zip(first, ref):  # not overwritten by the second sweep
        assert torch.equal(g["psnr"], r["psnr"])
    assert gen.training == kind.startswith("train")
    psnr, msssim = loop.evaluate(gen, step, store, cfg)
    assert step.captured.captures == 1
    want = torch.cat([r["psnr"] for r in ref]).mean(dim=0).cpu().numpy()
    np.testing.assert_array_equal(psnr, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["deploy-bf16", "int8"])
def test_eval_graph_recaptures_after_a_change_on_the_card(cuda, kind):
    """A weight (and under int8 its packed scale) changed in place moves the
    key: the next batch captures again and equals the eager step on the new
    weights; a larger batch captures again too."""
    gen = _card_model(kind, cuda)
    cfg = TrainConfig(model=gen.cfg, data=DataConfig(batch_size=2))
    store = _card_store(cuda)
    step = loop.make_eval_step(cfg, with_msssim=True)
    loop.evaluate(gen, step, store, cfg)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(1.25)
        if kind == "int8":
            gen.int8["2"].packed.scale.mul_(0.5)
    ref = _eager_sweep(gen, cfg, store)
    psnr, _ = loop.evaluate(gen, step, store, cfg)
    assert step.captured.captures == 2
    np.testing.assert_array_equal(psnr, torch.cat([r["psnr"] for r in ref]).mean(0).cpu().numpy())
    cfg4 = dataclasses.replace(cfg, data=DataConfig(batch_size=4))
    psnr4, _ = loop.evaluate(gen, step, store, cfg4)
    assert step.captured.captures == 3 and np.isfinite(psnr4).all()


@pytest.mark.gpu
def test_eval_graph_sees_weights_the_fused_epoch_replays_wrote_on_the_card(cuda):
    """A deploy-state model trained by the fused epoch (its steps CUDA graph
    replays, which move no version by themselves) and then evaluated: the
    eval step captures again and its metrics equal the eager step's on a
    copy of the model, whose K1 weights are packed afresh."""
    mcfg = dataclasses.replace(CARD, compute_dtype="bfloat16", deploy=True)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=1), epochs=2, warmup=0.5, lr=5e-3,
                      loss_type="Fusion6")
    store = _card_store(cuda)
    state = loop.init_train_state(cfg, cuda, seed=0)
    epoch_fn = loop.make_epoch_fn(cfg, 5)
    ecfg = dataclasses.replace(cfg, data=DataConfig(batch_size=2))
    step = loop.make_eval_step(ecfg, with_msssim=True)
    for epoch in range(2):
        state, _ = loop.run_fused_epoch(state, epoch_fn, store, cfg, epoch)
        psnr, _ = loop.evaluate(state.model, step, store, ecfg)
        assert step.captured.captures == epoch + 1
        ref = _eager_sweep(copy.deepcopy(state.model), ecfg, store)
        want = torch.cat([r["psnr"] for r in ref]).mean(0).cpu().numpy()
        np.testing.assert_array_equal(psnr, want)
    assert epoch_fn.captured.captures == 1


@pytest.mark.gpu
def test_eval_graph_release_gives_its_pool_back_on_the_card(cuda):
    """``release`` after a sweep (as train_main, eval_main and suite_main
    call it) gives the graph's pool back to the card, and the next sweep
    captures again, with the same metrics to the bit."""
    gen = _card_model("train-bf16", cuda)
    cfg = TrainConfig(model=gen.cfg, data=DataConfig(batch_size=2))
    store = _card_store(cuda)
    step = loop.make_eval_step(cfg, with_msssim=True)
    first = loop.evaluate(gen, step, store, cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda)
    step.release()
    torch.cuda.empty_cache()
    assert step.captured.graph is None and step.frames is None and step.t is None
    assert held - torch.cuda.memory_reserved(cuda) >= step.pool_bytes > 0
    again = loop.evaluate(gen, step, store, cfg)
    assert step.captured.captures == 2
    for a, b in zip(again, first):
        np.testing.assert_array_equal(a, b)
