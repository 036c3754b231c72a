"""The port's training path against the JAX package, on the CPU at small
sizes: the train-mode generator forward and gradients (all 6 branch types,
both ``online_fuse`` settings, BN batch statistics, remat), the pure
``generator_to_deploy``, and a 2-epoch Fusion6 trajectory through the
port's epoch runner with the fused-stage and SSIM-blur gates active on both
sides (the JAX side runs its Pallas kernels in interpret mode).

The same weights go into both sides: JAX initializes, the port loads the
numpy pytree through ``state_from_jax_params``; inputs come from a numpy
seed.  Tolerances, in f32: outputs atol 1e-5 (through convolutions, as
tests/test_torch_models.py); gradients atol 1e-5 relative to each tensor's
largest |gradient| (the same products summed in different orders), 1e-4
through the ERB/DBB/ECB fusion einsums and branch sums, which add
contractions on each side (see ``_check_grads``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repnerv_tpu.config import BRANCH_TYPES
from repnerv_tpu.config import TrainConfig as JaxTrainConfig
from repnerv_tpu.models import generator as jgen
from repnerv_tpu.models.embedding import positional_encoding as jpe

from repnerv_tpu_torch.config import TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore
from repnerv_tpu_torch.models import generator as tgen
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, generator_to_deploy
from repnerv_tpu_torch.train import loop as tloop
from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
from test_model_train import tiny_model
from test_torch_config_codecs import port_model_cfg, port_train_cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(params, cfg, train=True):
    pcfg = port_model_cfg(cfg)  # the port takes its own config class
    model = load_state(Generator(pcfg), state_from_jax_params(_np_tree(params), pcfg))
    return model.train(train)


def _jax_fwd_grads(params, cfg, t, ct):
    emb = jpe(jnp.asarray(t), cfg.embed)

    def f(p):
        return jnp.sum(jgen.apply_generator(p, emb, cfg, train=True)[-1] * jnp.asarray(ct))

    out = jgen.apply_generator(params, emb, cfg, train=True)[-1]
    grads = state_from_jax_params(_np_tree(jax.grad(f)(params)), port_model_cfg(cfg))
    # BN's running statistics are leaves of the JAX params, buffers here
    return np.asarray(out), {k: v for k, v in grads.items() if "running" not in k}


def _port_fwd_grads(model, cfg, t, ct):
    model.zero_grad(set_to_none=True)
    out = model(positional_encoding(torch.from_numpy(t), cfg.embed))[-1]
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _check_grads(got, ref, rel):
    """Each tensor within ``rel`` of its largest |entry|, floored at 1e-3 of
    the largest over all tensors: the ECB edge branches' ``b0`` gradients
    are exactly 0 in exact arithmetic (the Sobel and Laplacian masks sum to
    0) and only rounding residue in f32."""
    assert set(got) == set(ref)
    floor = 1e-3 * max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        scale = max(np.abs(r).max(), floor)
        np.testing.assert_allclose(got[k], r, atol=rel * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("branch_type", BRANCH_TYPES)
@pytest.mark.parametrize("online_fuse", [True, False])
def test_train_forward_and_grads_match_jax(branch_type, online_fuse):
    cfg = tiny_model(branch_type=branch_type, online_fuse=online_fuse, fc_hw_dim="3_4_4",
                     strides=(2, 2))
    params = jgen.init_generator(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    t = np.array([0.1, 0.7], np.float32)
    ct = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    ref_out, ref_g = _jax_fwd_grads(params, cfg, t, ct)
    out, g = _port_fwd_grads(_port_model(params, cfg), cfg, t, ct)
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    _check_grads(g, ref_g, 1e-5 if branch_type in ("NeRV_vanilla", "RepVGG", "ACB") else 1e-4)


@pytest.mark.parametrize("norm", ["bn", "in"])
def test_train_norms_match_jax(norm):
    """BN normalizes with the batch statistics in training and leaves the
    running ones alone, as the JAX package does (unlike nn.BatchNorm2d)."""
    cfg = tiny_model(branch_type="ERB", norm=norm, fc_hw_dim="3_4_4", strides=(2, 2))
    params = jgen.init_generator(jax.random.PRNGKey(4), cfg)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    ct = np.random.default_rng(1).standard_normal((3, 12, 16, 3)).astype(np.float32)
    ref_out, ref_g = _jax_fwd_grads(params, cfg, t, ct)
    model = _port_model(params, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    out, g = _port_fwd_grads(model, cfg, t, ct)
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    _check_grads(g, ref_g, 1e-4)
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v)


@pytest.fixture
def kernel_gates(monkeypatch):
    """The fused-stage and SSIM-blur paths on both sides at tiny sizes: the
    JAX kernels in interpret mode off-TPU, the port's plain versions."""
    import repnerv_tpu.ops.ssim as S
    import repnerv_tpu.pallas_kernels.ssim_blur as jsb
    import repnerv_tpu.pallas_kernels.train_tail as jtt

    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)
    monkeypatch.setattr(jgen, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(jtt, "INTERPRET", True)
    monkeypatch.setattr(jsb, "INTERPRET", True)
    monkeypatch.setattr(S, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(tgen, "KERNEL_MIN_PIXELS", 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_path_matches_jax(kernel_gates, dtype):
    """Both blocks through fused_stage_train (the last with the head) on both
    sides.  bf16: outputs within 2^-6 + 2e-3 (bf16 rounding at each block's
    output, the head sum in f32), gradients within 2^-5 of each tensor's
    largest |gradient| (the bf16 conv dX/dW round their outputs)."""
    cfg = tiny_model(branch_type="ERB", fc_hw_dim="3_4_4", strides=(2, 2), compute_dtype=dtype)
    params = jgen.init_generator(jax.random.PRNGKey(5), cfg)
    t = np.array([0.3], np.float32)
    ct = np.random.default_rng(2).standard_normal((1, 12, 16, 3)).astype(np.float32)
    ref_out, ref_g = _jax_fwd_grads(params, cfg, t, ct)
    out, g = _port_fwd_grads(_port_model(params, cfg), cfg, t, ct)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref_out, atol=1e-5)
        _check_grads(g, ref_g, 1e-4)
    else:
        np.testing.assert_allclose(out, ref_out, atol=2e-3, rtol=2.0**-6)
        _check_grads(g, ref_g, 2.0**-5)


def test_remat_gives_the_same_gradients():
    cfg = tiny_model(branch_type="DBB", fc_hw_dim="3_4_4", strides=(2, 2))
    params = jgen.init_generator(jax.random.PRNGKey(6), cfg)
    t = np.array([0.4, 0.6], np.float32)
    ct = np.random.default_rng(3).standard_normal((2, 12, 16, 3)).astype(np.float32)
    out, g = _port_fwd_grads(_port_model(params, cfg), cfg, t, ct)
    rcfg = dataclasses.replace(cfg, remat=True)
    out_r, g_r = _port_fwd_grads(_port_model(params, rcfg), rcfg, t, ct)
    np.testing.assert_array_equal(out_r, out)
    _check_grads(g_r, g, 1e-6)


def test_generator_to_deploy_leaves_the_model_training():
    """The deploy snapshot is a fused copy: the training model keeps its
    branches and weights and trains on (train_main writes deploy snapshots
    while training continues)."""
    cfg = port_model_cfg(tiny_model(branch_type="ERB", fc_hw_dim="3_4_4", strides=(2, 2)))
    model = Generator(cfg, seed=1).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dep = generator_to_deploy(model)
    assert dep.cfg.deploy and not model.cfg.deploy
    assert all(blk.rbr_reparam is not None for blk in dep.layers)
    assert all(blk.rbr_reparam is None for blk in model.layers)
    assert model.state_dict().keys() == before.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # deploy equals the training graph on the same input
    emb = positional_encoding(torch.tensor([0.25, 0.75]), cfg.embed)
    model.eval()
    np.testing.assert_allclose(dep.eval()(emb)[-1].detach().numpy(),
                               model(emb)[-1].detach().numpy(), atol=1e-5)
    # and the original still trains
    model.train()
    tcfg = TrainConfig(model=cfg, epochs=2, lr=5e-3, loss_type="L2")
    state = tloop.TrainState(model, tloop.make_optimizer(tcfg, model), 0)
    step = tloop.make_train_step(tcfg, steps_per_epoch=1, with_msssim=False)
    frames = torch.rand(2, 12, 16, 3, generator=torch.Generator().manual_seed(0))
    state, aux = step(state, frames, torch.tensor([0.25, 0.75]))
    assert np.isfinite(aux["loss"].item())
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_two_epoch_fusion6_trajectory_matches_jax(kernel_gates):
    """The slice as a whole: a tiny ERB Fusion6 model at -b 1, both blocks
    on the fused stage and every SSIM blur on the blur path, 2 epochs x 4
    frames through the port's epoch runner vs the JAX make_train_step +
    run_epoch from the same init.  Per-epoch loss atol 1e-5, PSNR atol
    1e-3 dB, lr rtol 1e-6; the final weights within 1e-4 of each tensor's
    largest |value| (8 Adam steps: Adam normalizes each update, so the
    per-step gradient differences of ~1e-6 move the weights by ~1e-6 * lr /
    sqrt(v) and do not compound at this length)."""
    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.data.frames import synthetic_video
    from repnerv_tpu.train import loop as jloop

    cfg = tiny_model(branch_type="ERB", embed="1.25_4", fc_hw_dim="3_4_6", strides=(2, 2))
    tcfg = JaxTrainConfig(model=cfg, epochs=2, warmup=0.5, lr=5e-3, loss_type="Fusion6",
                          manual_seed=1)
    tcfg.data.batch_size = 1
    video, t_all = synthetic_video(4, 12, 16, seed=2)
    params = jgen.init_generator(jax.random.PRNGKey(7), cfg)
    ptcfg = port_train_cfg(tcfg)  # the same fields in the port's own classes
    start = state_from_jax_params(_np_tree(params), ptcfg.model)

    jstate = jloop.TrainState(params, jloop.make_optimizer(tcfg).init(params),
                              jnp.asarray(0, jnp.int32))
    jstep = jloop.make_train_step(tcfg, steps_per_epoch=4, with_msssim=False)
    jstore = JStore(frames=jnp.asarray(video), t=t_all)
    ref = []
    for epoch in range(2):
        jstate, m = jloop.run_epoch(jstate, jstep, jstore, tcfg, epoch)
        ref.append((m.loss, float(m.psnr[-1]), m.lr))
    ref_final = state_from_jax_params(_np_tree(jstate.params), ptcfg.model)

    model = load_state(Generator(ptcfg.model), start).train()
    state = tloop.TrainState(model, tloop.make_optimizer(ptcfg, model), 0)
    step = tloop.make_train_step(ptcfg, steps_per_epoch=4, with_msssim=False)
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    got = []
    for epoch in range(2):
        state, m = tloop.run_epoch(state, step, store, ptcfg, epoch)
        got.append((m.loss, float(m.psnr[-1]), m.lr))

    assert state.step == 8
    for (l1, p1, lr1), (l2, p2, lr2) in zip(got, ref):
        assert l1 == pytest.approx(l2, abs=1e-5)
        assert p1 == pytest.approx(p2, abs=1e-3)
        assert lr1 == pytest.approx(lr2, rel=1e-6)
    final = {k: v.numpy() for k, v in model.state_dict().items()}
    _check_grads(final, ref_final, 1e-4)


def _tiny_state(cfg: TrainConfig):
    return tloop.init_train_state(cfg, "cpu", seed=0)


def _bump(state, delta):
    """A distinguishable weight change standing in for an epoch's update."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(delta)
    state.step += 1
    return state


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("psnrs,restored", [
    ([10.0, 20.0, 30.0, 11.0], True),   # a 19 dB collapse
    ([10.0, 20.0, 30.0, float("nan")], True),
    ([10.0, 18.0, 25.0, 24.1], False),  # a healthy dip
])
def test_divergence_guard_restores_best_with_fresh_adam(psnrs, restored):
    """As tests/test_recovery.py for the JAX guard: a collapse (> 6 dB below
    the best, or NaN) loads the best on-device snapshot back with fresh Adam
    moments and keeps the step; a healthy dip changes nothing."""
    from repnerv_tpu_torch.train.recovery import DivergenceGuard

    cfg = TrainConfig(model=port_model_cfg(tiny_model()), epochs=10, lr=5e-3, loss_type="L2")
    state = _tiny_state(cfg)
    state.optimizer.state[next(state.model.parameters())]["exp_avg"] = torch.ones(1)
    guard = DivergenceGuard(cfg, log=lambda m: None)
    best = None
    for epoch, psnr in enumerate(psnrs[:-1]):
        state, rec = guard.observe(epoch, psnr, state)
        assert not rec
        best = _weights(state)
        state = _bump(state, 0.5)
    step = state.step
    new, rec = guard.observe(len(psnrs) - 1, psnrs[-1], state)
    assert rec == restored and new.step == step
    if restored:
        for k, v in new.model.state_dict().items():
            assert torch.equal(v, best[k]), k
        assert len(new.optimizer.state) == 0  # fresh moments
        final, again = guard.finalize(new)
        assert again and final.step == step  # the collapse was the last epoch seen
    else:
        assert new is state


def test_prune_masks_hold_grads_and_weights_at_zero():
    """Masks multiply the gradients before the update and the weights
    after it (the JAX step's _apply_mask at loop.py:119 and :124)."""
    cfg = TrainConfig(model=port_model_cfg(tiny_model()), epochs=2, lr=5e-3, loss_type="L2")
    state = _tiny_state(cfg)
    name = "layers.1.branch.weight"
    w = dict(state.model.named_parameters())[name]
    mask = (torch.rand(w.shape, generator=torch.Generator().manual_seed(0)) > 0.5).float()
    step = tloop.make_train_step(cfg, steps_per_epoch=1, with_msssim=False)
    frames = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        state, _ = step(state, frames, torch.tensor([0.0, 0.5]), {name: mask})
    assert bool((w[mask == 0] == 0).all()) and bool((w.grad[mask == 0] == 0).all())
    assert bool((w[mask == 1] != 0).all())


def test_frame_dir_store_matches_jax(tmp_path):
    """A frame directory decodes in core (PIL) with t over the full
    directory and portrait frames turned landscape, as the JAX package's."""
    from PIL import Image

    from repnerv_tpu.data import frames as jframes
    from repnerv_tpu_torch.config import DataConfig
    from repnerv_tpu_torch.data.frames import make_frame_store

    d = tmp_path / "vid"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (10, 6, 3), dtype=np.uint8)).save(d / f"f{i:03d}.png")
    kw = dict(dataset="vid", data_dir=str(tmp_path), vid=(0, 2), cache_device=False)
    cfg = DataConfig(**kw)
    ref = jframes.make_frame_store(JaxTrainConfig().data.__class__(**kw))
    store = make_frame_store(cfg, "cpu")
    np.testing.assert_array_equal(store.frames.numpy(), np.asarray(ref.frames))
    np.testing.assert_array_equal(store.t, ref.t)
    assert store.hw == (6, 10)


def test_evaluate_builds_no_host_tensor_per_batch(monkeypatch):
    """The eval sweep sends the frame rows and the t column to the device
    once: however many batches it runs, it turns two numpy arrays into
    tensors, before the first batch (on the card every such copy inside the
    loop waits for the stream).  The metrics equal a sweep that copies per
    batch, a short last batch included."""
    from repnerv_tpu_torch.data.frames import synthetic_video

    cfg = port_train_cfg(JaxTrainConfig(model=tiny_model(branch_type="ERB", embed="1.25_4",
                                                         fc_hw_dim="3_4_6", strides=(2, 2))))
    cfg.data.batch_size = 2
    video, t_all = synthetic_video(5, 12, 16, seed=2)
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    model = _tiny_state(cfg).model
    eval_step = tloop.make_eval_step(cfg, with_msssim=False)
    ref = [eval_step(model, store.gather(rows), torch.from_numpy(t))[1]["psnr"]
           for rows, t in store.epoch_batches(2, shuffle=False, seed=0, drop_last=False)]
    ref = torch.cat(ref, 0).mean(dim=0).numpy()

    calls, batches = [], []
    real = torch.from_numpy

    def counting_from_numpy(a):
        calls.append(len(batches))  # how many batches had run when it was made
        return real(a)

    def counting_eval_step(*args):
        for a in args[1:]:
            assert isinstance(a, torch.Tensor)
        batches.append(args[2].shape[0])
        return eval_step(*args)

    monkeypatch.setattr(torch, "from_numpy", counting_from_numpy)
    psnr, msssim = tloop.evaluate(model, counting_eval_step, store, cfg)
    assert batches == [2, 2, 1]
    assert calls == [0, 0]
    np.testing.assert_array_equal(psnr, ref)
    assert msssim.shape == psnr.shape and not msssim.any()
    batches.clear()
    tloop.evaluate(model, counting_eval_step, store, cfg, max_steps=1)
    assert batches == [2]


@pytest.mark.parametrize(
    "n_frames,bsz,shape", [(32, 8, (4, 8)), (10, 4, (2, 4)), (3, 8, (1, 3)), (1, 8, (1, 1)),
                           (8, 8, (1, 8))]
)
def test_decode_time_batches_takes_a_video_shorter_than_a_batch(n_frames, bsz, shape):
    """The shape logic of the fps measurement: whole batches, the rest
    dropped; fewer frames than a batch make one batch of all of them."""
    t = np.arange(n_frames) / n_frames
    got = tloop.decode_time_batches(t, bsz)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.reshape(-1), t.astype(np.float32)[: shape[0] * shape[1]])


def test_decode_time_batches_refuses_an_empty_video():
    with pytest.raises(ValueError):
        tloop.decode_time_batches([], 8)
