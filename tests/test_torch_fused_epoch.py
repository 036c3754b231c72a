"""The port's fused epoch (repnerv_tpu_torch/train/loop.py: ``make_epoch_fn`` /
``run_fused_epoch``) on the CPU, where its static-buffer step runs eagerly,
and on the card, where that step is one CUDA graph replay.

* Against the port's ``run_epoch`` (the eager step): equal bits over 2
  epochs, the weights and every epoch's metrics -- the two run the same
  operations on the same values (the learning rate is the same f32 number,
  written into the same optimizer tensor).
* Against the JAX package's ``make_epoch_fn`` + ``run_fused_epoch`` from the
  same init (``state_from_jax_params``), with the bounds of
  ``test_two_epoch_fusion6_trajectory_matches_jax``
  (tests/test_torch_train.py): per-epoch loss atol 1e-5, PSNR atol 1e-3 dB,
  lr rtol 1e-6, final weights within 1e-4 of each tensor's largest |value|;
  for both ``lr_frac_mode`` values, with prune masks and with the QAT
  transform.
* The learning-rate table equals ``lr_at_step`` element for element.

The ``gpu`` tests need the card (the CUDA graph, capturable Adam); they skip
here and run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fused_epoch.py
(JAX is imported inside the CPU parity tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.kernels import launches
from repnerv_tpu_torch.kernels import train_tail as tt
from repnerv_tpu_torch.train import checkpoint as ckpt
from repnerv_tpu_torch.train import loop
from repnerv_tpu_torch.train.schedule import lr_at_step, lr_table

TINY = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                   lower_width=4, branch_type="ERB")


def _cfg(dtype="float32", batch_size=1, **over) -> TrainConfig:
    return TrainConfig(model=dataclasses.replace(TINY, compute_dtype=dtype),
                       data=DataConfig(batch_size=batch_size), epochs=2, warmup=0.5, lr=5e-3,
                       loss_type="Fusion6", **over)


def _store(n=4, device="cpu") -> FrameStore:
    video, t = synthetic_video(n, 12, 16, seed=2)
    return FrameStore(frames=torch.from_numpy(video).to(device), t=t)


def _weights(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype,batch_size", [("float32", 1), ("bfloat16", 1), ("mixed", 1),
                                              ("float32", 2)])
def test_fused_epoch_equals_run_epoch_bit_for_bit(dtype, batch_size):
    """Bound found: equal bits (weights, loss, PSNR, lr) after 2 epochs."""
    cfg = _cfg(dtype, batch_size)
    store = _store()
    steps = store.num_samples // batch_size
    eager = loop.init_train_state(cfg, "cpu", seed=0)
    step = loop.make_train_step(cfg, steps, with_msssim=False)
    fused = loop.init_train_state(cfg, "cpu", seed=0)
    epoch_fn = loop.make_epoch_fn(cfg, steps, with_msssim=False)
    for epoch in range(2):
        eager, m1 = loop.run_epoch(eager, step, store, cfg, epoch)
        fused, m2 = loop.run_fused_epoch(fused, epoch_fn, store, cfg, epoch)
        assert (m2.loss, m2.lr) == (m1.loss, m1.lr)
        np.testing.assert_array_equal(m2.psnr, m1.psnr)
        np.testing.assert_array_equal(m2.msssim, m1.msssim)
    assert fused.step == eager.step == 2 * steps
    w1, w2 = _weights(eager.model), _weights(fused.model)
    for k, v in w1.items():
        assert torch.equal(w2[k], v), k


def test_fused_epoch_respects_max_steps():
    """As tests/test_model_train.py::test_fused_epoch_respects_max_steps: one
    step, and that step is run_epoch's first."""
    cfg = _cfg()
    store = _store()
    state = loop.init_train_state(cfg, "cpu", seed=0)
    state, m = loop.run_fused_epoch(state, loop.make_epoch_fn(cfg, 4), store, cfg, 0, max_steps=1)
    assert state.step == 1
    ref = loop.init_train_state(cfg, "cpu", seed=0)
    ref, r = loop.run_epoch(ref, loop.make_train_step(cfg, 4, with_msssim=False), store, cfg, 0,
                            max_steps=1)
    assert (m.loss, m.lr) == (r.loss, r.lr)
    for k, v in _weights(ref.model).items():
        assert torch.equal(_weights(state.model)[k], v), k


def test_fused_epoch_metrics_carry_msssim_rows():
    """With ``with_msssim`` the epoch's MS-SSIM rows come back (0 on stages
    under the 160-pixel limit), as run_epoch's."""
    cfg = _cfg()
    store = _store()
    a = loop.init_train_state(cfg, "cpu", seed=0)
    a, m = loop.run_fused_epoch(a, loop.make_epoch_fn(cfg, 4, with_msssim=True), store, cfg, 0)
    b = loop.init_train_state(cfg, "cpu", seed=0)
    b, r = loop.run_epoch(b, loop.make_train_step(cfg, 4, with_msssim=True), store, cfg, 0)
    assert m.msssim.shape == m.psnr.shape
    np.testing.assert_array_equal(m.msssim, r.msssim)


@pytest.mark.parametrize("mode", ["batch", "sample"])
@pytest.mark.parametrize("lr_type,lr_steps", [("cosine", ()), ("step", (0.5, 1.5)),
                                              ("const", ())])
def test_lr_table_equals_lr_at_step(mode, lr_type, lr_steps):
    """Element for element, for both lr_frac_mode values (ROADMAP C5), over
    an epoch boundary and the warmup's end."""
    cfg = TrainConfig(epochs=3, warmup=0.4, lr=5e-3, lr_type=lr_type, lr_steps=lr_steps,
                      lr_frac_mode=mode, data=DataConfig(batch_size=3))
    kw = loop._schedule(cfg, steps_per_epoch=5)
    got = lr_table(3, 9, **kw)
    assert got.dtype == np.float32 and got.shape == (9,)
    for i, v in enumerate(got):
        assert v == lr_at_step(3 + i, **kw)
    assert len(set(got.tolist())) > 1 or lr_type == "const"


def test_launch_counts_move_by_a_capture_and_its_replays(monkeypatch):
    """The record a capture takes back and a replay adds (C19): ``since``
    reads what the wrappers counted, ``add`` applies it any number of times
    to the ints and the by-route dicts."""
    for name in ("FWD_LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(tt, name, 5)
    monkeypatch.setattr(tt, "FWD_ROUTE_LAUNCHES", dict.fromkeys(tt.FWD_ROUTE_LAUNCHES, 0))
    before = launches.snapshot()
    tt.FWD_LAUNCHES += 4
    tt.BWD_LAUNCHES += 4
    tt.FWD_ROUTE_LAUNCHES["wgmma"] += 3
    tt.FWD_ROUTE_LAUNCHES["wmma"] += 1
    step = launches.since(before)
    assert step["repnerv_tpu_torch.kernels.train_tail", "FWD_LAUNCHES"] == 4
    assert step["repnerv_tpu_torch.kernels.train_tail", "FWD_ROUTE_LAUNCHES"]["wgmma"] == 3
    launches.add(step, -1)  # the capture ran nothing
    assert launches.snapshot() == before
    launches.add(step, 3)  # three replays
    assert (tt.FWD_LAUNCHES, tt.BWD_LAUNCHES) == (17, 17)
    assert tt.FWD_ROUTE_LAUNCHES["wgmma"] == 9 and tt.FWD_ROUTE_LAUNCHES["wmma"] == 3


def test_resume_files_load_either_way_and_training_continues(tmp_path):
    """A resume file written by a plain Adam (a float learning rate, the
    step count on the host) loads into make_optimizer's Adam, which keeps
    its own learning-rate tensor and flags; a file that Adam writes loads
    back into a plain one.  Training goes on as if no file had been written."""
    cfg = _cfg()
    store = _store()
    epoch_fn = loop.make_epoch_fn(cfg, 4)
    a = loop.init_train_state(cfg, "cpu", seed=0)
    a, _ = loop.run_fused_epoch(a, epoch_fn, store, cfg, 0)
    plain = torch.optim.Adam(a.model.parameters(), lr=1.0, betas=(cfg.beta, 0.999), eps=1e-8)
    plain.load_state_dict(a.optimizer.state_dict())
    for g in plain.param_groups:
        g["lr"] = 1.0  # a plain Adam's float
    ckpt.save_resume(str(tmp_path), a.model, plain, a.step, 1)

    b = loop.init_train_state(cfg, "cpu", seed=1)
    lr_tensor = b.optimizer.param_groups[0]["lr"]
    b.step, start = ckpt.load_resume(str(tmp_path), b.model, b.optimizer)
    assert (b.step, start) == (4, 1)
    group = b.optimizer.param_groups[0]
    assert group["lr"] is lr_tensor and group["fused"] is False and group["capturable"] is False
    p0 = next(b.model.parameters())
    assert b.optimizer.state[p0]["step"].device.type == "cpu"
    a, ma = loop.run_fused_epoch(a, epoch_fn, store, cfg, 1)
    b, mb = loop.run_fused_epoch(b, loop.make_epoch_fn(cfg, 4), store, cfg, 1)
    assert (mb.loss, mb.lr) == (ma.loss, ma.lr)
    for k, v in _weights(a.model).items():
        assert torch.equal(_weights(b.model)[k], v), k

    ckpt.save_resume(str(tmp_path), b.model, b.optimizer, b.step, 2)
    back = torch.optim.Adam(b.model.parameters(), lr=1.0, betas=(cfg.beta, 0.999), eps=1e-8)
    ckpt.load_resume(str(tmp_path), b.model, back)
    assert back.param_groups[0]["lr"] == 1.0
    for p in b.model.parameters():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(back.state[p][key], b.optimizer.state[p][key]), key


# ---------------------------------------------------------------------------
# Against the JAX package's fused epoch
# ---------------------------------------------------------------------------


def _jax_run(tcfg, params, video, t_all, jmasks=None, param_transform=None, epochs=2):
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.train import loop as jloop

    steps = len(t_all) // tcfg.data.batch_size
    state = jloop.TrainState(params, jloop.make_optimizer(tcfg).init(params),
                             jnp.asarray(0, jnp.int32))
    epoch_fn = jloop.make_epoch_fn(tcfg, steps, with_msssim=False,
                                   param_transform=param_transform)
    store = JStore(frames=jnp.asarray(video), t=t_all)
    out = []
    for epoch in range(epochs):
        state, m = jloop.run_fused_epoch(state, epoch_fn, store, tcfg, epoch, masks=jmasks)
        out.append((m.loss, float(m.psnr[-1]), m.lr))
    return out, jax.tree.map(np.asarray, state.params)


def _port_run(ptcfg, start, video, t_all, masks=None, param_transform=None, epochs=2):
    from repnerv_tpu_torch.models.generator import Generator

    model = ckpt.load_state(Generator(ptcfg.model), start).train()
    state = loop.TrainState(model, loop.make_optimizer(ptcfg, model), 0)
    steps = len(t_all) // ptcfg.data.batch_size
    epoch_fn = loop.make_epoch_fn(ptcfg, steps, with_msssim=False,
                                  param_transform=param_transform)
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    out = []
    for epoch in range(epochs):
        state, m = loop.run_fused_epoch(state, epoch_fn, store, ptcfg, epoch, masks=masks)
        out.append((m.loss, float(m.psnr[-1]), m.lr))
    return out, state


def _check_trajectory(got, ref, state, ref_params, ptcfg):
    from test_torch_train import _check_grads

    for (l1, p1, lr1), (l2, p2, lr2) in zip(got, ref):
        assert l1 == pytest.approx(l2, abs=1e-5)
        assert p1 == pytest.approx(p2, abs=1e-3)
        assert lr1 == pytest.approx(lr2, rel=1e-6)
    final = {k: v.numpy() for k, v in state.model.state_dict().items()}
    _check_grads(final, ckpt.state_from_jax_params(ref_params, ptcfg.model), 1e-4)


def _jax_setup(batch_size, mode, seed=7):
    import jax

    from repnerv_tpu.config import TrainConfig as JaxTrainConfig
    from repnerv_tpu.models import generator as jgen
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_train_cfg

    mcfg = tiny_model(branch_type="ERB", embed="1.25_4", fc_hw_dim="3_4_6", strides=(2, 2))
    tcfg = JaxTrainConfig(model=mcfg, epochs=2, warmup=0.5, lr=5e-3, loss_type="Fusion6",
                          manual_seed=1, lr_frac_mode=mode)
    tcfg.data.batch_size = batch_size
    params = jgen.init_generator(jax.random.PRNGKey(seed), mcfg)
    ptcfg = port_train_cfg(tcfg)
    start = ckpt.state_from_jax_params(jax.tree.map(np.asarray, params), ptcfg.model)
    return tcfg, ptcfg, params, start


@pytest.fixture
def kernel_gates(monkeypatch):
    """The fused-stage and SSIM-blur paths on both sides at tiny sizes, as
    tests/test_torch_train.py's fixture: the JAX kernels in interpret mode
    off-TPU, the port's plain versions."""
    import repnerv_tpu.models.generator as jgen
    import repnerv_tpu.ops.ssim as S
    import repnerv_tpu.pallas_kernels.ssim_blur as jsb
    import repnerv_tpu.pallas_kernels.train_tail as jtt

    from repnerv_tpu_torch.models import generator as tgen

    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)
    monkeypatch.setattr(jgen, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(jtt, "INTERPRET", True)
    monkeypatch.setattr(jsb, "INTERPRET", True)
    monkeypatch.setattr(S, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(tgen, "KERNEL_MIN_PIXELS", 1)


@pytest.mark.parametrize("mode,batch_size", [("batch", 1), ("sample", 2)])
def test_fused_epoch_matches_jax_fused_epoch(kernel_gates, mode, batch_size):
    """The slice as a whole: a tiny ERB Fusion6 model, both blocks on the
    fused stage and every SSIM blur on the blur path (the JAX kernels in
    interpret mode), 2 epochs x 4 frames through both fused epochs.  At b = 2
    "sample" and "batch" give other learning rates (the reference's
    adjust_lr denominator)."""
    tcfg, ptcfg, params, start = _jax_setup(batch_size, mode)
    video, t_all = synthetic_video(4, 12, 16, seed=2)
    ref, ref_params = _jax_run(tcfg, params, video, t_all)
    got, state = _port_run(ptcfg, start, video, t_all)
    assert state.step == 2 * (4 // batch_size)
    _check_trajectory(got, ref, state, ref_params, ptcfg)


@pytest.mark.parametrize("qat", [False, True])
def test_fused_epoch_matches_jax_with_masks_or_qat(qat):
    """Prune masks (global L1, 0.3) on the gradients and weights inside the
    step, or the QAT fake quantizer (8 bits) before the forward; the
    library-conv path on both sides.  Pruned weights stay 0."""
    import jax

    from repnerv_tpu.compress.prune import global_l1_masks as jax_masks
    from repnerv_tpu.compress.qat import make_fake_quant as jax_fake_quant

    from repnerv_tpu_torch.compress.prune import global_l1_masks
    from repnerv_tpu_torch.compress.qat import make_fake_quant
    from repnerv_tpu_torch.models.generator import Generator

    tcfg, ptcfg, params, start = _jax_setup(1, "batch", seed=8)
    video, t_all = synthetic_video(4, 12, 16, seed=3)
    if qat:
        ref, ref_params = _jax_run(tcfg, params, video, t_all, param_transform=jax_fake_quant(8, 0))
        got, state = _port_run(ptcfg, start, video, t_all, param_transform=make_fake_quant(8, 0))
    else:
        jmasks, _ = jax_masks(params, "ERB", 0.3)
        params = jax.tree.map(lambda p, m: p if m is None else p * m, params, jmasks,
                              is_leaf=lambda x: x is None)
        start = ckpt.state_from_jax_params(jax.tree.map(np.asarray, params), ptcfg.model)
        masks, _ = global_l1_masks(ckpt.load_state(Generator(ptcfg.model), start), "ERB", 0.3)
        ref, ref_params = _jax_run(tcfg, params, video, t_all, jmasks=jmasks)
        got, state = _port_run(ptcfg, start, video, t_all, masks=masks)
        weights = dict(state.model.named_parameters())
        for k, m in masks.items():
            assert bool((weights[k][m == 0] == 0).all()), k
    _check_trajectory(got, ref, state, ref_params, ptcfg)


# ---------------------------------------------------------------------------
# On the card: the CUDA graph
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph and capturable Adam have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# the card's shapes: blocks 3 and 4 (2304 and 9216 input pixels) take the
# fused stage, blocks 1 and 2 the library conv
CARD = ModelConfig(embed="1.25_8", stem_dim_num="64_1", fc_hw_dim="9_16_16",
                   strides=(2, 2, 2, 2), lower_width=16, branch_type="ERB")


def _card_cfg(dtype, **over) -> TrainConfig:
    return TrainConfig(model=dataclasses.replace(CARD, compute_dtype=dtype, **over),
                       data=DataConfig(batch_size=1), epochs=2, warmup=0.5, lr=5e-3,
                       loss_type="Fusion6")


def _card_store(device) -> FrameStore:
    video, t = synthetic_video(6, 144, 256, seed=2)
    return FrameStore(frames=torch.from_numpy(video).to(device), t=t)


def _eager_and_graph(cfg, store, device):
    """Per-step losses of one epoch: the eager step, and the fused epoch
    (graph), from the same weights; the fused epoch's launch counts."""
    perm = loop.epoch_rows(store, cfg, 0)
    a = loop.init_train_state(cfg, device, seed=0)
    step = loop.build_train_step_fn(cfg, len(perm), with_msssim=False)
    t_all = torch.from_numpy(store.t).to(device)
    eager = []
    for r in torch.from_numpy(perm).to(device):
        a, aux = step(a, store.gather(r), t_all[r])
        eager.append(aux["loss"])
    b = loop.init_train_state(cfg, device, seed=0)
    epoch_fn = loop.make_epoch_fn(cfg, len(perm))
    before = launches.snapshot()
    b, aux = epoch_fn(b, store, perm, None)
    counts = launches.since(before)
    return torch.stack(eager).cpu(), aux["loss"].cpu(), b, epoch_fn, counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3), ("mixed", 1e-4)])
def test_graph_step_equals_eager_step_on_the_card(cuda, dtype, tol):
    """The same kernels in the same order: per-step losses within ``tol``
    relative, chip_smoke.py's GRAPH_TOL (cuDNN's dX / dW algorithms may sum
    in another order from call to call); the fused stages launch 2 K3 + 2 K4
    a step (4 stages, the first two under 1024 input pixels), K5 twice (the
    loss's SSIM and its VJP), counted in the replays too (C19)."""
    cfg = _card_cfg(dtype)
    store = _card_store(cuda)
    eager, graph, b, _, counts = _eager_and_graph(cfg, store, cuda)
    rel = ((graph - eager).abs() / eager.abs()).max().item()
    assert rel <= tol, rel
    assert b.step == 6
    kernel = dtype != "mixed"
    assert counts["repnerv_tpu_torch.kernels.train_tail", "FWD_LAUNCHES"] == 6 * 2 * kernel
    assert counts["repnerv_tpu_torch.kernels.train_tail", "BWD_LAUNCHES"] == 6 * 2 * kernel
    assert counts["repnerv_tpu_torch.kernels.ssim_blur", "LAUNCHES"] == 6 * 2


@pytest.mark.gpu
def test_graph_holds_remat_and_the_restored_state_on_the_card(cuda):
    """remat (torch.utils.checkpoint without RNG state) under capture; a
    divergence-guard restore copies into the captured tensors, so the next
    epoch replays the same graph on the restored weights with fresh moments
    (C20), and its loss equals an eager epoch's from the restored weights
    with a fresh Adam."""
    from repnerv_tpu_torch.train.recovery import DivergenceGuard

    cfg = _card_cfg("float32", remat=True)
    store = _card_store(cuda)
    eager, graph, b, epoch_fn, _ = _eager_and_graph(cfg, store, cuda)
    assert ((graph - eager).abs() / eager.abs()).max().item() <= 1e-5
    guard = DivergenceGuard(cfg, log=lambda m: None)
    guard.observe(0, 20.0, b)
    best = _weights(b.model)
    with torch.no_grad():
        for p in b.model.parameters():
            p.add_(0.5)  # a collapse
    tensors = [t for st in b.optimizer.state.values() for t in st.values()]
    b, restored = guard.observe(1, 1.0, b)
    assert restored
    after = [t for st in b.optimizer.state.values() for t in st.values()]
    assert len(after) == len(tensors) and all(x is y for x, y in zip(after, tensors))
    assert all(not t.any() for t in tensors)
    graph_obj = epoch_fn.graph
    b, m = loop.run_fused_epoch(b, epoch_fn, store, cfg, 1)
    assert epoch_fn.graph is graph_obj  # replayed, not captured again

    ref = loop.init_train_state(cfg, cuda, seed=3)
    ref.model.load_state_dict(best)
    ref.step = 6
    ref, r = loop.run_epoch(ref, loop.build_train_step_fn(cfg, 6, with_msssim=False), store, cfg,
                            1)
    assert m.loss == pytest.approx(r.loss, rel=1e-5)


@pytest.mark.gpu
def test_capture_after_resume_on_the_card(cuda, tmp_path):
    """A resume file written on the CPU by the eager path loads into the
    card's capturable Adam (its step counts move to the card), the fused
    epoch captures on it, and the file it writes loads back on the CPU."""
    cfg = _card_cfg("bfloat16")
    store = _card_store(cuda)
    cpu = loop.init_train_state(cfg, "cpu", seed=0)
    cpu, _ = loop.run_epoch(cpu, loop.make_train_step(cfg, 6, with_msssim=False),
                            _card_store("cpu"), cfg, 0, max_steps=2)
    ckpt.save_resume(str(tmp_path), cpu.model, cpu.optimizer, cpu.step, 1)
    card = loop.init_train_state(cfg, cuda, seed=1)
    card.step, start = ckpt.load_resume(str(tmp_path), card.model, card.optimizer)
    p0 = next(card.model.parameters())
    assert card.optimizer.state[p0]["step"].device == p0.device
    assert card.optimizer.param_groups[0]["capturable"]
    card, m = loop.run_fused_epoch(card, loop.make_epoch_fn(cfg, 6), store, cfg, start)
    assert np.isfinite(m.loss) and card.step == 8
    ckpt.save_resume(str(tmp_path), card.model, card.optimizer, card.step, 2)
    back = loop.init_train_state(cfg, "cpu", seed=2)
    assert ckpt.load_resume(str(tmp_path), back.model, back.optimizer) == (8, 2)
    assert back.optimizer.state[next(back.model.parameters())]["step"].device.type == "cpu"
