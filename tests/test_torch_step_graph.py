"""The port's per-step train step (repnerv_tpu_torch/train/loop.py:
``make_train_step``, a ``StepGraph``, driven by ``run_epoch``) on the CPU,
where it runs the eager ``build_train_step_fn``, and on the card, where a
step is one CUDA graph replay of the fused epoch's step on buffers of one
batch.

* Against the JAX package's jitted ``make_train_step`` + ``run_epoch`` from
  the same init (``state_from_jax_params``), 2 epochs of a tiny ERB Fusion6
  model, with the bounds of ``test_two_epoch_fusion6_trajectory_matches_jax``
  (tests/test_torch_train.py): per-epoch loss atol 1e-5, PSNR atol 1e-3 dB,
  lr rtol 1e-6, final weights within 1e-4 of each tensor's largest |value|;
  plain, with prune masks and with the QAT transform.
* On the CPU the step is ``build_train_step_fn``'s to the bit, and the step
  that the card captures (``FusedEpoch.step`` on the one-batch buffers), run
  eagerly, equals it to the bit too: the same operations on the same values.
* On the card: graph against eager to the bit in f32, bf16 and "mixed"
  (cuDNN held to its deterministic algorithms, as chip_smoke.py's phase 6),
  launches a replayed step, a recapture after a new optimizer, and the
  divergence guard's in-place restore replayed on.

The ``gpu`` tests skip here and run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_step_graph.py
(JAX is imported inside the CPU parity tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.kernels import launches
from repnerv_tpu_torch.train import checkpoint as ckpt
from repnerv_tpu_torch.train import loop

TINY = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                   lower_width=4, branch_type="ERB")


def _cfg(dtype="float32", batch_size=1) -> TrainConfig:
    return TrainConfig(model=dataclasses.replace(TINY, compute_dtype=dtype),
                       data=DataConfig(batch_size=batch_size), epochs=2, warmup=0.5, lr=5e-3,
                       loss_type="Fusion6")


def _store(n=4, device="cpu") -> FrameStore:
    video, t = synthetic_video(n, 12, 16, seed=2)
    return FrameStore(frames=torch.from_numpy(video).to(device), t=t)


def _weights(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


class Recorder:
    """A step function that keeps each step's aux."""

    def __init__(self, step):
        self.step, self.auxes = step, []

    def __call__(self, *args):
        state, aux = self.step(*args)
        self.auxes.append(aux)
        return state, aux

    def losses(self) -> torch.Tensor:
        return torch.stack([a["loss"] for a in self.auxes]).cpu()


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def _jax_run(tcfg, params, video, t_all, jmasks=None, param_transform=None):
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.train import loop as jloop

    steps = len(t_all) // tcfg.data.batch_size
    state = jloop.TrainState(params, jloop.make_optimizer(tcfg).init(params),
                             jnp.asarray(0, jnp.int32))
    step = jloop.make_train_step(tcfg, steps, with_msssim=False, param_transform=param_transform)
    store = JStore(frames=jnp.asarray(video), t=t_all)
    out = []
    for epoch in range(2):
        state, m = jloop.run_epoch(state, step, store, tcfg, epoch, masks=jmasks)
        out.append((m.loss, float(m.psnr[-1]), m.lr))
    return out, jax.tree.map(np.asarray, state.params)


def _port_run(ptcfg, start, video, t_all, masks=None, param_transform=None):
    from repnerv_tpu_torch.models.generator import Generator

    model = ckpt.load_state(Generator(ptcfg.model), start).train()
    state = loop.TrainState(model, loop.make_optimizer(ptcfg, model), 0)
    steps = len(t_all) // ptcfg.data.batch_size
    step = loop.make_train_step(ptcfg, steps, with_msssim=False, param_transform=param_transform)
    assert isinstance(step, loop.StepGraph)
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    out = []
    for epoch in range(2):
        state, m = loop.run_epoch(state, step, store, ptcfg, epoch, masks=masks)
        out.append((m.loss, float(m.psnr[-1]), m.lr))
    return out, state


@pytest.mark.parametrize("case", ["plain", "masks", "qat"])
def test_train_step_matches_jax_train_step(case):
    """The slice as a whole: 2 epochs x 4 frames through ``run_epoch`` over
    the port's ``make_train_step`` and over the JAX package's, from the same
    init; prune masks (global L1, 0.3) on the gradients and weights, or the
    QAT fake quantizer (8 bits) before the forward.  Pruned weights stay 0."""
    import jax

    from repnerv_tpu.compress.prune import global_l1_masks as jax_masks
    from repnerv_tpu.compress.qat import make_fake_quant as jax_fake_quant

    from repnerv_tpu_torch.compress.prune import global_l1_masks
    from repnerv_tpu_torch.compress.qat import make_fake_quant
    from repnerv_tpu_torch.models.generator import Generator
    from test_torch_fused_epoch import _check_trajectory, _jax_setup

    tcfg, ptcfg, params, start = _jax_setup(1, "batch", seed=8)
    video, t_all = synthetic_video(4, 12, 16, seed=3)
    masks = None
    if case == "qat":
        ref, ref_params = _jax_run(tcfg, params, video, t_all, param_transform=jax_fake_quant(8, 0))
        got, state = _port_run(ptcfg, start, video, t_all, param_transform=make_fake_quant(8, 0))
    elif case == "masks":
        jmasks, _ = jax_masks(params, "ERB", 0.3)
        params = jax.tree.map(lambda p, m: p if m is None else p * m, params, jmasks,
                              is_leaf=lambda x: x is None)
        start = ckpt.state_from_jax_params(jax.tree.map(np.asarray, params), ptcfg.model)
        masks, _ = global_l1_masks(ckpt.load_state(Generator(ptcfg.model), start), "ERB", 0.3)
        ref, ref_params = _jax_run(tcfg, params, video, t_all, jmasks=jmasks)
        got, state = _port_run(ptcfg, start, video, t_all, masks=masks)
    else:
        ref, ref_params = _jax_run(tcfg, params, video, t_all)
        got, state = _port_run(ptcfg, start, video, t_all)
    assert state.step == 8
    _check_trajectory(got, ref, state, ref_params, ptcfg)
    if masks is not None:
        weights = dict(state.model.named_parameters())
        for k, m in masks.items():
            assert bool((weights[k][m == 0] == 0).all()), k


@pytest.mark.parametrize("dtype,batch_size", [("float32", 1), ("bfloat16", 1), ("mixed", 1),
                                              ("float32", 2)])
def test_cpu_step_is_the_eager_step_bit_for_bit(dtype, batch_size):
    """On a CPU model ``make_train_step`` runs ``build_train_step_fn``: two
    epochs of each from the same weights give equal bits, the per-step aux
    (loss, PSNR, lr) and the weights; nothing is captured."""
    cfg = _cfg(dtype, batch_size)
    store = _store()
    runs = []
    for make in (loop.build_train_step_fn, loop.make_train_step):
        state = loop.init_train_state(cfg, "cpu", seed=0)
        rec = Recorder(make(cfg, 4 // batch_size, with_msssim=False))
        for epoch in range(2):
            state, _ = loop.run_epoch(state, rec, store, cfg, epoch)
        runs.append((rec, state))
    (eager, a), (graph, b) = runs
    assert a.step == b.step == 2 * (4 // batch_size)
    assert torch.equal(eager.losses(), graph.losses())
    for x, y in zip(eager.auxes, graph.auxes):
        assert torch.equal(x["psnr"], y["psnr"]) and x["lr"] == y["lr"]
    wa, wb = _weights(a.model), _weights(b.model)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert graph.step.graph is None and graph.step.captures == 0


@pytest.mark.parametrize("masked", [False, True])
def test_captured_step_run_eagerly_equals_the_eager_step(masked):
    """The step the card captures (``FusedEpoch.step`` over the one-batch
    buffers: frames and t copied in, the learning rate written by ``fill_``,
    row 0 read, ``k`` left at 0), run eagerly on the CPU, equals
    ``build_train_step_fn`` to the bit over 8 steps, masks included."""
    from repnerv_tpu_torch.compress.prune import global_l1_masks

    cfg = _cfg(batch_size=2)
    store = _store(8)
    a = loop.init_train_state(cfg, "cpu", seed=1)
    b = loop.init_train_state(cfg, "cpu", seed=1)
    masks = global_l1_masks(a.model, "ERB", 0.3)[0] if masked else None
    eager = loop.build_train_step_fn(cfg, 4, with_msssim=True)
    graph = loop.make_train_step(cfg, 4, with_msssim=True)
    t_all = torch.from_numpy(store.t)
    for epoch in range(2):
        for rows in torch.from_numpy(loop.epoch_rows(store, cfg, epoch)):
            frames, t = store.gather(rows), t_all[rows]
            lr = float(graph.lr_at(b.step))
            buf = graph._step_buffers(frames)
            graph.frames.copy_(frames)
            buf.t_all.copy_(t)
            buf.lr.fill_(lr)
            graph._steps(b, None, buf, masks, 1)
            b.step += 1
            a, aux = eager(a, frames, t, masks)
            assert int(buf.k) == 0
            assert torch.equal(buf.loss[0], aux["loss"])
            assert torch.equal(buf.psnr[0], aux["psnr"])
            assert torch.equal(buf.msssim[0], aux["msssim"])
    wa, wb = _weights(a.model), _weights(b.model)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_step_buffers_follow_the_batch_shape():
    """A new batch or frame shape makes new buffers and drops the graph; the
    same shape keeps them."""
    step = loop.make_train_step(_cfg(), 4, with_msssim=False)
    x = torch.zeros(2, 12, 16, 3)
    buf = step._step_buffers(x)
    assert torch.equal(buf.perm, torch.arange(2).reshape(1, 2))
    assert buf.lr.shape == (1,) and buf.t_all.shape == (2,) and step.frames.shape == x.shape
    step.graph = object()
    assert step._step_buffers(torch.ones(2, 12, 16, 3)) is buf and step.graph is not None
    buf2 = step._step_buffers(torch.zeros(3, 12, 16, 3))
    assert buf2 is not buf and step.graph is None
    assert buf2.perm.shape == (1, 3) and step.frames.shape == (3, 12, 16, 3)


def test_mark_written_moves_every_version_key():
    """A graph replay writes the weights without Python; ``mark_written``
    moves their versions, so the decode and eval graph keys (and the packed
    decode weights) see the change."""
    cfg = _cfg()
    model = loop.init_train_state(cfg, "cpu", seed=0).model.eval()
    keys = (loop.weights_key(model), loop.decode_graph_key(model, 2, True),
            loop.eval_graph_key(model, (2, 12, 16, 3), False))
    versions = [p._version for p in model.parameters()]
    loop.mark_written(model.parameters())
    assert [p._version for p in model.parameters()] == [v + 1 for v in versions]
    assert loop.weights_key(model) != keys[0]
    assert loop.decode_graph_key(model, 2, True) != keys[1]
    assert loop.eval_graph_key(model, (2, 12, 16, 3), False) != keys[2]


# ---------------------------------------------------------------------------
# On the card: the CUDA graph
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph and capturable Adam have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # graph and eager sum dW in one order
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


# the card's shapes: blocks 3 and 4 (2304 and 9216 input pixels) take the
# fused stage, blocks 1 and 2 the library conv (tests/test_torch_fused_epoch.py)
CARD = ModelConfig(embed="1.25_8", stem_dim_num="64_1", fc_hw_dim="9_16_16",
                   strides=(2, 2, 2, 2), lower_width=16, branch_type="ERB")


def _card_cfg(dtype) -> TrainConfig:
    return TrainConfig(model=dataclasses.replace(CARD, compute_dtype=dtype),
                       data=DataConfig(batch_size=1), epochs=2, warmup=0.5, lr=5e-3,
                       loss_type="Fusion6")


def _card_store(device) -> FrameStore:
    video, t = synthetic_video(6, 144, 256, seed=2)
    return FrameStore(frames=torch.from_numpy(video).to(device), t=t)


def _two_epochs(make, cfg, store, device, seed=0):
    state = loop.init_train_state(cfg, device, seed=seed)
    rec = Recorder(make(cfg, 6, with_msssim=False))
    for epoch in range(2):
        state, _ = loop.run_epoch(state, rec, store, cfg, epoch)
    return state, rec


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_graph_step_equals_eager_step_on_the_card(cuda, dtype):
    """12 steps through ``run_epoch``: the graph step's per-step losses,
    PSNRs and final weights equal the eager step's to the bit; one capture,
    then a replay a step, each counted as an eager step's launches (2 K3 +
    2 K4 + 2 K5 on the kernel path, 2 K5 in "mixed"); aux tensors are not
    overwritten by later steps."""
    cfg = _card_cfg(dtype)
    store = _card_store(cuda)
    a, eager = _two_epochs(loop.build_train_step_fn, cfg, store, cuda)
    before = launches.snapshot()
    b, graph = _two_epochs(loop.make_train_step, cfg, store, cuda)
    counts = launches.since(before)
    assert torch.equal(graph.losses(), eager.losses())
    assert all(torch.equal(x["psnr"], y["psnr"]) for x, y in zip(graph.auxes, eager.auxes))
    wa, wb = _weights(a.model), _weights(b.model)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert graph.step.captures == 1 and b.step == 12
    kernel = dtype != "mixed"
    assert counts["repnerv_tpu_torch.kernels.train_tail", "FWD_LAUNCHES"] == 12 * 2 * kernel
    assert counts["repnerv_tpu_torch.kernels.train_tail", "BWD_LAUNCHES"] == 12 * 2 * kernel
    assert counts["repnerv_tpu_torch.kernels.ssim_blur", "LAUNCHES"] == 12 * 2
    per = graph.step.replay_counts
    assert per["repnerv_tpu_torch.kernels.ssim_blur", "LAUNCHES"] == 2
    assert len({a["loss"].data_ptr() for a in graph.auxes}) == 12


@pytest.mark.gpu
def test_graph_step_recaptures_for_a_new_optimizer_on_the_card(cuda):
    """A new optimizer (a resume into a fresh state's Adam) moves the key: the
    next step runs eagerly and captures again, and the trajectory equals the
    eager step's from the same point; a weight changed in place does not
    (the graph reads the weights by address) and the replay sees it."""
    cfg = _card_cfg("bfloat16")
    store = _card_store(cuda)
    step = loop.make_train_step(cfg, 6, with_msssim=False)
    eager = loop.build_train_step_fn(cfg, 6, with_msssim=False)
    a = loop.init_train_state(cfg, cuda, seed=2)
    b = loop.init_train_state(cfg, cuda, seed=2)
    b, _ = loop.run_epoch(b, step, store, cfg, 0, max_steps=3)
    a, _ = loop.run_epoch(a, eager, store, cfg, 0, max_steps=3)
    assert step.captures == 1
    for s in (a, b):  # the same new optimizer over the same weights
        s.optimizer = loop.make_optimizer(cfg, s.model)
    with torch.no_grad():
        for s in (a, b):
            next(s.model.parameters()).mul_(0.5)
    ra, rb = Recorder(eager), Recorder(step)
    a, _ = loop.run_epoch(a, ra, store, cfg, 1)
    b, _ = loop.run_epoch(b, rb, store, cfg, 1)
    assert step.captures == 2
    assert torch.equal(rb.losses(), ra.losses())
    graph_obj = step.graph
    with torch.no_grad():
        for s in (a, b):
            next(s.model.parameters()).mul_(0.5)
    a, ma = loop.run_epoch(a, eager, store, cfg, 0)
    b, mb = loop.run_epoch(b, step, store, cfg, 0)
    assert step.graph is graph_obj and step.captures == 2
    assert ma.loss == mb.loss


@pytest.mark.gpu
def test_graph_step_replays_on_after_the_guard_restore_on_the_card(cuda):
    """The divergence guard's restore copies the best weights into the
    parameters and zeroes Adam's state in place (its fresh Adam): the key
    stays, the step replays on, and its losses equal the eager step's from
    the restored weights with a fresh Adam."""
    from repnerv_tpu_torch.train.recovery import DivergenceGuard

    cfg = _card_cfg("float32")
    store = _card_store(cuda)
    b, _ = _two_epochs(loop.make_train_step, cfg, store, cuda)
    step = loop.make_train_step(cfg, 6, with_msssim=False)
    b, _ = loop.run_epoch(b, step, store, cfg, 0)
    guard = DivergenceGuard(cfg, log=lambda m: None)
    guard.observe(0, 20.0, b)
    best = _weights(b.model)
    with torch.no_grad():
        for p in b.model.parameters():
            p.add_(0.5)  # a collapse
    b, restored = guard.observe(1, 1.0, b)
    assert restored
    graph_obj = step.graph
    rec = Recorder(step)
    b, _ = loop.run_epoch(b, rec, store, cfg, 1)
    assert step.graph is graph_obj and step.captures == 1

    ref = loop.init_train_state(cfg, cuda, seed=3)
    ref.model.load_state_dict(best)
    ref.step = b.step - 6
    eager = Recorder(loop.build_train_step_fn(cfg, 6, with_msssim=False))
    ref, _ = loop.run_epoch(ref, eager, store, cfg, 1)
    assert torch.equal(rec.losses(), eager.losses())
