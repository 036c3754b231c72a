"""The UVG 1080p geometry (``benchmark/configs/uvg/erb-uvg1080p.json``: ERB at
strides 5-3-2-2-2 from a 9x16x48 grid) on the port.

On the CPU, at a tiny geometry with the same stride-3 stage between a
stride-5 and a stride-2 one (grid 2x3x8, strides 5, 3, 2, f32, weights from
the benchmark's seeded draw), the port's training forward, its Fusion6
loss, three Adam steps and its deploy fold against the plain reference of
``benchmark/reference``: once with the port's own gate (only the stride-2
block is large enough for the fused stage) and once with the gate lowered
so that the stride-3 block, as at 1080p, runs the fused stage too (its
plain version here).  The same geometry against the JAX package, whose
UVG-1080p flagship it is: JAX initializes, the port loads the pytree, and
the train-mode forward, one Fusion6 step's loss and gradients, the deploy
fold and its frames agree (tolerances as tests/test_torch_train.py and
tests/test_torch_models.py).  The stage route and the gate at the real
shapes, and the ``stage.s<stride>`` spans of a traced CPU step, forward and
backward.

The ``gpu`` tests skip here and run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_uvg1080p.py
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repnerv_tpu.data.frames import adaptive_avg_pool as jpool
from repnerv_tpu.models import generator as jgen
from repnerv_tpu.models.embedding import positional_encoding as jpe
from repnerv_tpu.ops.losses import multi_scale_loss as jloss

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH)]

from harness import arith, inputs  # noqa: E402
from harness.program import load_weights, model_config, train_config  # noqa: E402
from reference import model as M  # noqa: E402
from reference import train as T  # noqa: E402
from repnerv_tpu_torch.data.frames import FrameStore, adaptive_avg_pool  # noqa: E402
from repnerv_tpu_torch.kernels import decode as dk  # noqa: E402
from repnerv_tpu_torch.kernels import launches  # noqa: E402
from repnerv_tpu_torch.kernels import train_tail as tt  # noqa: E402
from repnerv_tpu_torch.models import generator as gen_mod  # noqa: E402
from repnerv_tpu_torch.models.embedding import positional_encoding  # noqa: E402
from repnerv_tpu_torch.models.generator import Generator, generator_to_deploy  # noqa: E402
from repnerv_tpu_torch.ops.losses import multi_scale_loss  # noqa: E402
from repnerv_tpu_torch.train.checkpoint import state_from_jax_params  # noqa: E402
from repnerv_tpu_torch.train.loop import (  # noqa: E402
    TrainState, build_train_step_fn, make_optimizer)
from repnerv_tpu_torch.utils.profiling import trace  # noqa: E402
from test_model_train import tiny_model  # noqa: E402
from test_torch_config_codecs import port_model_cfg  # noqa: E402
from test_torch_train import _check_grads, _port_model  # noqa: E402

FULL = json.loads((BENCH / "configs" / "uvg" / "erb-uvg1080p.json").read_text())
# the tiny geometry: a stride-5 block on a 2x3 grid, then the stride-3 and a
# stride-2 block, 60x90 frames
TINY_MODEL = {"embed": "1.25_4", "stem_dim_num": "16_1", "fc_hw_dim": "2_3_8",
              "strides": [5, 3, 2], "lower_width": 8, "compute_dtype": "float32"}
FRAMES, HEIGHT, WIDTH = 4, 60, 90
SEED = 2 ** 31 + 4321  # as large as the seeds of benchmark runs
# the port's gate, and one low enough for the stride-3 block's 10x15 input
GATES = [gen_mod.KERNEL_MIN_PIXELS, 100]


def tiny_cfg():
    cfg = json.loads(json.dumps(FULL))
    cfg["model"].update(TINY_MODEL)
    cfg["video"] = {"frames": FRAMES, "height": HEIGHT, "width": WIDTH}
    return cfg


def port_model(cfg, p0):
    return load_weights(Generator(model_config(cfg), seed=0, device="cpu"), p0)


def test_the_configuration_is_the_uvg_geometry_at_published_widths():
    m = FULL["model"]
    assert (m["fc_hw_dim"], m["strides"], m["embed"], m["stem_dim_num"]) == (
        "9_16_48", [5, 3, 2, 2, 2], "1.25_40", "512_1")
    d = M.dims(m)
    assert (d["hs"][-1], d["ws"][-1]) == (FULL["video"]["height"], FULL["video"]["width"])
    n = sum(int(np.prod(s)) for _, s, _ in M.param_shapes(m))
    assert n / 1e6 == pytest.approx(13.21, abs=0.005)  # the JAX package's UVG-1080p count
    assert arith.deploy_flops_per_frame(m) / 1e9 == pytest.approx(455.52, abs=0.01)


@pytest.mark.parametrize("gate", GATES)
def test_the_stride3_train_forward_is_the_references(gate, monkeypatch):
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", gate)
    cfg = tiny_cfg()
    m = cfg["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    model = port_model(cfg, p0).train()
    t = torch.tensor([0.0, 0.25, 0.75])
    got = model(positional_encoding(t, m["embed"]))[-1]
    want = M.forward(p0, m, t).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (3, HEIGHT, WIDTH, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("gate", GATES)
def test_three_stride3_adam_steps_are_the_references(gate, monkeypatch):
    """The Fusion6 loss of each step, every leaf's gradient, and each leaf's
    change after three steps."""
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", gate)
    cfg = tiny_cfg()
    m = cfg["model"]
    tcfg = train_config(cfg, {"batch_size": 1}, SEED)
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    frames = inputs.video(FRAMES, HEIGHT, WIDTH, SEED, "cpu")
    times = inputs.frame_times(FRAMES)
    model = port_model(cfg, p0).train()
    state = TrainState(model, make_optimizer(tcfg, model), 0)
    step = build_train_step_fn(tcfg, FRAMES, with_msssim=False)
    store = FrameStore(frames=frames, t=times.numpy())
    rows = [[1], [3], [0]]
    losses, grads = [], []
    for r in rows:
        idx = torch.tensor(r)
        state, aux = step(state, store.gather(idx), times[idx])
        losses.append(float(aux["loss"]))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    ref = T.steps(p0, m, cfg["train"], frames, times, rows, FRAMES)
    np.testing.assert_allclose(losses, ref["loss"], rtol=2e-6)
    for k, p in model.named_parameters():
        for got, want in zip(grads, ref["grads"]):
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-7)
        # the change of each leaf, by its norm: Adam moves an element whose
        # gradient is at round-off level by up to a whole step either way
        d, want = (p.detach() - p0[k]).double(), (ref["params"][k] - p0[k]).double()
        assert float((d - want).norm()) <= 1e-3 * float(want.norm()), k


@pytest.mark.parametrize("gate", GATES)
def test_the_stride3_deploy_fold_and_frames_are_the_references(gate, monkeypatch):
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", gate)
    cfg = tiny_cfg()
    m = cfg["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    dep = generator_to_deploy(port_model(cfg, p0))
    folded = M.deploy_fold(p0, m)
    for blk, (k, b) in zip(dep.layers, folded):
        torch.testing.assert_close(blk.rbr_reparam.weight, k, rtol=0, atol=1e-6)
        torch.testing.assert_close(blk.rbr_reparam.bias, b, rtol=0, atol=1e-6)
    t = torch.tensor([0.125, 0.5])
    with torch.no_grad():
        got = dep.eval()(positional_encoding(t, m["embed"]))[-1]
    want = M.deploy_forward(p0, m, folded, t).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def jax_tiny():
    """The tiny stride-3 geometry as a JAX-package config, and its weights
    from ``init_generator``."""
    cfg = tiny_model(branch_type="ERB", **{k: tuple(v) if k == "strides" else v
                                           for k, v in TINY_MODEL.items()})
    return cfg, jgen.init_generator(jax.random.PRNGKey(19), cfg)


@pytest.mark.parametrize("gate", GATES)
def test_the_stride3_train_forward_and_fusion6_step_match_jax(gate, monkeypatch):
    """The train-mode forward (every head) and one Fusion6 step's loss and
    gradients; outputs within 1e-5, the loss within 1e-5 relative, the
    gradients within 1e-4 of each tensor's largest (the ERB fusion einsums
    sum in other orders on each side)."""
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", gate)
    cfg, params = jax_tiny()
    t = np.array([0.375], np.float32)
    frames = np.random.default_rng(5).random((1, HEIGHT, WIDTH, 3)).astype(np.float32)

    def jax_loss(p):
        outs = jgen.apply_generator(p, jpe(jnp.asarray(t), cfg.embed), cfg, train=True)
        targets = [jpool(jnp.asarray(frames), o.shape[1:3]) for o in outs]
        return jloss(outs, targets, "Fusion6"), outs

    (ref_loss, ref_outs), ref_g = jax.value_and_grad(jax_loss, has_aux=True)(params)
    ref_g = state_from_jax_params(jax.tree.map(np.asarray, ref_g), port_model_cfg(cfg))

    model = _port_model(params, cfg)
    outs = model(positional_encoding(torch.from_numpy(t), cfg.embed))
    targets = [adaptive_avg_pool(torch.from_numpy(frames), o.shape[1:3]) for o in outs]
    loss = multi_scale_loss(outs, targets, "Fusion6")
    loss.backward()
    assert outs[-1].shape == (1, HEIGHT, WIDTH, 3)
    for o, r in zip(outs, ref_outs, strict=True):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=1e-5)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    _check_grads({k: p.grad.numpy() for k, p in model.named_parameters()}, ref_g, 1e-4)


@pytest.mark.parametrize("gate", GATES)
def test_the_stride3_deploy_fold_and_frames_match_jax(gate, monkeypatch):
    """``generator_to_deploy`` on both sides: each block's folded 3x3 conv
    within 1e-6 (tests/test_torch_models.py's fusion tolerance), the
    deployed frames within 1e-5."""
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", gate)
    cfg, params = jax_tiny()
    ref_dep, ref_cfg = jgen.generator_to_deploy(params, cfg)
    want = state_from_jax_params(jax.tree.map(np.asarray, ref_dep), port_model_cfg(ref_cfg))
    dep = generator_to_deploy(_port_model(params, cfg))
    got = dep.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
    t = np.array([0.125, 0.5], np.float32)
    ref = jgen.apply_generator(ref_dep, jpe(jnp.asarray(t), cfg.embed), ref_cfg, train=False)
    with torch.no_grad():
        out = dep.eval()(positional_encoding(torch.from_numpy(t), cfg.embed))
    assert out[-1].shape == (2, HEIGHT, WIDTH, 3)
    np.testing.assert_allclose(out[-1].numpy(), np.asarray(ref[-1]), atol=1e-5)


def test_the_1080p_stride3_stage_takes_the_wgmma_route():
    d = M.dims(FULL["model"])
    cin, c, s = d["blocks"][1]
    assert (cin, c, s) == (48, 96, 3)
    assert dk.stage_route(torch.bfloat16, cin, c, s, 0) == "wgmma"
    assert dk.stage_route(torch.bfloat16, 48, 96, 3, 0) == "wgmma"


def test_arith_and_the_forward_agree_on_the_blocks_that_take_k3(monkeypatch):
    """At the full 1080p shapes (meta tensors: no arithmetic): the blocks
    whose stage ``Generator.forward`` hands to ``fused_stage_train`` are
    those ``arith.stages`` counts for K3, with their strides."""
    calls = []

    def fake(x, w, b, head_w, head_b, stride, act, squash, cdt):
        calls.append((x.shape[1], x.shape[2], x.shape[3], stride))
        c = w.shape[3] // (stride * stride)
        return torch.empty(x.shape[0], x.shape[1] * stride, x.shape[2] * stride,
                           3 if head_w is not None else c, device=x.device,
                           dtype=torch.float32 if head_w is not None else torch.bfloat16)

    monkeypatch.setattr(gen_mod, "fused_stage_train", fake)
    model = Generator(model_config(FULL), seed=0, device="meta").train()
    out = model(torch.empty(1, 80, device="meta"))[-1]
    assert tuple(out.shape) == (1, 1080, 1920, 3)
    want = [(g["h"], g["w"], g["cin"], g["s"]) for g in arith.stages(FULL["model"])
            if g["kernel"]]
    assert calls == want
    assert [c[3] for c in calls] == [3, 2, 2, 2]


def test_a_traced_cpu_step_charges_each_fused_stage_to_its_stride(tmp_path, monkeypatch):
    """With the gate low enough for the stride-3 block (block 0 stays on
    the library conv, as at 1080p): ``stage.s3`` and ``stage.s2`` once each
    inside ``step.forward``, the branch fusion inside each, and once each
    inside ``step.backward``, around the stage's backward."""
    monkeypatch.setattr(gen_mod, "KERNEL_MIN_PIXELS", 100)
    cfg = tiny_cfg()
    tcfg = train_config(cfg, {"batch_size": 1}, SEED)
    p0 = inputs.weights(M.param_shapes(cfg["model"]), SEED, "cpu")
    model = port_model(cfg, p0).train()
    state = TrainState(model, make_optimizer(tcfg, model), 0)
    step = build_train_step_fn(tcfg, FRAMES, with_msssim=False)
    frames = inputs.video(1, HEIGHT, WIDTH, SEED, "cpu")
    with trace(str(tmp_path), "cpu") as rec:
        step(state, frames, inputs.frame_times(FRAMES)[:1])
    stages = {p: s.count for p, s in rec.spans.items() if "stage.s" in p}
    assert stages == {"step.forward/stage.s3": 1, "step.forward/stage.s2": 1,
                      "step.forward/stage.s3/reparam.fuse": 1,
                      "step.forward/stage.s2/reparam.fuse": 1,
                      "step.forward/stage.s3/train_tail.pack_weights": 1,
                      "step.forward/stage.s2/train_tail.pack_weights": 1,
                      "step.backward/stage.s3": 1, "step.backward/stage.s2": 1}
    assert rec.spans["step.forward/reparam.fuse"].count == 1  # block 0, on the library conv


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16_ulp_ok(out, ref):
    """Both round one f32 value (up to summation order) to bf16: the
    stride-2 cases' tolerance (tests/test_torch_train_tail.py)."""
    return bool(((out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs() + 1e-4).all())


@pytest.mark.gpu
def test_cuda_k3_and_k4_at_the_1080p_stride3_stage(cuda):
    """K3 and K4 at block 1 of the UVG geometry (45x80, Cin 48, C 96, s 3,
    bf16, no head) against their plain versions."""
    rng = np.random.default_rng(11)
    h, w, cin, c, s = 45, 80, 48, 96, 3
    x = torch.from_numpy(rng.standard_normal((1, h, w, cin)).astype(np.float32)).to(cuda)
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, c * s * s)).astype(np.float32)
                          * 0.1).to(cuda)
    b = torch.from_numpy(rng.standard_normal(c * s * s).astype(np.float32) * 0.1).to(cuda)
    p = dk.pack_weights(wt, b, s, torch.bfloat16)
    assert p.route == "wgmma"
    xin = x.bfloat16().contiguous()
    before = launches.snapshot()
    out, z = tt.stage_forward(xin, p, "swish", "tanh")
    ref_out, ref_z = tt.stage_forward_reference(xin, p, "swish", "tanh")
    ct = torch.from_numpy(rng.standard_normal((1, h * s, w * s, c)).astype(np.float32))
    ct = ct.to(cuda).bfloat16()
    got = tt.epilogue_backward(z, ct, None, None, s, "swish", "tanh")
    ref = tt.epilogue_backward_reference(z, ct, None, None, s, "swish", "tanh")
    torch.cuda.synchronize()
    counts = launches.since(before)
    assert counts["repnerv_tpu_torch.kernels.train_tail", "FWD_ROUTE_LAUNCHES"]["wgmma"] == 1
    for name in ("FWD_STRIDE_LAUNCHES", "BWD_STRIDE_LAUNCHES"):
        assert {k: v for k, v in counts["repnerv_tpu_torch.kernels.train_tail", name].items()
                if v} == {3: 1}
    assert _bf16_ulp_ok(z, ref_z) and _bf16_ulp_ok(out, ref_out)
    assert got[0].shape == ref[0].shape == (1, h, w, c * s * s)
    assert _bf16_ulp_ok(got[0], ref[0])
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * max(ref[1].abs().max().item(), 1.0)


@pytest.mark.gpu
def test_cuda_one_1080p_step_launches_k3_and_k4_by_stride(cuda):
    """One eager `-b 1` step of erb-uvg1080p at its full size: K3 and K4
    each once at stride 3 and three times at stride 2; block 0 (9x16) stays
    on the library conv."""
    cfg = FULL
    tcfg = train_config(cfg, {"batch_size": 1}, SEED)
    p0 = inputs.weights(M.param_shapes(cfg["model"]), SEED, cuda)
    model = load_weights(Generator(tcfg.model, seed=0, device=cuda), p0).train()
    state = TrainState(model, make_optimizer(tcfg, model), 0)
    step = build_train_step_fn(tcfg, 600, with_msssim=True)
    frames = inputs.video(1, 1080, 1920, SEED, cuda)
    before = launches.snapshot()
    state, aux = step(state, frames, inputs.frame_times(600)[:1].to(cuda))
    torch.cuda.synchronize()
    counts = launches.since(before)
    assert np.isfinite(float(aux["loss"]))
    for name in ("FWD_STRIDE_LAUNCHES", "BWD_STRIDE_LAUNCHES"):
        assert {k: v for k, v in counts["repnerv_tpu_torch.kernels.train_tail", name].items()
                if v} == {3: 1, 2: 3}
    assert counts["repnerv_tpu_torch.kernels.train_tail", "FWD_ROUTE_LAUNCHES"] == {
        "wgmma": 4, "wmma": 0, "wgmma_tf32x3": 0, "fma": 0}
