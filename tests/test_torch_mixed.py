"""Training in compute_dtype "mixed" (repnerv_tpu_torch/models/layers.py:
``mxu_conv2d_f32``, ``mxu_matmul_f32``) against the JAX package's custom
VJPs of the same names, on the CPU at small sizes.

Both sides multiply operands rounded to bf16 -- x, w, and in the backward
the cotangent -- and sum in f32: the products are exact, so only the order
of the sums differs.  Tolerances: each op's output and gradients within
1e-5 of the tensor's largest |value|; the generator's per-leaf gradients
within 1e-5 of each leaf's largest |gradient| (``_check_grads`` of
tests/test_torch_train.py); the 2-epoch trajectory with the bounds of
``test_two_epoch_fusion6_trajectory_matches_jax``.  "mixed" never reaches
the fused training stage (the JAX gate, ``generator.py:185``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repnerv_tpu.config import TrainConfig as JaxTrainConfig
from repnerv_tpu.models import generator as jgen
from repnerv_tpu.models import layers as jlayers

from repnerv_tpu_torch.data.frames import FrameStore
from repnerv_tpu_torch.models import generator as tgen
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.models.layers import bf16_round, mxu_conv2d_f32, mxu_matmul_f32
from repnerv_tpu_torch.train import loop as tloop
from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
from test_model_train import tiny_model
from test_torch_config_codecs import port_model_cfg, port_train_cfg
from test_torch_train import _check_grads, _jax_fwd_grads, _np_tree, _port_fwd_grads, _port_model


def _close(got, ref, rel=1e-5):
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 1), (3, 1)])
def test_mxu_conv_and_its_vjp_match_jax(kh, kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    w = rng.standard_normal((kh, kw, 6, 12)).astype(np.float32)  # HWIO
    ct = rng.standard_normal((2, 9, 11, 12)).astype(np.float32)
    out, vjp = jax.vjp(jlayers.mxu_conv2d_f32, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()  # OIHW
    got = mxu_conv2d_f32(xt, wt)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach().numpy(), np.asarray(out))
    _close(xt.grad.numpy(), np.asarray(dx))
    _close(wt.grad.numpy(), np.asarray(dw).transpose(3, 2, 0, 1))


def test_mxu_matmul_and_its_vjp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 80)).astype(np.float32)
    w = rng.standard_normal((80, 96)).astype(np.float32)  # [in, out]
    ct = rng.standard_normal((4, 96)).astype(np.float32)
    out, vjp = jax.vjp(jlayers.mxu_matmul_f32, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()  # [out, in]
    got = mxu_matmul_f32(xt, wt)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach().numpy(), np.asarray(out))
    _close(xt.grad.numpy(), np.asarray(dx))
    _close(wt.grad.numpy(), np.asarray(dw).T)


def test_mixed_backward_rounds_the_cotangent():
    """dX and dW come from the cotangent rounded to bf16 and the rounded
    operands, summed in f32 and not rounded after (C18): autograd through
    the f32 conv of the rounded operands, fed the rounded cotangent, gives
    the same gradients; fed the cotangent as it is, other ones."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 3, generator=g).requires_grad_()
    w = torch.randn(4, 3, 3, 3, generator=g).requires_grad_()
    ct = torch.randn(2, 5, 6, 4, generator=g)
    (mxu_conv2d_f32(x, w) * ct).sum().backward()

    def library_grads(cotangent):
        xr = bf16_round(x.detach()).requires_grad_()
        wr = bf16_round(w.detach()).requires_grad_()
        out = F.conv2d(xr.permute(0, 3, 1, 2), wr, padding=1).permute(0, 2, 3, 1)
        (out * cotangent).sum().backward()
        return xr.grad, wr.grad

    for got, ref in zip((x.grad, w.grad), library_grads(bf16_round(ct))):
        _close(got.numpy(), ref.numpy(), rel=1e-6)
    for got, ref in zip((x.grad, w.grad), library_grads(ct)):
        assert (got - ref).abs().max() > 1e-5 * ref.abs().max()


@pytest.mark.parametrize("branch_type,remat", [("ERB", False), ("NeRV_vanilla", False),
                                               ("DBB", True)])
def test_mixed_generator_grads_match_jax(branch_type, remat):
    """Per-leaf gradients of a tiny generator in "mixed" against jax.grad
    through the custom VJPs: every block conv and the stem matmul."""
    cfg = tiny_model(branch_type=branch_type, fc_hw_dim="3_4_4", strides=(2, 2),
                     compute_dtype="mixed", remat=remat)
    params = jgen.init_generator(jax.random.PRNGKey(9), cfg)
    t = np.array([0.2, 0.8], np.float32)
    ct = np.random.default_rng(4).standard_normal((2, 12, 16, 3)).astype(np.float32)
    ref_out, ref_g = _jax_fwd_grads(params, cfg, t, ct)
    out, g = _port_fwd_grads(_port_model(params, cfg), cfg, t, ct)
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    _check_grads(g, ref_g, 1e-5)


@pytest.mark.parametrize("dtype,stages", [("float32", 2), ("bfloat16", 2), ("mixed", 0)])
def test_mixed_takes_no_fused_training_stage(monkeypatch, dtype, stages):
    """With use_pallas_train (the default) and every stage over the pixel
    gate, f32 and bf16 run both blocks through the fused stage (K3 / K4 on
    the card); "mixed" runs none (C17), as the JAX gate."""
    monkeypatch.setattr(tgen, "KERNEL_MIN_PIXELS", 1)
    calls = []
    real = tgen.fused_stage_train
    monkeypatch.setattr(tgen, "fused_stage_train", lambda *a: calls.append(a[-1]) or real(*a))
    cfg = port_model_cfg(tiny_model(branch_type="ERB", fc_hw_dim="3_4_4", strides=(2, 2),
                                    compute_dtype=dtype))
    gen = Generator(cfg, seed=0).train()
    out = gen(positional_encoding(torch.tensor([0.5]), cfg.embed))[-1]
    out.sum().backward()
    assert len(calls) == stages and set(calls) <= {"float32", "bfloat16"}
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_mixed_two_epoch_trajectory_matches_jax(kernel_gates):
    """A tiny ERB Fusion6 model in "mixed" at -b 1, the SSIM blur on the
    blur path, 2 epochs x 4 frames: the port's fused epoch vs the JAX
    make_train_step + run_epoch from the same init."""
    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.data.frames import synthetic_video
    from repnerv_tpu.train import loop as jloop

    cfg = tiny_model(branch_type="ERB", embed="1.25_4", fc_hw_dim="3_4_6", strides=(2, 2),
                     compute_dtype="mixed")
    tcfg = JaxTrainConfig(model=cfg, epochs=2, warmup=0.5, lr=5e-3, loss_type="Fusion6",
                          manual_seed=1)
    tcfg.data.batch_size = 1
    video, t_all = synthetic_video(4, 12, 16, seed=2)
    params = jgen.init_generator(jax.random.PRNGKey(10), cfg)
    ptcfg = port_train_cfg(tcfg)
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
    epoch_fn = tloop.make_epoch_fn(ptcfg, steps_per_epoch=4)
    store = FrameStore(frames=torch.from_numpy(video), t=t_all)
    got = []
    for epoch in range(2):
        state, m = tloop.run_fused_epoch(state, epoch_fn, store, ptcfg, epoch)
        got.append((m.loss, float(m.psnr[-1]), m.lr))

    assert state.step == 8
    for (l1, p1, lr1), (l2, p2, lr2) in zip(got, ref):
        assert l1 == pytest.approx(l2, abs=1e-5)
        assert p1 == pytest.approx(p2, abs=1e-3)
        assert lr1 == pytest.approx(lr2, rel=1e-6)
    final = {k: v.numpy() for k, v in model.state_dict().items()}
    _check_grads(final, ref_final, 1e-4)


@pytest.fixture
def kernel_gates(monkeypatch):
    """The SSIM-blur path on both sides at tiny sizes (the JAX kernel in
    interpret mode); the fused-stage gates open too, which "mixed" must not
    pass."""
    import repnerv_tpu.ops.ssim as S
    import repnerv_tpu.pallas_kernels.ssim_blur as jsb
    import repnerv_tpu.pallas_kernels.train_tail as jtt

    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)
    monkeypatch.setattr(jgen, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(jtt, "INTERPRET", True)
    monkeypatch.setattr(jsb, "INTERPRET", True)
    monkeypatch.setattr(S, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(tgen, "KERNEL_MIN_PIXELS", 1)
