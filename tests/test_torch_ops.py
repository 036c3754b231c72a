"""The port's losses, metrics, LR schedule and data side against the JAX
package, on the CPU.

Inputs come from a numpy seed and go into both sides.  Tolerances:
  * losses and metrics atol 1e-6 (f32 means over a few thousand values,
    reduced in different orders; Fusion13/15's FFT term at rtol 1e-5, the
    FFTs' own rounding);
  * the schedule rtol 1e-6 (both compute in f32 in the same order; cos may
    differ in the last bit);
  * the synthetic video byte-equal, the epoch permutations equal, adaptive
    pooling atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repnerv_tpu.data import frames as jframes
from repnerv_tpu.ops import losses as jlosses
from repnerv_tpu.ops import metrics as jmetrics
from repnerv_tpu.train import schedule as jschedule

from repnerv_tpu_torch.data import frames as tframes
from repnerv_tpu_torch.ops import losses as tlosses
from repnerv_tpu_torch.ops import metrics as tmetrics
from repnerv_tpu_torch.train import schedule as tschedule


def _pair(b=2, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    return pred, target


MS_LOSSES = ("Fusion10", "Fusion11", "Fusion12", "Fusion15")


@pytest.mark.parametrize("loss_type", [t for t in tlosses.LOSS_TYPES if t not in MS_LOSSES])
def test_losses_and_grads_match_jax(loss_type):
    import jax

    pred, target = _pair(b=1, seed=len(loss_type))
    ref, ref_g = jax.value_and_grad(
        lambda p: jlosses.loss_fn(p, jnp.asarray(target), loss_type)
    )(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    out = tlosses.loss_fn(p, torch.from_numpy(target), loss_type)
    out.backward()
    fft = loss_type == "Fusion13"
    assert out.item() == pytest.approx(float(ref), abs=1e-6, rel=1e-5 if fft else 0)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(p.grad.numpy(), ref_g, atol=1e-5 * np.abs(ref_g).max())


@pytest.mark.parametrize("loss_type", MS_LOSSES)
def test_msssim_losses_match_jax(loss_type):
    """The MS-SSIM variants at the smallest legal side (> 160).  MS-SSIM is
    a product of five powers of per-level means, which magnifies last-bit
    differences: value atol 1e-5 (as test_ms_ssim_matches_jax), and for
    Fusion10 the gradient within 1e-4 of its largest entry."""
    import jax

    pred, target = _pair(b=1, h=168, w=176, seed=9)
    p = torch.from_numpy(pred).requires_grad_(loss_type == "Fusion10")
    out = tlosses.loss_fn(p, torch.from_numpy(target), loss_type)
    if loss_type != "Fusion10":
        ref = jlosses.loss_fn(jnp.asarray(pred), jnp.asarray(target), loss_type)
        assert out.item() == pytest.approx(float(ref), abs=1e-5, rel=1e-5)
        return
    ref, ref_g = jax.value_and_grad(
        lambda a: jlosses.loss_fn(a, jnp.asarray(target), loss_type)
    )(jnp.asarray(pred))
    out.backward()
    assert out.item() == pytest.approx(float(ref), abs=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(p.grad.numpy(), ref_g, atol=1e-4 * np.abs(ref_g).max())


def test_unknown_loss_raises():
    with pytest.raises(KeyError):
        tlosses.loss_fn(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3), "L3")


def test_multi_scale_loss_weights_all_but_last():
    outs = [_pair(b=2, h=12, w=16, seed=1)[0], _pair(b=2, h=24, w=32, seed=2)[0]]
    tgts = [_pair(b=2, h=12, w=16, seed=3)[0], _pair(b=2, h=24, w=32, seed=4)[0]]
    ref = jlosses.multi_scale_loss([jnp.asarray(o) for o in outs],
                                   [jnp.asarray(t) for t in tgts], "Fusion6", 0.5)
    out = tlosses.multi_scale_loss([torch.from_numpy(o) for o in outs],
                                   [torch.from_numpy(t) for t in tgts], "Fusion6", 0.5)
    assert out.item() == pytest.approx(float(ref), abs=1e-6)


def test_metrics_match_jax():
    small, small_t = _pair(b=2, h=24, w=32, seed=5)
    big, big_t = _pair(b=2, h=176, w=192, seed=6)
    jo, jt = [jnp.asarray(small), jnp.asarray(big)], [jnp.asarray(small_t), jnp.asarray(big_t)]
    to, tt_ = [torch.from_numpy(small), torch.from_numpy(big)], [
        torch.from_numpy(small_t), torch.from_numpy(big_t)]
    np.testing.assert_allclose(tmetrics.psnr_fn(to, tt_).numpy(),
                               np.asarray(jmetrics.psnr_fn(jo, jt)), atol=1e-5)
    ms = tmetrics.msssim_fn(to, tt_).numpy()
    assert ms.shape == (2, 2) and (ms[:, 0] == 0).all()  # 24 x 32 is under the gate
    np.testing.assert_allclose(ms, np.asarray(jmetrics.msssim_fn(jo, jt)), atol=1e-5)
    x = np.array([[31.2345, 0.98765], [30.0, 1.0]])
    for group in (False, True):
        assert tmetrics.round_tensor(x, 2, group) == jmetrics.round_tensor(x, 2, group)


LR_CASES = [
    dict(lr_type="cosine", epochs=20, warmup_epochs=4),
    dict(lr_type="cosine", epochs=3, warmup_epochs=0),
    dict(lr_type="step", epochs=10, warmup_epochs=2, lr_steps=(3.0, 6.5)),
    dict(lr_type="const", epochs=10, warmup_epochs=1),
]


@pytest.mark.parametrize("case", LR_CASES, ids=lambda c: f"{c['lr_type']}{c['epochs']}")
@pytest.mark.parametrize("mode", ["batch", "sample"])
def test_lr_schedule_matches_jax(case, mode):
    """Both lr_frac_mode denominators (trap C5): "sample" advances the
    intra-epoch fraction by 1/(steps * batch) per step."""
    spe, bsz = 7, 4
    samples = spe * bsz if mode == "sample" else None
    for step in range(case["epochs"] * spe):
        kw = dict(base_lr=5e-3, steps_per_epoch=spe, samples_per_epoch=samples, **case)
        ref = float(jschedule.lr_at_step(jnp.asarray(step), **kw))
        out = tschedule.lr_at_step(step, **kw)
        assert out.dtype == np.float32
        assert float(out) == pytest.approx(ref, rel=1e-6, abs=1e-12), (step, mode)


@pytest.mark.parametrize("n,h,w,seed", [(3, 24, 40, 0), (2, 45, 80, 7)])
def test_synthetic_video_is_byte_equal(n, h, w, seed):
    ref_f, ref_t = jframes.synthetic_video(n, h, w, seed=seed)
    out_f, out_t = tframes.synthetic_video(n, h, w, seed=seed)
    np.testing.assert_array_equal(out_f, ref_f)
    np.testing.assert_array_equal(out_t, ref_t)


def test_frame_store_order_and_gather():
    frames, t = tframes.synthetic_video(7, 8, 12, seed=1)
    jstore = jframes.FrameStore(frames=frames, t=t, frame_gap=2)
    store = tframes.FrameStore(frames=torch.from_numpy(frames), t=t, frame_gap=2)
    assert store.num_samples == jstore.num_samples == 3
    for kw in (dict(shuffle=True, seed=5, drop_last=True), dict(shuffle=False, seed=0, drop_last=False)):
        got = list(store.epoch_batches(2, **kw))
        ref = list(jstore.epoch_batches(2, **kw))
        assert len(got) == len(ref)
        for (r1, t1), (r2, t2) in zip(got, ref):
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(t1, t2)
            np.testing.assert_array_equal(store.gather(r1).numpy(), np.asarray(jstore.gather(r2)))


@pytest.mark.parametrize("out_hw", [(6, 8), (12, 16), (5, 7)])
def test_adaptive_avg_pool_matches_jax_and_torch(out_hw):
    x = np.random.default_rng(2).uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    out = tframes.adaptive_avg_pool(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(out, np.asarray(jframes.adaptive_avg_pool(jnp.asarray(x), out_hw)),
                               atol=1e-6)
    ref = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_allclose(out, ref.permute(0, 2, 3, 1).numpy(), atol=1e-6)


def test_make_frame_store_synth_and_budget():
    from repnerv_tpu_torch.config import DataConfig

    cfg = DataConfig(dataset="synth", data_dir="/nonexistent", synthetic_frames=3,
                     synthetic_hw=(8, 12), test_gap=1)
    store = tframes.make_frame_store(cfg, "cpu")
    ref, _ = jframes.synthetic_video(3, 8, 12, seed=0)
    np.testing.assert_array_equal(store.frames.numpy(), ref)
    # over the device budget the video stays on the host; photo builds
    big = tframes.make_frame_store(DataConfig(dataset="synth", data_dir="/nonexistent",
                                              synthetic_frames=2, synthetic_hw=(512, 768),
                                              hbm_budget_mb=1), "cpu")
    assert isinstance(big.frames, np.ndarray) and not big.resident
    np.testing.assert_array_equal(big.frames, jframes.synthetic_video(2, 512, 768, seed=0)[0])
    photo = tframes.make_frame_store(DataConfig(dataset="photo", data_dir="/nonexistent",
                                                synthetic_frames=2, synthetic_hw=(16, 24)), "cpu")
    np.testing.assert_array_equal(photo.frames.numpy(), jframes.photo_video(2, 16, 24)[0])
