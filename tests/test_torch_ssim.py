"""The port's SSIM blur (repnerv_tpu_torch/kernels/ssim_blur.py, K5) and
SSIM / MS-SSIM (ops/ssim.py) against the JAX package, and the CUDA blur
against its plain version on the card.

On the CPU the port's blur is the plain version; the JAX side runs the
Pallas blur in interpret mode (as tests/test_pallas.py does) or its
slice-sum reference.  Tolerances: atol 1e-6 on blurred values of O(1)
inputs and on SSIM (both sides do the same f32 multiplies and adds in the
same tap order; the f32 window values may differ in the last bit, and the
spatial means reduce in different orders); atol 1e-5 on gradients, which
add a few thousand such terms.  On the card the kernel and the plain
version run the same rounded operations, so they agree to the bit.

JAX is imported inside the parity tests so that the CUDA-only tests run
where JAX is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_ssim.py
"""

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.kernels import ssim_blur as sb
from repnerv_tpu_torch.ops import ssim as ts

WIN = sb.window_tuple(11, 1.5)


@pytest.fixture
def jax_interpret(monkeypatch):
    import repnerv_tpu.ops.ssim as S
    import repnerv_tpu.pallas_kernels.ssim_blur as jsb

    monkeypatch.setattr(jsb, "INTERPRET", True)
    monkeypatch.setattr(S, "PALLAS_MIN_PIXELS", 1)


def test_window_matches_jax():
    from repnerv_tpu.pallas_kernels.ssim_blur import window_tuple

    assert sb.window_tuple(11, 1.5) == window_tuple(11, 1.5)
    assert sb.window_tuple(7, 1.0) == window_tuple(7, 1.0)


@pytest.mark.parametrize("shape", [(3, 40, 50), (1, 167, 30), (2, 11, 11), (4, 21, 37)])
def test_blur_and_vjp_match_jax_kernel(jax_interpret, shape):
    """Forward and VJP vs the Pallas blur in interpret mode, at square,
    ragged-tile, minimal and odd shapes."""
    import jax
    import jax.numpy as jnp

    import repnerv_tpu.pallas_kernels.ssim_blur as jsb

    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal((shape[0], shape[1] - 10, shape[2] - 10)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jsb.gauss_blur_valid(a, WIN), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = sb.gauss_blur_valid(xt, WIN)
    out.backward(torch.from_numpy(ct))
    assert tuple(out.shape) == out_j.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), atol=1e-5)


def _images(b=1, h=176, w=192, seed=3):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    x = sig(rng.standard_normal((b, h, w, 3))).astype(np.float32)
    y = sig(rng.standard_normal((b, h, w, 3))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("pallas", [True, False])
def test_ssim_and_grad_match_jax(monkeypatch, pallas):
    """Against both of the JAX package's blur paths: the Pallas kernel
    (interpret mode) and the slice-sum reference."""
    import jax
    import jax.numpy as jnp

    import repnerv_tpu.ops.ssim as S
    import repnerv_tpu.pallas_kernels.ssim_blur as jsb

    if pallas:
        monkeypatch.setattr(jsb, "INTERPRET", True)
        monkeypatch.setattr(S, "PALLAS_MIN_PIXELS", 1)
    x, y = _images(h=48, w=64)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    ref = float(S.ssim(jx, jy))
    ref_g = np.asarray(jax.grad(lambda a: 1.0 - S.ssim(a, jy))(jx))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = ts.ssim(xt, torch.from_numpy(y))
    (1.0 - out).backward()
    assert out.item() == pytest.approx(ref, abs=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, atol=1e-6 * max(np.abs(ref_g).max(), 1))


def test_ms_ssim_matches_jax():
    """176 x 192 has odd-sized pyramid levels (11 x 12 at level 5), so the
    one-sided avg-pool padding runs too.  atol 1e-5, what the JAX package
    holds its own two blur paths to (test_pallas.py): the product of the
    five levels' powers magnifies the last-bit differences of small cs."""
    import jax.numpy as jnp

    import repnerv_tpu.ops.ssim as S

    x, y = _images()
    ref = float(S.ms_ssim(jnp.asarray(x), jnp.asarray(y)))
    out = float(ts.ms_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    assert out == pytest.approx(ref, abs=1e-5)


def test_ssim_per_image_and_batch():
    import jax.numpy as jnp

    import repnerv_tpu.ops.ssim as S

    x, y = _images(b=2, h=24, w=40, seed=4)
    ref = np.asarray(S.ssim(jnp.asarray(x), jnp.asarray(y), size_average=False))
    out = ts.ssim(torch.from_numpy(x), torch.from_numpy(y), size_average=False).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_avg_pool_matches_jax():
    import jax.numpy as jnp

    import repnerv_tpu.ops.ssim as S

    x = np.random.default_rng(5).standard_normal((2, 7, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ts.avg_pool_2x2(torch.from_numpy(x)).numpy(),
        np.asarray(S._avg_pool_2x2_torch(jnp.asarray(x))),
        atol=1e-7,
    )


def test_ms_ssim_rejects_small_images():
    x = torch.zeros(1, 160, 200, 3)
    with pytest.raises(ValueError):
        ts.ms_ssim(x, x)


# ---------------------------------------------------------------------------
# On the card: the CUDA blur against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(3, 40, 50), (1, 167, 30), (2, 11, 11), (3, 720, 1280), (3, 45, 80), (5, 97, 200)]
)
def test_cuda_blur_matches_plain_bitwise(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    x = x.to(cuda).requires_grad_(True)
    before = sb.LAUNCHES
    out = sb.gauss_blur_valid(x, WIN)
    ct = torch.randn_like(out)
    out.backward(ct)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + 2  # forward and VJP
    ref = sb.blur_valid_reference(x.detach(), WIN)
    ref_dx = sb.blur_valid_reference(torch.nn.functional.pad(ct, (10,) * 4), WIN)
    assert torch.equal(out.detach(), ref)
    assert torch.equal(x.grad, ref_dx)


@pytest.mark.gpu
def test_cuda_ssim_matches_cpu(cuda):
    x, y = _images(b=1, h=176, w=192)
    ref = float(ts.ms_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    out = float(ts.ms_ssim(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)))
    assert out == pytest.approx(ref, abs=1e-6)
