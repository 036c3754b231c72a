"""The port's SSIM blur (repnerv_tpu_torch/kernels/ssim_blur.py, K5) and
SSIM / MS-SSIM (ops/ssim.py) against the JAX package, ``ssim_stats`` (the
SSIM term in one launch) against the formula it replaced, and the CUDA blur
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


def _maps(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random(shape, dtype=np.float32)),
            torch.from_numpy(rng.random(shape, dtype=np.float32)))


@pytest.mark.parametrize("shape", [(3, 40, 50), (1, 11, 30), (2, 21, 37)])
def test_moments_reference_is_five_blurs_to_the_bit(shape):
    x, y = _maps(shape, 1)
    got = sb.ssim_moments_reference(x, y, WIN)
    want = [sb.blur_valid_reference(a, WIN) for a in (x, y, x * x, y * y, x * y)]
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(sb.ssim_moments(x, y, WIN), want):  # the Function's forward: the same
        assert torch.equal(g, w)


@pytest.mark.parametrize("needs", [(True, False), (False, True), (True, True)])
def test_moments_function_gradient_matches_autograd(needs):
    """The fused Function's backward (one fused VJP per input that needs a
    gradient: d_x = B(g_mu) + 2 x B(g_xx) + y B(g_xy)) against autograd
    through the plain version.  The three terms add in another order than
    autograd's: within 1e-6 of the largest |entry|."""
    x, y = _maps((2, 23, 31), 2)
    cts = [torch.from_numpy(np.random.default_rng(3 + i).standard_normal((2, 13, 21))
                            .astype(np.float32)) for i in range(5)]

    def grads(fn):
        a = x.clone().requires_grad_(needs[0])
        b = y.clone().requires_grad_(needs[1])
        outs = fn(a, b, WIN)
        sum((o * c).sum() for o, c in zip(outs, cts)).backward()
        return outs, a.grad, b.grad

    outs, gx, gy = grads(sb.ssim_moments)
    ref_outs, ref_gx, ref_gy = grads(sb.ssim_moments_reference)
    for o, r in zip(outs, ref_outs):
        assert torch.equal(o, r)
    for g, r, need in ((gx, ref_gx, needs[0]), (gy, ref_gy, needs[1])):
        if not need:
            assert g is None
            continue
        assert (g - r).abs().max().item() <= 1e-6 * r.abs().max().item()


def test_blur_full_is_the_blur_of_the_padded_cotangent():
    ct = _maps((2, 9, 14), 4)[0]
    want = sb.blur_valid_reference(torch.nn.functional.pad(ct, (10,) * 4), WIN)
    assert torch.equal(sb.blur_full(ct, WIN), want)
    assert tuple(want.shape) == (2, 19, 24)


def test_kernel_wrappers_refuse_other_windows():
    """The kernels take symmetric windows of 3, 5, .. 15 taps (their VJP is
    the same blur only for a symmetric window); the check runs before any
    launch, so it can be held here on a meta tensor."""
    x = torch.zeros(1, 40, 40, device="meta")
    for win in (WIN[:10], (0.5, 0.5), WIN + WIN[:6], (0.2, 0.3, 0.5)):
        with pytest.raises(ValueError):
            sb.blur_valid(x, win)
    with pytest.raises(ValueError):  # not a CUDA tensor
        sb.blur_valid(x, WIN)


C1, C2 = 0.01**2, 0.03**2
# [B, H, W, C] images holding the planes (3, 40, 50), (1, 11, 30), (2, 21, 37)
# and MS-SSIM's level 5 at 720p
STATS_SHAPES = [(1, 40, 50, 3), (1, 11, 30, 1), (2, 21, 37, 1), (1, 45, 80, 3)]


def _formula_means(x, y, win):
    """ops/ssim.py's SSIM formula as it stood before ``ssim_stats``: the
    images' planes, their five moments from ``ssim_moments``, the maps'
    means per channel."""
    b, h, w, c = x.shape
    x2 = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
    y2 = y.permute(0, 3, 1, 2).reshape(b * c, h, w)
    mu1, mu2, e11, e22, e12 = sb.ssim_moments(x2, y2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    cs_map = (2.0 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim_map = ((2.0 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    return ssim_map.mean(dim=(1, 2)).reshape(b, c), cs_map.mean(dim=(1, 2)).reshape(b, c)


@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_stats_reference_is_the_old_formula_to_the_bit(shape):
    """``ssim_stats_reference`` and ``ssim_stats`` on CPU tensors give the old
    formula's means to the bit, and ``ssim_stats`` autograd's gradient
    through it to the bit (the same operations); a CPU call launches
    nothing."""
    x, y = _maps(shape, 11)
    want = _formula_means(x, y, WIN)
    before = dict(sb.ROUTE_LAUNCHES)
    for got in (sb.ssim_stats_reference(x, y, WIN, C1, C2), sb.ssim_stats(x, y, WIN, C1, C2)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sb.ROUTE_LAUNCHES == before

    def grad(fn):
        a = x.clone().requires_grad_(True)
        s, c = fn(a, y, WIN)
        (0.7 * s.sum() - 0.2 * c.sum()).backward()
        return a.grad

    assert torch.equal(grad(lambda a, b, w: sb.ssim_stats(a, b, w, C1, C2)), grad(_formula_means))


@pytest.mark.parametrize("shape", STATS_SHAPES)
@pytest.mark.parametrize("upstream", ["ssim", "cs", "both"])
def test_stats_plain_backward_matches_autograd(shape, upstream):
    """The explicit cotangents of the means and the moments' VJP
    (``stats_vjp_reference``, what the kernel's backward computes) against
    autograd through the formula, in f64, for x and (the moments paired the
    other way) for y: within 1e-10 of the largest |entry|."""
    x, y = (t.double() for t in _maps(shape, 12))
    rng = np.random.default_rng(13)
    g = {k: torch.from_numpy(rng.standard_normal((shape[0], shape[3]))) for k in ("ssim", "cs")}
    if upstream != "both":
        g["cs" if upstream == "ssim" else "ssim"].zero_()
    a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    s, c = sb.ssim_stats_reference(a, b, WIN, C1, C2)
    ((g["ssim"] * s).sum() + (g["cs"] * c).sum()).backward()
    moments = sb.ssim_moments_reference(sb.planes(x), sb.planes(y), WIN)
    d_x = sb.stats_vjp_reference(moments, g["ssim"], g["cs"], x, y, WIN, C1, C2)
    d_y = sb.stats_vjp_reference(sb._paired(moments), g["ssim"], g["cs"], y, x, WIN, C1, C2)
    for got, want in ((d_x, a.grad), (d_y, b.grad)):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-10 * want.abs().max().item()


def test_stats_wrappers_take_cuda_tensors_only():
    """``stats_forward`` and ``stats_vjp`` are the kernel's wrappers alone
    (``ssim_stats`` takes the plain path on a CPU tensor): a CPU tensor is
    refused before any launch, as is a window the kernel does not take."""
    x, y = _maps((1, 40, 50, 3), 16)
    with pytest.raises(ValueError):
        sb.stats_forward(x, y, WIN, C1, C2, keep_moments=False)
    moments = sb.ssim_moments_reference(sb.planes(x), sb.planes(y), WIN)
    g = torch.ones(1, 3)
    with pytest.raises(ValueError):
        sb.stats_vjp(moments, g, g, x, y, WIN, C1, C2)
    meta = torch.zeros(1, 40, 50, 3, device="meta")
    with pytest.raises(ValueError):
        sb.stats_forward(meta, meta, WIN[:10], C1, C2, keep_moments=True)
    assert sb.stats_tiles(720, 1280, 11) == 11 * 23  # 118 output columns and 32 rows a block


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


MOMENT_SHAPES = [
    (3, 40, 50),       # one tile
    (1, 167, 30),      # many row tiles, narrow
    (2, 11, 11),       # one output
    (3, 720, 1280),    # the loss's
    (3, 45, 80),       # the last MS-SSIM level's
    (5, 97, 263),      # ragged in both directions, three column tiles
    (1, 43, 129),      # a column tile of one output column
]


def _as_image(t):
    """[N, H, W] planes -> one [1, H, W, N] image whose planes they are."""
    return t.permute(1, 2, 0)[None].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MOMENT_SHAPES)
def test_cuda_moments_match_plain_bitwise(cuda, shape):
    """The moments a stats launch keeps for the backward, read from an
    image's channels in place, equal the plain blurs to the bit; the means
    are within 1e-6 of the plain ones (the same maps, summed in another
    order)."""
    x, y = (_as_image(t.to(cuda)) for t in _maps(shape, 7))
    before = sb.LAUNCHES
    s, c, got = sb.stats_forward(x, y, WIN, C1, C2, keep_moments=True)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + 1
    want = sb.ssim_moments_reference(sb.planes(x), sb.planes(y), WIN)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip((s, c), sb.ssim_stats_reference(x, y, WIN, C1, C2)):
        assert (g - w).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MOMENT_SHAPES)
def test_cuda_moments_vjp_matches_plain(cuda, shape):
    """One launch per input that needs a gradient; the cotangents formed in
    the loader and the fused sum of three terms within 1e-6 of the largest
    |entry| of the plain backward, and exactly zero where both upstream
    scalars are."""
    x, y = (_as_image(t.to(cuda)) for t in _maps(shape, 8))
    moments = sb.stats_forward(x, y, WIN, C1, C2, keep_moments=True)[2]
    g_s, g_c = (torch.randn(1, shape[0], device=cuda) for _ in range(2))
    before = sb.LAUNCHES
    got = sb.stats_vjp(moments, g_s, g_c, x, y, WIN, C1, C2)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + 1
    want = sb.stats_vjp_reference(moments, g_s, g_c, x, y, WIN, C1, C2)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    zero = torch.zeros_like(g_s)
    assert not sb.stats_vjp(moments, zero, zero, x, y, WIN, C1, C2).any()


@pytest.mark.gpu
@pytest.mark.parametrize("needs,launches", [((True, False), 2), ((True, True), 3)])
def test_cuda_moments_function_launches(cuda, needs, launches):
    x, y = (_as_image(t.to(cuda)) for t in _maps((3, 64, 96), 9))
    x.requires_grad_(needs[0])
    y.requires_grad_(needs[1])
    before = sb.LAUNCHES
    s, c = sb.ssim_stats(x, y, WIN, C1, C2)
    (s.sum() + c.sum()).backward()
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + launches
    assert (x.grad is not None) == needs[0] and (y.grad is not None) == needs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("size,sigma", [(3, 0.8), (7, 1.0), (15, 2.5)])
def test_cuda_blur_other_window_sizes(cuda, size, sigma):
    win = sb.window_tuple(size, sigma)
    x, y = (_as_image(t.to(cuda)) for t in _maps((2, 70, 150), 10))
    s, c, moments = sb.stats_forward(x, y, win, C1, C2, keep_moments=True)
    for g, w in zip(moments, sb.ssim_moments_reference(sb.planes(x), sb.planes(y), win)):
        assert torch.equal(g, w)
    for g, w in zip((s, c), sb.ssim_stats_reference(x, y, win, C1, C2)):
        assert (g - w).abs().max().item() <= 1e-6
    planes = sb.planes(x)
    assert torch.equal(sb.blur_full(planes, win), sb.blur_full_reference(planes, win))


@pytest.mark.gpu
def test_cuda_ssim_and_grad_match_cpu(cuda):
    x, y = _images(b=1, h=48, w=64)
    xc = torch.from_numpy(x).requires_grad_(True)
    (1.0 - ts.ssim(xc, torch.from_numpy(y))).backward()
    xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
    before = sb.LAUNCHES
    out = ts.ssim(xg, torch.from_numpy(y).to(cuda))
    (1.0 - out).backward()
    assert sb.LAUNCHES == before + 2  # the means with the moments kept, their VJP
    ref_g = xc.grad
    assert (xg.grad.cpu() - ref_g).abs().max().item() <= 1e-6 * max(ref_g.abs().max().item(), 1)


@pytest.mark.gpu
def test_cuda_ssim_matches_cpu(cuda):
    x, y = _images(b=1, h=176, w=192)
    ref = float(ts.ms_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    out = float(ts.ms_ssim(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)))
    assert out == pytest.approx(ref, abs=1e-6)


LEVEL_SHAPES = [
    (1, 720, 1280, 3),  # the loss's, and MS-SSIM level 1 at 720p
    (1, 360, 640, 3),
    (1, 180, 320, 3),
    (1, 90, 160, 3),
    (1, 45, 80, 3),     # level 5
    (2, 21, 37, 3),     # small, odd and two images
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LEVEL_SHAPES)
def test_cuda_stats_and_grad_match_plain(cuda, shape):
    """``ssim_stats`` with a gradient: one launch that keeps the moments and
    one VJP per input.  The means within 1e-6 of the plain version's (the
    same maps to the bit, summed in another order); d_x and d_y, written in
    the images' layout, within 1e-6 of the largest |entry| of the plain
    backward (the moments' VJP adds its three terms in another order); a
    second call gives the same bits."""
    x, y = (t.to(cuda) for t in _maps(shape, 14))
    g_s, g_c = (torch.randn(shape[0], shape[3], device=cuda) for _ in range(2))

    def run():
        a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        s, c = sb.ssim_stats(a, b, WIN, C1, C2)
        ((g_s * s).sum() + (g_c * c).sum()).backward()
        return s.detach(), c.detach(), a.grad, b.grad

    before = dict(sb.ROUTE_LAUNCHES)
    first = run()
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in sb.ROUTE_LAUNCHES.items()} == {
        "stats": 0, "stats_grad": 1, "vjp": 2, "blur": 0}
    assert all(torch.equal(u, v) for u, v in zip(first, run()))
    for got, want in zip(first[:2], sb.ssim_stats_reference(x, y, WIN, C1, C2)):
        assert (got - want).abs().max().item() <= 1e-6
    moments = sb.ssim_moments_reference(sb.planes(x), sb.planes(y), WIN)
    wants = (sb.stats_vjp_reference(moments, g_s, g_c, x, y, WIN, C1, C2),
             sb.stats_vjp_reference(sb._paired(moments), g_s, g_c, y, x, WIN, C1, C2))
    for got, want in zip(first[2:], wants):
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LEVEL_SHAPES)
def test_cuda_stats_without_grad_write_no_map(cuda, shape):
    """Under ``no_grad`` (an input that requires a gradient or not) the one
    launch writes the partial sums alone: the call's peak allocation is less
    than one moment map, and its means are the gradient path's bits."""
    x, y = (t.to(cuda) for t in _maps(shape, 15))
    x.requires_grad_(True)
    with_grad = sb.ssim_stats(x, y, WIN, C1, C2)
    b, h, w, c = shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    before = dict(sb.ROUTE_LAUNCHES)
    with torch.no_grad():
        got = sb.ssim_stats(x, y, WIN, C1, C2)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < b * c * (h - 10) * (w - 10) * 4
    assert {r: k - before[r] for r, k in sb.ROUTE_LAUNCHES.items()} == {
        "stats": 1, "stats_grad": 0, "vjp": 0, "blur": 0}
    assert all(torch.equal(u, v.detach()) for u, v in zip(got, with_grad))
