"""The port's fused decode stage (repnerv_tpu_torch/kernels/decode.py) against
the JAX package's Pallas kernel, and the CUDA kernel against its plain
version on the card.

On the CPU the port's wrapper runs the plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_pallas.py does.
Tolerance: atol 1e-5 in f32, what test_pallas.py holds the Pallas kernel to
under conftest.py's "highest" matmul precision (both sides sum the same f32
products in different orders).

JAX is imported inside the parity tests so that the CUDA-only tests run
where JAX is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_decode_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.kernels import decode as dk

ACTS = list(dk.ACT_CODES)


def _inputs(B=2, H=8, W=16, Cin=8, C=4, s=2, head=False, seed=0):
    rng = np.random.default_rng(seed)
    cout = C * s * s
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    hw = (rng.standard_normal((1, 1, C, 3)) * 0.2).astype(np.float32) if head else None
    hb = np.asarray([0.1, -0.2, 0.3], np.float32) if head else None
    return x, w, b, hw, hb


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_kernel(x, w, b, s, act, hw, hb, squash):
    import jax.numpy as jnp

    from repnerv_tpu.pallas_kernels.decode import fused_conv_ps_act

    out = fused_conv_ps_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s, act,
        head_w=None if hw is None else jnp.asarray(hw),
        head_b=None if hb is None else jnp.asarray(hb),
        out_squash=squash, compute_dtype=jnp.float32, interpret=True,
    )
    return np.asarray(out)


@pytest.mark.parametrize("cout,stride", [(16, 2), (12, 2), (75, 5), (4, 1), (27, 3)])
def test_shuffle_permutation_matches_jax(cout, stride):
    from repnerv_tpu.pallas_kernels.decode import shuffle_weight_permutation

    np.testing.assert_array_equal(
        dk.shuffle_weight_permutation(cout, stride).numpy(),
        np.asarray(shuffle_weight_permutation(cout, stride)),
    )


@pytest.mark.parametrize("head", [None, "tanh", "sigmoid"])
@pytest.mark.parametrize("stride", [1, 2, 5])
def test_plain_stage_matches_jax_kernel(stride, head):
    C = 4 if head else 3
    x, w, b, hw, hb = _inputs(C=C, s=stride, head=head is not None)
    ref = _jax_kernel(x, w, b, stride, "swish", hw, hb, head)
    before = dk.LAUNCHES
    out = dk.fused_conv_ps_act(
        _t(x), _t(w), _t(b), stride, "swish", head_w=_t(hw), head_b=_t(hb),
        out_squash=head, compute_dtype=torch.float32,
    )
    assert dk.LAUNCHES == before  # a CPU tensor takes the plain version, no launch
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_plain_stage_activations_match_jax_kernel(act):
    x, w, b, _, _ = _inputs(H=4, C=3, s=2, seed=1)
    x *= 3.0  # reach the saturating parts of relu6 / hardswish / softplus
    ref = _jax_kernel(x, w, b, 2, act, None, None, None)
    out = dk.fused_conv_ps_act_reference(
        _t(x), _t(w), _t(b), 2, act, compute_dtype=torch.float32
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_plain_stage_bf16_cast_points():
    """bf16: inputs and weights round to bf16, everything after the products
    is f32, and only the output rounds again (the JAX kernel's cast points).
    Against the f32 plain version on the pre-rounded inputs the only
    difference is that last rounding: at most half a bf16 ulp, 2^-8 |ref|."""
    x, w, b, _, _ = _inputs(C=3, s=2, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    out = dk.fused_conv_ps_act(xb, wb, _t(b), 2, "swish", compute_dtype=torch.bfloat16)
    ref = dk.fused_conv_ps_act(
        xb.float(), wb.float(), _t(b), 2, "swish", compute_dtype=torch.float32
    )
    assert out.dtype == torch.bfloat16
    diff = (out.float() - ref).abs()
    assert bool((diff <= 2.0**-8 * ref.abs()).all())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, b, _, _ = _inputs(C=3, s=2)
    p = dk.pack_weights(_t(w), _t(b), 2, torch.float32)
    with pytest.raises(ValueError):
        dk.pack_weights(_t(w)[:1], _t(b), 2, torch.float32)  # not 3x3
    with pytest.raises(ValueError):
        dk.decode_stage(torch.zeros(1, 4, 4, 8, device="meta"), p)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "H,W,Cin,C,s,head",
    [
        (8, 16, 8, 3, 1, None),
        (8, 16, 8, 4, 2, "tanh"),
        (8, 16, 8, 4, 2, "sigmoid"),
        (7, 20, 26, 26, 5, None),  # Cin and C not multiples of the tiles
        (5, 13, 96, 96, 2, None),
        (5, 13, 96, 96, 2, "tanh"),
        (6, 9, 16, 100, 3, "tanh"),  # C over one 96-wide chunk: the head sums two
        (3, 11, 12, 130, 2, None),  # C over one 96-wide chunk
    ],
)
def test_cuda_kernel_matches_plain(cuda, dtype, H, W, Cin, C, s, head):
    x, w, b, hw, hb = _inputs(B=2, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    p = dk.pack_weights(dev(w), dev(b), s, dtype, head_w=dev(hw), head_b=dev(hb))
    xin = dev(x).to(dtype).contiguous()
    before = dk.LAUNCHES
    out = dk.decode_stage(xin, p, "swish", head or "tanh")
    ref = dk.decode_stage_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert dk.LAUNCHES == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16 and head is None:
        # both round one f32 value to bf16: at most one ulp apart
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 1e-4).all())
    else:
        assert diff.max().item() <= 1e-4  # f32 summation order over K = 9*Cin


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_kernel_activations(cuda, act):
    x, w, b, _, _ = _inputs(B=1, H=6, W=10, Cin=8, C=3, s=2, seed=3)
    x *= 3.0
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2, torch.float32)
    xin = torch.from_numpy(x).to(cuda)
    out = dk.decode_stage(xin, p, act)
    ref = dk.decode_stage_reference(xin, p, act)
    assert (out - ref).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# Which kernel a stage runs, and the wgmma + TMA kernel on the card
# ---------------------------------------------------------------------------

# (Cin, C, stride, head width) of the 720p flagship's decode stages
FLAGSHIP_STAGES = {
    "stage0": (26, 26, 5, 0),
    "block1": (26, 96, 2, 0),
    "block2": (96, 96, 2, 0),
    "block3": (96, 96, 2, 0),
    "block4+head": (96, 96, 2, 3),
}


@pytest.mark.parametrize("name", list(FLAGSHIP_STAGES))
def test_route_of_flagship_stages(name):
    cin, c, s, c_final = FLAGSHIP_STAGES[name]
    # Cin 26: TMA cannot stride it (52 bytes a pixel in bf16, 104 in f32)
    want = ("wgmma", "wgmma_tf32x3") if cin == 96 else ("wmma", "fma")
    assert dk.stage_route(torch.bfloat16, cin, c, s, c_final) == want[0]
    assert dk.stage_route(torch.float32, cin, c, s, c_final) == want[1]


@pytest.mark.parametrize(
    "cin,c,c_final,want",
    [
        (8, 8, 0, "wgmma"),
        (64, 40, 3, "wgmma"),
        (96, 96, 4, "wgmma"),
        (96, 96, 5, "wmma"),  # the head's outputs no longer fit four registers
        (96, 104, 0, "wmma"),  # one sub-pixel's channels no longer fit one tile
        (96, 44, 0, "wmma"),  # C not a multiple of 8
        (12, 96, 0, "wmma"),  # Cin not a multiple of 8
    ],
)
def test_route_bounds(cin, c, c_final, want):
    for stride in (1, 2, 3, 5):
        assert dk.stage_route(torch.bfloat16, cin, c, stride, c_final) == want


@pytest.mark.parametrize(
    "cin,c,c_final,want",
    [
        (4, 8, 0, "wgmma_tf32x3"),
        (12, 96, 0, "wgmma_tf32x3"),  # 48-byte pixels: a TMA stride, though not bf16's
        (64, 40, 3, "wgmma_tf32x3"),
        (96, 96, 4, "wgmma_tf32x3"),
        (96, 96, 5, "fma"),  # the head's outputs no longer fit four registers
        (96, 104, 0, "fma"),  # one sub-pixel's channels no longer fit one tile
        (96, 44, 0, "fma"),  # C not a multiple of 8
        (26, 96, 0, "fma"),  # Cin not a multiple of 4
        (6, 8, 0, "fma"),
    ],
)
def test_route_bounds_f32(cin, c, c_final, want):
    for stride in (1, 2, 3, 5):
        assert dk.stage_route(torch.float32, cin, c, stride, c_final) == want
    assert dk.ROUTES.index("wgmma_tf32x3") == 3  # the codes csrc/decode.cu takes stay
    assert dk.ROUTES[:3] == ("fma", "wmma", "wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weights_k_major_copy(dtype):
    """The wgmma route's operand is the transpose of the present one, made
    only on that route; the route is the packed stage's own property."""
    x, w, b, hw, hb = _inputs(Cin=16, C=8, s=2, head=True)
    p = dk.pack_weights(_t(w), _t(b), 2, dtype, head_w=_t(hw), head_b=_t(hb))
    assert p.c_final == 3
    if dtype == torch.bfloat16:
        assert p.route == "wgmma"
        assert p.wt.is_contiguous() and p.wt.dtype == dtype
        assert tuple(p.wt.shape) == (32, 9 * 16)
        assert torch.equal(p.wt, p.w.t())
    else:
        # f32: the K-major copy split into two TF32 numbers per weight
        assert p.route == "wgmma_tf32x3"
        assert p.wt.is_contiguous() and p.wt.dtype == dtype
        assert tuple(p.wt.shape) == (2, 32, 9 * 16)
        hi, lo = p.wt
        wk = p.w.t().contiguous()
        for part in (hi, lo):  # the low 13 mantissa bits of both are zero
            assert not bool((part.view(torch.int32) & 0x1FFF).any())
        # hi is w to 10 mantissa bits (within half a TF32 ulp, 2^-11 |w|), in K-major order
        assert bool(((hi - wk).abs() <= 2.0**-11 * wk.abs()).all())
        # w - hi is exact in f32: hi and the unrounded low part give w back bit for bit
        assert torch.equal(hi + (wk - hi), wk)
        # ... and the stored low part is that difference to TF32: 2^-22 |w| is lost
        assert bool(((hi.double() + lo.double()) - wk.double()).abs().le(2.0**-22 * wk.abs()).all())
        assert bool((lo.abs() <= 2.0**-11 * wk.abs()).all())
    q = dk.pack_weights(_t(w)[:, :, :13], _t(b), 2, dtype)  # Cin 13
    assert q.wt is None and q.route == ("wmma" if dtype == torch.bfloat16 else "fma")
    # the plain version never reads the copy
    out = dk.decode_stage(_t(x).to(dtype), p, "swish", "tanh")
    ref = dk.decode_stage_reference(_t(x).to(dtype), dataclasses.replace(p, wt=None), "swish", "tanh")
    assert torch.equal(out, ref)


def test_three_tf32_products_reach_f32_accuracy():
    """The f32 wgmma kernel's arithmetic, emulated in float64: operands split
    by split_tf32, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed over K = 864 (9
    taps x 96 channels) with the smoke's input ranges (x ~ N(0, 1), w uniform
    in +-K^-1/2).  Every product of two TF32 numbers is exact in the tensor
    core (11 x 11 significant bits), so what separates the kernel from the
    exact product is the dropped a_lo*b_lo and the low parts' rounding, ~2^-22
    per term, and the f32 accumulation, which the card's run measures.
    Tolerance: a tenth of the smoke's F32_ATOL (1e-4); one TF32 product alone
    misses it by far, which is why it is not a port of an f32 kernel."""
    rng = np.random.default_rng(5)
    k, m, n = 864, 64, 48
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32) * k**-0.5)
    a_hi, a_lo = (t.double() for t in dk.split_tf32(a))
    b_hi, b_lo = (t.double() for t in dk.split_tf32(b))
    exact = a.double() @ b.double()
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    assert (three - exact).abs().max().item() < 1e-4 / 10
    assert (three - exact).abs().max().item() < 1e-6  # what it does reach: ~1e-7
    assert (a_hi @ b_hi - exact).abs().max().item() > 1e-4  # one TF32 product


WGMMA_CASES = [
    # B, H, W, Cin, C, s, head: H and W not multiples of any tile
    (2, 5, 13, 96, 96, 2, None),
    (2, 5, 13, 96, 96, 2, "tanh"),
    (1, 37, 70, 96, 96, 2, "sigmoid"),  # several tiles a side, ragged edges
    (3, 9, 33, 32, 40, 2, None),  # C not 96: the 64-wide tile, masked channels
    (2, 11, 19, 8, 8, 3, "tanh"),  # Cin under one slice, 9 sub-pixels (odd)
    (1, 4, 6, 72, 64, 1, None),  # stride 1: half of the pair is empty
    (1, 7, 20, 40, 24, 5, None),  # stride 5, Cin over one slice with a tail
    (2, 16, 32, 96, 96, 2, None),  # exact tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Cin,C,s,head", WGMMA_CASES)
def test_cuda_wgmma_kernel_matches_plain(cuda, B, H, W, Cin, C, s, head):
    x, w, b, hw, hb = _inputs(B=B, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    p = dk.pack_weights(dev(w), dev(b), s, torch.bfloat16, head_w=dev(hw), head_b=dev(hb))
    assert p.route == "wgmma"
    xin = dev(x).bfloat16().contiguous()
    before = dict(dk.ROUTE_LAUNCHES)
    out = dk.decode_stage(xin, p, "swish", head or "tanh")
    ref = dk.decode_stage_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert dk.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert dk.ROUTE_LAUNCHES["wmma"] == before["wmma"]
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    diff = (out.float() - ref.float()).abs()
    if head is None:
        # both round one f32 value to bf16: at most one ulp apart
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 1e-4).all()), diff.max().item()
    else:
        assert diff.max().item() <= 1e-4  # f32 summation order over K = 9*Cin


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_wgmma_kernel_activations(cuda, act):
    x, w, b, _, _ = _inputs(B=1, H=6, W=10, Cin=16, C=8, s=2, seed=3)
    x *= 3.0
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2,
                        torch.bfloat16)
    xin = torch.from_numpy(x).to(cuda).bfloat16()
    out = dk.decode_stage(xin, p, act)
    ref = dk.decode_stage_reference(xin, p, act)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 2.0**-7 * ref.float().abs() + 1e-4).all())


@pytest.mark.gpu
@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize(
    "B,H,W,Cin,C,s,head",
    # + Cin 12 (48-byte pixels), and many work items a block (the ring goes round)
    WGMMA_CASES + [(2, 6, 10, 12, 16, 2, "tanh"), (4, 90, 160, 32, 96, 2, None)],
)
def test_cuda_tf32x3_kernel_matches_plain(cuda, B, H, W, Cin, C, s, head, with_z):
    """The f32 wgmma kernel (three TF32 products) against the TF32-off plain
    version over the ragged cases, as decode stage and as training forward:
    1e-4, the FMA kernel's bound, at sums of O(1)."""
    from repnerv_tpu_torch.kernels import train_tail as tt

    x, w, b, hw, hb = _inputs(B=B, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    # weights of a trained stage's size (std K^-1/2, sums of O(1)): the tensor
    # core adds into its f32 accumulator by truncation, so the kernel's
    # distance from the plain version grows with the sums' magnitude
    w *= (9 * Cin) ** -0.5 / 0.1
    dev = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    p = dk.pack_weights(dev(w), dev(b), s, torch.float32, head_w=dev(hw), head_b=dev(hb))
    assert p.route == "wgmma_tf32x3"
    xin = dev(x).contiguous()
    counts = tt.FWD_ROUTE_LAUNCHES if with_z else dk.ROUTE_LAUNCHES
    before = dict(counts)
    if with_z:
        out, z = tt.stage_forward(xin, p, "swish", head or "tanh")
        ref, ref_z = tt.stage_forward_reference(xin, p, "swish", head or "tanh")
    else:
        out = dk.decode_stage(xin, p, "swish", head or "tanh")
        ref = dk.decode_stage_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert counts["wgmma_tf32x3"] == before["wgmma_tf32x3"] + 1 and counts["fma"] == before["fma"]
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= 1e-4
    if with_z:
        assert z.dtype == torch.float32 and z.shape == ref_z.shape
        assert (z - ref_z).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_tf32x3_kernel_activations(cuda, act):
    x, w, b, _, _ = _inputs(B=1, H=6, W=10, Cin=16, C=8, s=2, seed=3)
    x *= 3.0
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2,
                        torch.float32)
    assert p.route == "wgmma_tf32x3"
    xin = torch.from_numpy(x).to(cuda)
    out = dk.decode_stage(xin, p, act)
    ref = dk.decode_stage_reference(xin, p, act)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_cuda_tf32x3_route_refuses_what_it_cannot_take(cuda):
    """The f32 wgmma route handed Cin 6 (24-byte pixels: no TMA stride)
    returns an error instead of launching the FMA kernel."""
    import ctypes

    from repnerv_tpu_torch.kernels.build import load_library

    x, w, b, _, _ = _inputs(Cin=6, C=8, s=2)
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2,
                        torch.float32)
    assert p.route == "fma"
    wt = torch.stack(dk.split_tf32(p.w.t().contiguous()))
    xin = torch.from_numpy(x).to(cuda)
    out = torch.zeros(2, 16, 32, 8, device=cuda)
    ptr = ctypes.c_void_p
    err = load_library().repnerv_fused_conv_ps_act(
        dk.ROUTES.index("wgmma_tf32x3"), ptr(xin.data_ptr()), ptr(p.w.data_ptr()),
        ptr(wt.data_ptr()), ptr(p.b.data_ptr()), ptr(None), ptr(None), ptr(out.data_ptr()),
        ptr(None), 2, 8, 16, 6, 8, 2, dk.ACT_CODES["swish"], 0, 0,
        ptr(torch.cuda.current_stream().cuda_stream),
    )
    torch.cuda.synchronize()
    assert err != 0
    assert not bool(out.any())  # nothing ran


@pytest.mark.gpu
def test_cuda_route_that_cannot_take_the_shape_is_refused(cuda):
    """No fallback inside the library: the wgmma route handed a shape it does
    not take (Cin 12) returns an error instead of launching another kernel."""
    import ctypes

    from repnerv_tpu_torch.kernels.build import load_library

    x, w, b, _, _ = _inputs(Cin=12, C=8, s=2)
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2,
                        torch.bfloat16)
    assert p.route == "wmma"
    wt = p.w.t().contiguous()
    xin = torch.from_numpy(x).to(cuda).bfloat16()
    out = torch.zeros(2, 16, 32, 8, device=cuda, dtype=torch.bfloat16)
    ptr = ctypes.c_void_p
    err = load_library().repnerv_fused_conv_ps_act(
        dk.ROUTES.index("wgmma"), ptr(xin.data_ptr()), ptr(p.w.data_ptr()), ptr(wt.data_ptr()),
        ptr(p.b.data_ptr()), ptr(None), ptr(None), ptr(out.data_ptr()), ptr(None),
        2, 8, 16, 12, 8, 2, dk.ACT_CODES["swish"], 0, 0,
        ptr(torch.cuda.current_stream().cuda_stream),
    )
    torch.cuda.synchronize()
    assert err != 0
    assert not bool(out.any())  # nothing ran
