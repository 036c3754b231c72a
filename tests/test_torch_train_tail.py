"""The port's fused training stage (repnerv_tpu_torch/kernels/train_tail.py:
K3 forward, K4 epilogue backward, the autograd Function around them)
against the JAX package's Pallas kernels, and the CUDA kernels against their
plain versions on the card.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX side
runs ``fused_stage_train`` and its custom VJP with the Pallas kernels in
interpret mode, as tests/test_train_tail.py does.  Tolerances in f32:
outputs atol 1e-5 (test_pallas.py's for the Pallas forward); gradients
atol 1e-5 relative to the largest |gradient| of the tensor, since both sides
sum the same f32 products (conv dX / dW over the batch and pixels, the bias
over pixels) in different orders.

JAX is imported inside the parity tests so that the CUDA-only tests run
where JAX is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_train_tail.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repnerv_tpu_torch.kernels import decode as dk
from repnerv_tpu_torch.kernels import train_tail as tt
from repnerv_tpu_torch.models.layers import activation, pixel_shuffle

ACTS = list(dk.ACT_CODES)
# every kink of the 9 activations, and values around them
KINKS = [0.0, -3.0, 3.0, 6.0, -6.0, 1e-3, -1e-3, 2.5, -2.5, 20.0, -20.0]


def _inputs(B=1, H=4, W=6, Cin=5, C=3, s=2, head=False, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    cout = C * s * s
    x = (rng.standard_normal((B, H, W, Cin)) * scale).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    hw = (rng.standard_normal((1, 1, C, 3)) * 0.3).astype(np.float32) if head else None
    hb = (rng.standard_normal(3) * 0.1).astype(np.float32) if head else None
    c_out = 3 if head else C
    ct = rng.standard_normal((B, H * s, W * s, c_out)).astype(np.float32)
    return x, w, b, hw, hb, ct


def _port(x, w, b, hw, hb, ct, s, act, squash, cdt="float32", device="cpu"):
    """Port output and (d_x, d_w, d_b[, d_hw, d_hb]) for loss = sum(out * ct)."""
    ts = [None if a is None else torch.tensor(a, device=device, requires_grad=True)
          for a in (x, w, b, hw, hb)]
    out = tt.fused_stage_train(*ts, s, act, squash, cdt)
    (out.float() * torch.tensor(ct, device=device)).sum().backward()
    return out.detach().float().cpu().numpy(), [t.grad.cpu().numpy() for t in ts if t is not None]


def _jax(x, w, b, hw, hb, ct, s, act, squash, cdt="float32"):
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.pallas_kernels import train_tail as jtt

    args = [jnp.asarray(a) for a in (x, w, b, hw, hb) if a is not None]
    head = hw is not None

    def f(*a):
        full = a if head else (*a, None, None)
        return jtt.fused_stage_train(*full, s, act, squash, cdt)

    out = f(*args)
    grads = jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32) * jnp.asarray(ct)),
        argnums=tuple(range(len(args))),
    )(*args)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.fixture
def jax_interpret(monkeypatch):
    from repnerv_tpu.pallas_kernels import train_tail as jtt

    monkeypatch.setattr(jtt, "INTERPRET", True)


def _close(a, b, rel, what=""):
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("act", ACTS)
def test_activation_grad_matches_jax_at_the_kinks(act):
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.models.layers import activation as jact

    z = np.concatenate([KINKS, np.random.default_rng(0).standard_normal(200) * 4]).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.grad(lambda t: jact(t, act)))(jnp.asarray(z)))
    out = tt.activation_grad(torch.from_numpy(z), act).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "s,squash", [(2, None), (5, None), (2, "tanh"), (2, "sigmoid"), (5, "tanh")]
)
def test_fused_stage_matches_jax(jax_interpret, s, squash):
    x, w, b, hw, hb, ct = _inputs(s=s, head=squash is not None, seed=s)
    ref_out, ref_g = _jax(x, w, b, hw, hb, ct, s, "swish", squash or "tanh")
    out, g = _port(x, w, b, hw, hb, ct, s, "swish", squash or "tanh")
    assert out.shape == ref_out.shape
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    assert len(g) == len(ref_g)
    for name, a, r in zip(("d_x", "d_w", "d_b", "d_hw", "d_hb"), g, ref_g):
        assert a.shape == r.shape, name
        _close(a, r, 1e-5, name)


@pytest.mark.parametrize("act", ACTS)
def test_fused_stage_activations_match_jax(jax_interpret, act):
    """z spans the kinks: x scaled up so pre-activations reach past +-6."""
    x, w, b, hw, hb, ct = _inputs(head=True, seed=7, scale=4.0)
    ref_out, ref_g = _jax(x, w, b, hw, hb, ct, 2, act, "tanh")
    out, g = _port(x, w, b, hw, hb, ct, 2, act, "tanh")
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    for name, a, r in zip(("d_x", "d_w", "d_b", "d_hw", "d_hb"), g, ref_g):
        _close(a, r, 1e-5, f"{act} {name}")


@pytest.mark.parametrize("squash", [None, "tanh"])
def test_fused_stage_bf16_matches_jax(jax_interpret, squash):
    """bf16 compute: both sides round x, w, z, d_h, the head weight and
    d_conv to bf16 at the same points, and run the conv dX/dW on bf16
    operands.  The bf16 conv backward's own output rounding (XLA and torch
    sum and round the bf16 products differently) leaves up to a few bf16
    ulps: gradients within 2^-6 of the largest |gradient|, outputs within
    one ulp (2^-7 relative) + 1e-3, the bf16 outputs of two f32 sums that
    differ in order."""
    x, w, b, hw, hb, ct = _inputs(head=squash is not None, seed=11)
    ref_out, ref_g = _jax(x, w, b, hw, hb, ct, 2, "swish", squash or "tanh", "bfloat16")
    out, g = _port(x, w, b, hw, hb, ct, 2, "swish", squash or "tanh", "bfloat16")
    np.testing.assert_allclose(out, ref_out, atol=1e-3, rtol=2.0**-7)
    for name, a, r in zip(("d_x", "d_w", "d_b", "d_hw", "d_hb"), g, ref_g):
        _close(a, r, 2.0**-6, name)


def _library_chain(x, w, b, hw, hb, s, act, squash):
    """conv -> pixel shuffle -> act [-> head -> squash] on library ops."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)
    y = activation(pixel_shuffle(y, s), act)
    if hw is None:
        return y
    h = torch.matmul(y, hw[0, 0]) + hb
    return torch.sigmoid(h) if squash == "sigmoid" else (torch.tanh(h) + 1.0) * 0.5


@pytest.mark.parametrize("s,squash", [(2, None), (3, "sigmoid"), (2, "tanh")])
def test_fused_stage_matches_library_autograd(s, squash):
    """Independent of JAX: the Function's gradients equal autograd through
    the library ops in f32."""
    x, w, b, hw, hb, ct = _inputs(B=2, s=s, head=squash is not None, seed=3)
    out, g = _port(x, w, b, hw, hb, ct, s, "gelu", squash or "tanh")
    ts = [None if a is None else torch.tensor(a, requires_grad=True) for a in (x, w, b, hw, hb)]
    ref = _library_chain(*ts, s, "gelu", squash)
    (ref * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=1e-5)
    for a, t in zip(g, [t for t in ts if t is not None]):
        _close(a, t.grad.numpy(), 1e-5)


@pytest.mark.parametrize("cout,s", [(12, 2), (384, 2), (650, 5), (27, 3), (8, 1)])
def test_inverse_permutation_form_equals_the_scatter_form(cout, s):
    """d_w2 = d_w[perm] comes back as one gather with the inverse
    permutation: equal to the scatter ``d_w[perm] = d_w2``, exactly; and the
    plain K4's d_b is in PixelShuffle channel order, the scatter of the
    shuffle-major column sums."""
    perm, inv = dk.shuffle_permutations(cout, s, "cpu")
    assert torch.equal(perm, dk.shuffle_weight_permutation(cout, s))
    assert torch.equal(inv[perm], torch.arange(cout))
    assert dk.shuffle_permutations(cout, s, torch.device("cpu"))[0] is perm  # made once
    d_w2 = torch.randn(cout, 5, 3, 3, generator=torch.Generator().manual_seed(cout))
    scattered = torch.empty_like(d_w2)
    scattered[perm] = d_w2
    assert torch.equal(d_w2.index_select(0, inv), scattered)
    c = cout // (s * s)
    z = torch.randn(1, 2 * s, 3 * s, c, generator=torch.Generator().manual_seed(1))
    ct = torch.randn(1, 2 * s, 3 * s, c, generator=torch.Generator().manual_seed(2))
    d_conv, d_b, _, _ = tt.epilogue_backward_reference(z, ct, None, None, s, "relu", "tanh")
    by_column = torch.empty(cout)
    by_column[perm] = d_conv.sum(dim=(0, 1, 2))
    assert torch.equal(d_b, by_column)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "wgmma_tf32x3"),
                                         (torch.bfloat16, "wmma"), (torch.float32, "fma")])
def test_packed_weight_view_is_the_backward_conv_weight(dtype, route):
    """The backward's conv weight is a view of the forward's packed weight,
    equal to the gather + permute + cast it replaces."""
    cin = 8 if route.startswith("wgmma") else 5
    x, w, b, _, _, _ = _inputs(Cin=cin, C=8)
    wt = torch.from_numpy(w)
    p = dk.pack_weights(wt, torch.from_numpy(b), 2, dtype)
    assert p.route == route
    perm = dk.shuffle_weight_permutation(w.shape[-1], 2)
    want = wt[..., perm].permute(3, 2, 0, 1).to(dtype)
    got = tt.packed_weight_oihw(p)
    assert got.shape == want.shape and torch.equal(got, want)
    assert got.untyped_storage().data_ptr() == p.w.untyped_storage().data_ptr()


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, w, b, _, _, _ = _inputs()
    p = dk.pack_weights(torch.from_numpy(w), torch.from_numpy(b), 2, torch.float32)
    with pytest.raises(ValueError):
        tt.stage_forward(torch.zeros(1, 4, 6, 5, device="meta"), p, "swish", "tanh")
    with pytest.raises(ValueError):
        tt.epilogue_backward(torch.zeros(1, 8, 12, 3, device="meta"),
                             torch.zeros(1, 8, 12, 3, device="meta"), None, None, 2, "swish",
                             "tanh")


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16_ulp_ok(out, ref):
    """Both round one f32 value (up to summation order) to bf16."""
    return bool(((out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs() + 1e-4).all())


SHAPES = [
    (4, 6, 5, 3, 2, None),
    (5, 13, 26, 96, 2, None),  # block 1's Cin, C
    (5, 13, 96, 96, 2, "tanh"),
    (4, 7, 16, 4, 2, "sigmoid"),
    (3, 5, 26, 26, 5, None),  # stride 5
    (3, 11, 12, 130, 2, "tanh"),  # C over one 96-wide chunk
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,Cin,C,s,head", SHAPES)
def test_cuda_forward_matches_plain(cuda, dtype, H, W, Cin, C, s, head):
    x, w, b, hw, hb, _ = _inputs(B=2, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    p = dk.pack_weights(dev(w), dev(b), s, dtype, head_w=dev(hw), head_b=dev(hb))
    xin = dev(x).to(dtype).contiguous()
    before = tt.FWD_LAUNCHES
    out, z = tt.stage_forward(xin, p, "swish", head or "tanh")
    ref_out, ref_z = tt.stage_forward_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert tt.FWD_LAUNCHES == before + 1
    assert out.dtype == ref_out.dtype and out.shape == ref_out.shape
    assert z.dtype == ref_z.dtype and z.shape == ref_z.shape
    if dtype == torch.bfloat16:
        assert _bf16_ulp_ok(z, ref_z)
        if head is None:
            assert _bf16_ulp_ok(out, ref_out)
        else:
            assert (out - ref_out).abs().max().item() <= 1e-4
    else:
        assert (z - ref_z).abs().max().item() <= 1e-4  # f32 summation order over 9*Cin
        assert (out - ref_out).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,Cin,C,s,head", SHAPES)
def test_cuda_backward_matches_plain(cuda, dtype, H, W, Cin, C, s, head):
    rng = np.random.default_rng(5)
    hs, ws = H * s, W * s
    z = torch.from_numpy(rng.standard_normal((2, hs, ws, C)).astype(np.float32) * 3).to(cuda)
    z = z.to(dtype).contiguous()
    c_out = 3 if head else C
    ct = torch.from_numpy(rng.standard_normal((2, hs, ws, c_out)).astype(np.float32)).to(cuda)
    ct = ct if head else ct.to(dtype)
    out = torch.rand(2, hs, ws, 3, device=cuda) if head else None
    hw = torch.from_numpy(rng.standard_normal((C, 3)).astype(np.float32) * 0.3).to(cuda) if head else None
    before = tt.BWD_LAUNCHES
    got = tt.epilogue_backward(z, ct, out, hw, s, "swish", head or "tanh")
    ref = tt.epilogue_backward_reference(z, ct, out, hw, s, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert tt.BWD_LAUNCHES == before + 1
    d_conv, ref_conv = got[0], ref[0]
    assert d_conv.dtype == ref_conv.dtype and d_conv.shape == ref_conv.shape
    if dtype == torch.bfloat16:
        assert _bf16_ulp_ok(d_conv, ref_conv)
    else:
        assert (d_conv - ref_conv).abs().max().item() <= 1e-5
    # partial sums over blocks vs one sum: f32 order, relative to the sum of |terms|
    for a, r in zip(got[1:], ref[1:]):
        if r is None:
            assert a is None
            continue
        assert (a - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0) * 10


def _bwd_case(cuda, dtype, B, H, W, C, s, head, act="swish", seed=5):
    rng = np.random.default_rng(seed)
    hs, ws = H * s, W * s
    z = torch.from_numpy(rng.standard_normal((B, hs, ws, C)).astype(np.float32) * 3).to(cuda)
    z = z.to(dtype).contiguous()
    c_out = 3 if head else C
    ct = torch.from_numpy(rng.standard_normal((B, hs, ws, c_out)).astype(np.float32)).to(cuda)
    ct = ct if head else ct.to(dtype)
    out = torch.from_numpy(rng.random((B, hs, ws, 3), dtype=np.float32)).to(cuda) if head else None
    hw = torch.from_numpy(rng.standard_normal((C, 3)).astype(np.float32) * 0.3).to(cuda) if head else None
    return z, ct, out, hw, s, act, head or "tanh"


# B, H, W, C, s, head: one tile and many, rows shorter than a tile, both
# squashes, channel counts on the 16-byte route and off it, a run wider than a block
BWD_SHAPES = [
    (1, 1, 1, 8, 2, None),
    (1, 3, 7, 96, 2, "tanh"),
    (2, 45, 80, 96, 2, None),
    (1, 90, 163, 96, 2, "sigmoid"),
    (1, 37, 41, 24, 3, "tanh"),
    (2, 9, 16, 26, 5, None),
    (1, 6, 50, 130, 2, "sigmoid"),
    (1, 5, 9, 1024, 2, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,s,head", BWD_SHAPES)
def test_cuda_backward_sums_end_in_the_kernel(cuda, dtype, B, H, W, C, s, head):
    """d_conv under the smoke's bounds; d_b (in PixelShuffle order), d_hw and
    d_hb within 1e-4 of the largest |ref| (f32 sums in another order); two
    launches on the same inputs give the same bits: the kernel adds its
    partial sums in a fixed order, whatever order the blocks ran in."""
    args = _bwd_case(cuda, dtype, B, H, W, C, s, head)
    before = tt.BWD_LAUNCHES
    got = tt.epilogue_backward(*args)
    again = tt.epilogue_backward(*args)
    ref = tt.epilogue_backward_reference(*args)
    torch.cuda.synchronize()
    assert tt.BWD_LAUNCHES == before + 2
    if dtype == torch.bfloat16:
        assert _bf16_ulp_ok(got[0], ref[0])
    else:
        assert (got[0] - ref[0]).abs().max().item() <= 1e-5
    for a, b2, r in zip(got, again, ref):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape and a.dtype == r.dtype
        assert torch.equal(a, b2)
    for a, r in zip(got[1:], ref[1:]):
        if r is not None:
            assert (a - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("squash", [None, "tanh", "sigmoid"])
@pytest.mark.parametrize("act", ACTS)
def test_cuda_backward_every_activation_and_squash(cuda, act, squash):
    args = _bwd_case(cuda, torch.float32, 1, 11, 23, 16, 2, squash, act=act, seed=8)
    got = tt.epilogue_backward(*args)
    ref = tt.epilogue_backward_reference(*args)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-5
    for a, r in zip(got[1:], ref[1:]):
        if r is not None:
            assert (a - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_backward_activations(cuda, act):
    rng = np.random.default_rng(6)
    z = np.concatenate([KINKS * 30, rng.standard_normal(2 * 12 * 16 * 4 - 30 * len(KINKS)) * 4])
    z = torch.from_numpy(z.astype(np.float32).reshape(2, 12, 16, 4)).to(cuda)
    ct = torch.from_numpy(rng.standard_normal((2, 12, 16, 4)).astype(np.float32)).to(cuda)
    got = tt.epilogue_backward(z, ct, None, None, 2, act, "tanh")
    ref = tt.epilogue_backward_reference(z, ct, None, None, 2, act, "tanh")
    assert (got[0] - ref[0]).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_stage_matches_cpu_plain(cuda, dtype):
    """The whole Function on the card (K3, K4, cuDNN dX/dW) against the same
    Function on the CPU (plain versions)."""
    x, w, b, hw, hb, ct = _inputs(B=1, H=6, W=10, Cin=16, C=8, s=2, head=True, seed=9)
    out, g = _port(x, w, b, hw, hb, ct, 2, "swish", "tanh", dtype, device=cuda)
    ref_out, ref_g = _port(x, w, b, hw, hb, ct, 2, "swish", "tanh", dtype)
    np.testing.assert_allclose(out, ref_out, atol=1e-4)
    rel = 1e-5 if dtype == "float32" else 2.0**-6
    for a, r in zip(g, ref_g):
        _close(a, r, rel)


# K3 on the wgmma + TMA kernel: B, H, W, Cin, C, s, head at ragged sizes (H, W
# not multiples of a tile; C = 96 and a C that is not)
WGMMA_SHAPES = [
    (1, 5, 13, 96, 96, 2, None),
    (2, 5, 13, 96, 96, 2, "tanh"),
    (1, 37, 70, 96, 96, 2, "sigmoid"),
    (2, 9, 33, 32, 40, 2, None),
    (1, 11, 19, 8, 8, 3, "tanh"),
    (1, 7, 20, 40, 24, 5, None),
]


@pytest.mark.parametrize("B,H,W,Cin,C,s,head", WGMMA_SHAPES)
def test_wgmma_shapes_take_the_wgmma_route(B, H, W, Cin, C, s, head):
    """CPU: the route is the packed stage's own, and the plain version (what
    a CPU tensor gets) never reads the K-major copy."""
    x, w, b, hw, hb, _ = _inputs(B=B, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    p = dk.pack_weights(t(w), t(b), s, torch.bfloat16, head_w=t(hw), head_b=t(hb))
    assert p.route == "wgmma" and torch.equal(p.wt, p.w.t())
    assert dk.pack_weights(t(w), t(b), s, torch.float32).route == "wgmma_tf32x3"
    before = dict(tt.FWD_ROUTE_LAUNCHES)
    out, z = tt.stage_forward(t(x).bfloat16(), p, "swish", head or "tanh")
    assert tt.FWD_ROUTE_LAUNCHES == before  # a CPU tensor launches nothing
    assert tuple(z.shape) == (B, H * s, W * s, C) and z.dtype == torch.bfloat16
    assert tuple(out.shape) == (B, H * s, W * s, 3 if head else C)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Cin,C,s,head", WGMMA_SHAPES)
def test_cuda_wgmma_forward_matches_plain(cuda, B, H, W, Cin, C, s, head):
    x, w, b, hw, hb, _ = _inputs(B=B, H=H, W=W, Cin=Cin, C=C, s=s, head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    p = dk.pack_weights(dev(w), dev(b), s, torch.bfloat16, head_w=dev(hw), head_b=dev(hb))
    assert p.route == "wgmma"
    xin = dev(x).bfloat16().contiguous()
    before = dict(tt.FWD_ROUTE_LAUNCHES)
    out, z = tt.stage_forward(xin, p, "swish", head or "tanh")
    ref_out, ref_z = tt.stage_forward_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert tt.FWD_ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert tt.FWD_ROUTE_LAUNCHES["wmma"] == before["wmma"]
    assert out.dtype == ref_out.dtype and out.shape == ref_out.shape
    assert z.dtype == ref_z.dtype and z.shape == ref_z.shape
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(z).all())
    assert _bf16_ulp_ok(z, ref_z)
    if head is None:
        assert _bf16_ulp_ok(out, ref_out)
    else:
        assert (out - ref_out).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_wgmma_forward_activations(cuda, act):
    """Swish is compiled into the wgmma kernel, the others go through its
    run-time switch: each against the plain version, z included."""
    x, w, b, _, _, _ = _inputs(B=1, H=6, W=10, Cin=16, C=8, s=2, seed=3, scale=3.0)
    p = dk.pack_weights(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), 2,
                        torch.bfloat16)
    xin = torch.from_numpy(x).to(cuda).bfloat16()
    out, z = tt.stage_forward(xin, p, act, "tanh")
    ref_out, ref_z = tt.stage_forward_reference(xin, p, act, "tanh")
    assert _bf16_ulp_ok(z, ref_z) and _bf16_ulp_ok(out, ref_out)
