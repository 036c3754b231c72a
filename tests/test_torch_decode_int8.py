"""The port's int8 decode (repnerv_tpu_torch/kernels/decode_int8.py, the int8
gate of models/generator.py, calibrate_int8, decode_main --decode_int8)
against the JAX package, and the CUDA kernel against its plain version on
the card.

On the CPU the port's wrapper runs the plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (tests/test_int8_decode.py's
monkeypatch; without it a JAX decode_int8 on the CPU silently decodes in
f32).  Inputs come from a numpy seed.  Tolerances:

* the quantizers: bit-equal (the same f32 division / multiplication and
  half-to-even rounding on both sides);
* int8 stage outputs: within 1 count, under 1% of them differing
  (tests/test_int8_decode.py's own bound: the integer sums are exact, the
  f32 epilogue's activation may land on the other side of a .5 boundary);
* f32 head outputs: 1e-5;
* calibration: w_q equal, scales rtol 1e-5 (the abs-max comes from two f32
  forwards that sum in different orders).

JAX is imported inside the parity tests so that the CUDA-only tests run
where JAX is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_decode_int8.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.kernels import decode_int8 as k8

ACTS = ["swish", "relu", "gelu", "leaky", "hardswish"]


def _q_inputs(B=2, H=6, W=10, Cin=8, C=4, s=2, head=False, seed=0):
    """Realistic int8 stage inputs: f32 activations and weights quantized by
    the scheme itself, so the dequantized sums are O(1)."""
    rng = np.random.default_rng(seed)
    cout = C * s * s
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, cout)) * (9 * Cin) ** -0.5).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 127)
    w_q, sw = k8.quantize_weight_int8(torch.from_numpy(w))
    x_q = k8.quantize_act_int8(torch.from_numpy(x), torch.tensor(sx))
    hw = (rng.standard_normal((1, 1, C, 3)) * 0.3).astype(np.float32) if head else None
    hb = np.asarray([0.1, -0.2, 0.3], np.float32) if head else None
    return x_q.numpy(), w_q.numpy(), (sx * sw).numpy(), b, hw, hb


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _jax_interpret(monkeypatch):
    """The JAX int8 path on the CPU: the kernel in interpret mode, the TPU
    gate off (tests/test_int8_decode.py:101-107)."""
    import repnerv_tpu.models.generator as jgen
    import repnerv_tpu.pallas_kernels.decode_int8 as d8

    orig = d8.fused_conv_ps_act_int8
    monkeypatch.setattr(d8, "fused_conv_ps_act_int8",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)


def _assert_int8_close(got: np.ndarray, ref: np.ndarray):
    assert got.dtype == ref.dtype == np.int8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", [(3, 3, 6, 12), (3, 3, 26, 104), (4, 7)])
def test_quantizers_bit_equal_to_jax(shape):
    import jax.numpy as jnp

    from repnerv_tpu.pallas_kernels import decode_int8 as d8

    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, jsw = d8.quantize_weight_int8(jnp.asarray(w))
    q, sw = k8.quantize_weight_int8(torch.from_numpy(w))
    assert q.dtype == torch.int8 and sw.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    # activations: f32 / bf16 inputs, a scale that puts values on .5 boundaries
    x = (rng.integers(-600, 600, size=shape) * 0.25).astype(np.float32)
    sx = np.float32(2.0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(d8.quantize_act_int8(jnp.asarray(x).astype(jdt), jnp.float32(sx)))
        got = k8.quantize_act_int8(torch.from_numpy(x).to(dt), torch.tensor(sx))
        np.testing.assert_array_equal(got.numpy(), ref)


def _jax_stage(x_q, w_q, scale, b, s, act, hw, hb, squash, out_scale):
    import jax.numpy as jnp

    from repnerv_tpu.pallas_kernels.decode_int8 import fused_conv_ps_act_int8

    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = fused_conv_ps_act_int8(
        j(x_q), j(w_q), j(scale), j(b), s, act,
        out_scale=None if hw is not None else jnp.float32(out_scale),
        head_w=j(hw), head_b=j(hb), out_squash=squash, interpret=True,
    )
    return np.asarray(out)


@pytest.mark.parametrize(
    "stride,head,act",
    [
        (2, None, "swish"),
        (5, None, "swish"),
        (2, None, "relu"),
        (2, None, "gelu"),
        (2, "tanh", "swish"),
        (5, "sigmoid", "swish"),
        (2, "sigmoid", "hardswish"),
    ],
)
def test_plain_stage_matches_jax_kernel(stride, head, act):
    C = 4 if head else 3
    x_q, w_q, scale, b, hw, hb = _q_inputs(C=C, s=stride, head=head is not None, seed=stride)
    out_scale = np.float32(0.013)
    ref = _jax_stage(x_q, w_q, scale, b, stride, act, hw, hb, head, out_scale)
    before = k8.LAUNCHES
    out = k8.fused_conv_ps_act_int8(
        _t(x_q), _t(w_q), _t(scale), _t(b), stride, act,
        out_scale=None if head else torch.tensor(out_scale),
        head_w=_t(hw), head_b=_t(hb), out_squash=head,
    )
    assert k8.LAUNCHES == before  # a CPU tensor takes the plain version, no launch
    if head is None:
        _assert_int8_close(out.numpy(), ref)
    else:
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_plain_stage_integer_sum_is_exact_at_any_width():
    """Cin 96 sums in f32, Cin 160 in float64: both equal the int64 sum."""
    for cin in (96, 160):
        rng = np.random.default_rng(cin)
        x = rng.integers(-127, 128, (1, 3, 4, cin)).astype(np.int8)
        w = rng.integers(-127, 128, (9 * cin, 8)).astype(np.int8)
        xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        ref = sum(
            xp[:, dy : dy + 3, dx : dx + 4, :] @ w.astype(np.int64).reshape(9, cin, 8)[3 * dy + dx]
            for dy in range(3) for dx in range(3)
        )
        got = k8.int_conv3x3(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


def test_pack_rejects_bad_modes():
    x_q, w_q, scale, b, _, _ = _q_inputs()
    with pytest.raises(ValueError, match="exactly one"):
        k8.pack_int8_stage(_t(w_q), _t(scale), _t(b), 2)
    with pytest.raises(ValueError):
        k8.pack_int8_stage(_t(w_q).float(), _t(scale), _t(b), 2, out_scale=torch.tensor(0.1))
    p = k8.pack_int8_stage(_t(w_q), _t(scale), _t(b), 2, out_scale=torch.tensor(0.1))
    with pytest.raises(ValueError):
        k8.decode_stage_int8(torch.zeros(1, 4, 4, 8, dtype=torch.int8, device="meta"), p)


# (Cin, C, head width) of the 720p flagship's decode stages
FLAGSHIP_STAGES = {
    "stage0": (26, 26, 0),
    "block1": (26, 96, 0),
    "block2": (96, 96, 0),
    "block3": (96, 96, 0),
    "block4+head": (96, 96, 3),
}


@pytest.mark.parametrize("name", list(FLAGSHIP_STAGES))
def test_int8_route_of_flagship_stages(name):
    cin, c, c_final = FLAGSHIP_STAGES[name]
    # Cin 26: 26-byte pixels, no TMA stride
    assert k8.int8_route(cin, c, c_final) == ("wgmma" if cin == 96 else "wmma")


@pytest.mark.parametrize(
    "cin,c,c_final,want",
    [
        (16, 8, 0, "wgmma"),
        (64, 40, 3, "wgmma"),
        (128, 96, 4, "wgmma"),
        (96, 96, 5, "wmma"),  # the head's outputs no longer fit four registers
        (96, 104, 0, "wmma"),  # one sub-pixel's channels no longer fit one tile
        (96, 44, 0, "wmma"),  # C not a multiple of 8
        (24, 96, 0, "wmma"),  # Cin not a multiple of 16
        (144, 96, 0, "wmma"),  # a pixel no longer fits one 128-byte row
    ],
)
def test_int8_route_bounds(cin, c, c_final, want):
    assert k8.int8_route(cin, c, c_final) == want
    assert k8.ROUTES == ("wmma", "wgmma")  # the index is the code the C entry takes


@pytest.mark.parametrize("head", [False, True])
def test_pack_int8_stage_k_major_copy(head):
    """The wgmma route's operand is the transpose of the WMMA kernel's, made
    only on that route; the plain version never reads it."""
    x_q, w_q, scale, b, hw, hb = _q_inputs(Cin=16, C=8, s=2, head=head)
    kw = dict(head_w=_t(hw), head_b=_t(hb)) if head else dict(out_scale=torch.tensor(0.02))
    p = k8.pack_int8_stage(_t(w_q), _t(scale), _t(b), 2, **kw)
    assert p.route == "wgmma" and p.c_final == (3 if head else 0)
    assert p.wt.is_contiguous() and p.wt.dtype == torch.int8
    assert tuple(p.wt.shape) == (32, 9 * 16) and torch.equal(p.wt, p.w.t())
    # row (i*s + j)*C + c of wt is output channel c*s*s + i*s + j of the HWIO weight
    row = (1 * 2 + 0) * 8 + 5
    assert torch.equal(p.wt[row].reshape(3, 3, 16), _t(w_q)[..., 5 * 4 + 2])
    q = k8.pack_int8_stage(_t(w_q)[:, :, :12], _t(scale), _t(b), 2, **kw)  # Cin 12
    assert q.route == "wmma" and q.wt is None
    before = dict(k8.ROUTE_LAUNCHES)
    out = k8.decode_stage_int8(_t(x_q), p, "swish", "tanh")
    ref = k8.decode_stage_int8_reference(_t(x_q), dataclasses.replace(p, wt=None), "swish", "tanh")
    assert k8.ROUTE_LAUNCHES == before  # a CPU tensor launches nothing
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="K-major"):
        k8.check_int8_args(_t(x_q), dataclasses.replace(p, wt=None), "swish", "tanh")


# ---------------------------------------------------------------------------
# The generator: calibration, the int8 gate, decode_main
# ---------------------------------------------------------------------------


def _tiny_int8_cfg(**over):
    from test_model_train import tiny_model

    cfg = tiny_model(branch_type="ERB", fc_hw_dim="6_8_8", strides=(2, 2, 2), lower_width=8,
                     **over)
    return dataclasses.replace(cfg, use_pallas_decode=False)


def _jax_deploy(seed):
    import jax

    from repnerv_tpu.models.generator import generator_to_deploy, init_generator

    params = init_generator(jax.random.PRNGKey(seed), _tiny_int8_cfg())
    return generator_to_deploy(params, _tiny_int8_cfg())


def _port(params, cfg):
    import jax

    from repnerv_tpu_torch.models.generator import Generator
    from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params

    from test_torch_config_codecs import port_model_cfg

    pcfg = port_model_cfg(cfg)  # the port takes its own config class
    return load_state(Generator(pcfg), state_from_jax_params(jax.tree.map(np.asarray, params), pcfg))


T_CALIB = np.asarray([0.1, 0.5, 0.9], np.float32)  # odd: the last frame repeats


@pytest.fixture(scope="module")
def calibrated():
    """A tiny ERB deploy generator calibrated on both sides."""
    import jax.numpy as jnp

    from repnerv_tpu.models.embedding import positional_encoding as jpe
    from repnerv_tpu.models.generator import calibrate_int8 as jcal

    from repnerv_tpu_torch.models.embedding import positional_encoding
    from repnerv_tpu_torch.models.generator import calibrate_int8

    dep, dcfg = _jax_deploy(3)
    jdep8 = jcal(dep, dcfg, jpe(jnp.asarray(T_CALIB), dcfg.embed))
    gen = _port(dep, dcfg)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    gen8 = calibrate_int8(gen, positional_encoding(torch.from_numpy(T_CALIB), dcfg.embed))
    return dep, dcfg, jdep8, gen, gen8, before


def test_calibrate_int8_tables_match_jax(calibrated):
    _, _, jdep8, _, gen8, _ = calibrated
    assert set(gen8.int8) == set(jdep8["int8"]) == {"1", "2"}
    for k, ref in jdep8["int8"].items():
        q = gen8.int8[k]
        # packed once with the table: the last block fuses the head
        assert (q.packed.head_w is None) == (q.packed.inv_out is not None) == (k != "2")
        np.testing.assert_array_equal(q.w_q.numpy(), np.asarray(ref["w_q"]))
        for name in ("scale", "in_scale", "b", "out_scale"):
            got, want = getattr(q, name), ref.get(name)
            assert (got is None) == (want is None), (k, name)
            if want is not None:
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, err_msg=name)


def test_calibrate_int8_is_pure_and_declines(calibrated):
    from repnerv_tpu_torch.models.generator import Generator, calibrate_int8

    _, dcfg, _, gen, gen8, before = calibrated
    assert gen.int8 == {} and gen8 is not gen and not gen.training
    assert list(gen.state_dict()) == list(before) == list(gen8.state_dict())
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]) and torch.equal(gen8.state_dict()[k], v), k
    emb = torch.zeros(2, gen.cfg.embed_length)
    for cfg in (dataclasses.replace(dcfg, int8_from_block=-4),
                dataclasses.replace(dcfg, single_res=False)):
        other = Generator(cfg)
        assert calibrate_int8(other, emb) is other and other.int8 == {}
    with pytest.raises(ValueError, match="deploy"):
        calibrate_int8(Generator(_tiny_int8_cfg()), emb)


def test_int8_generator_decode_matches_jax(calibrated, monkeypatch):
    """The same table on both sides (int8_tables_from_jax): the int8 decode
    of the port equals JAX apply_generator(decode_int8=True).  Frames within
    1e-2: block 1's int8 output may differ by a count where the two f32
    epilogues land on the other side of a .5 boundary (< 1% of values, see
    above), and block 2 carries that into a few output pixels; the squash's
    slope <= 1/2 bounds it."""
    import jax.numpy as jnp

    from repnerv_tpu.models.embedding import positional_encoding as jpe
    from repnerv_tpu.models.generator import apply_generator

    from repnerv_tpu_torch.models.embedding import positional_encoding
    from repnerv_tpu_torch.models.generator import Generator
    from repnerv_tpu_torch.train.checkpoint import int8_tables_from_jax, load_state

    _jax_interpret(monkeypatch)
    dep, dcfg, jdep8, gen, _, _ = calibrated
    icfg = dataclasses.replace(dcfg, decode_int8=True)
    t = np.asarray([0.2, 0.7], np.float32)
    ref = np.asarray(apply_generator(jdep8, jpe(jnp.asarray(t), icfg.embed), icfg, train=False)[0])
    port = load_state(Generator(icfg), gen.state_dict())
    port.int8 = int8_tables_from_jax({k: {n: np.asarray(v) for n, v in e.items()}
                                      for k, e in jdep8["int8"].items()}, port)
    before = k8.LAUNCHES
    with torch.no_grad():
        out = port(positional_encoding(torch.from_numpy(t), icfg.embed))[0]
    assert k8.LAUNCHES == before
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-2)
    assert np.abs(out.numpy() - ref).mean() < 1e-4
    # the int8 path is taken: it differs from the f32 decode by quantization noise
    with torch.no_grad():
        f32 = gen(positional_encoding(torch.from_numpy(t), icfg.embed))[0]
    err = (out - f32).abs()
    assert 0 < err.max().item() < 0.08


def test_decode_main_int8_matches_jax(tmp_path, monkeypatch):
    """decode_main --decode_int8 --out on the same .rnvb: the port's PNGs
    within one 8-bit level of the JAX decode_main's, except where an int8
    count differs (bounded above): those pixels within 3 levels."""
    from PIL import Image

    from repnerv_tpu.cli import decode_main as jdecode_main
    from repnerv_tpu.compress.bitstream import write_bitstream

    from repnerv_tpu_torch.cli import decode_main

    _jax_interpret(monkeypatch)
    monkeypatch.chdir(tmp_path)  # the JAX CLI keeps its compile cache in the cwd
    dep, dcfg = _jax_deploy(4)
    path = str(tmp_path / "m.rnvb")
    write_bitstream(path, dep, dcfg, 8)
    n = 5
    jdecode_main.main([path, "--frames", str(n), "--batch", "2", "--decode_int8", "--out", "jax"])
    before = k8.LAUNCHES
    res = decode_main.main([path, "--frames", str(n), "--batch", "2", "--decode_int8",
                            "--out", "port", "--device", "cpu"])
    assert k8.LAUNCHES == before and res["frames"] == n

    def frames(d):
        return np.stack([np.asarray(Image.open(os.path.join(d, f"pred_{i}.png")), np.int32)
                         for i in range(n)])

    got, ref = frames("port"), frames("jax")
    assert got.shape == ref.shape == (n, 48, 64, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= 3 and (diff > 1).mean() < 1e-3


# K1 writing the first int8 block's input (decode_stage's out_scale)
# ---------------------------------------------------------------------------


def _k1_stage(Cin=16, C=8, s=2, dtype=torch.bfloat16, head=False, device="cpu", gain=1.0,
              seed=0):
    """bf16 K1 inputs and a packed stage (HWIO weights of std gain / sqrt(9 Cin))."""
    from repnerv_tpu_torch.kernels import decode as dk

    rng = np.random.default_rng(seed)
    cout = C * s * s
    w = rng.standard_normal((3, 3, Cin, cout)) * gain * (9 * Cin) ** -0.5
    b = rng.standard_normal(cout) * 0.1
    hw = rng.standard_normal((1, 1, C, 3)) * 0.3 if head else None
    dev = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return dk.pack_weights(dev(w), dev(b), s, dtype, head_w=dev(hw),
                           head_b=torch.zeros(3, device=device) if head else None)


def test_k1_int8_out_on_the_cpu_is_the_plain_pass():
    """On a CPU tensor ``decode_stage(out_scale=sx)`` is the plain stage and
    then ``quantize_act_int8``, to the bit, and counts no launch."""
    from repnerv_tpu_torch.kernels import decode as dk

    p = _k1_stage()
    assert p.route == "wgmma"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, 7, 16))
                         .astype(np.float32)).bfloat16()
    sx = torch.tensor(0.0123)
    before = (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES)
    got = dk.decode_stage(x, p, "swish", out_scale=sx)
    want = k8.quantize_act_int8(dk.decode_stage_reference(x, p, "swish"), sx)
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 10, 14, 8)
    assert torch.equal(got, want) and bool((got != 0).any())
    assert (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES) == before


@pytest.mark.parametrize("case", ["wmma", "f32", "head"])
def test_k1_int8_out_refuses_other_routes_and_a_head(case):
    """Only the bf16 wgmma route without a head quantises its output:
    anything else raises, on the CPU as on the card."""
    from repnerv_tpu_torch.kernels import decode as dk

    p = {"wmma": lambda: _k1_stage(Cin=12), "f32": lambda: _k1_stage(dtype=torch.float32),
         "head": lambda: _k1_stage(head=True)}[case]()
    assert (p.route, p.c_final) != ("wgmma", 0)
    x = torch.zeros(1, 4, 4, p.cin, dtype=p.w.dtype)
    with pytest.raises(ValueError, match="wgmma route without a head"):
        dk.decode_stage(x, p, out_scale=torch.tensor(0.01))


def _entry(in_scale=0.02):
    """An int8 table of which only ``in_scale`` is read."""
    from repnerv_tpu_torch.models.generator import Int8Entry

    return Int8Entry(None, None, torch.tensor(in_scale), None, None, None)


@pytest.mark.parametrize("case,fused", [
    ("wgmma cuda next int8", True),
    ("wgmma cpu", False),
    ("wmma", False),
    ("f32", False),
    ("head", False),
    ("next not int8", False),
])
def test_k1_writes_int8_only_where_the_caller_can(case, fused):
    """``int8_out_scale``: the next block's ``in_scale`` on a CUDA tensor whose
    stage takes the wgmma route without a head and whose next block is
    served in int8; None otherwise (no card needed: the device is only read)."""
    from repnerv_tpu_torch.models.generator import int8_out_scale

    p = {"wmma": lambda: _k1_stage(Cin=12), "f32": lambda: _k1_stage(dtype=torch.float32),
         "head": lambda: _k1_stage(head=True)}.get(case, _k1_stage)()
    dev = torch.device("cpu" if case == "wgmma cpu" else "cuda")
    nxt = None if case == "next not int8" else _entry()
    got = int8_out_scale(p, dev, nxt)
    assert (got is nxt.in_scale) if fused else got is None


def _int8_after_k1_cfg():
    """A bf16 deploy model whose block 1 (32x32 input) takes K1 and whose
    block 2, the last, is served in int8."""
    from repnerv_tpu_torch.config import ModelConfig

    return ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="16_16_8",
                       strides=(2, 2, 2), lower_width=8, branch_type="ERB",
                       compute_dtype="bfloat16", decode_int8=True, int8_from_block=-1)


def decode_with_the_plain_pass(gen, emb):
    """The int8 decode of ``gen`` (its last block served in int8) written out
    with the plain pass between K1 and K2: the stem and the small blocks as
    the generator runs them, ``decode_stage`` for a K1 block,
    ``quantize_act_int8`` before the first int8 block.  Returns the frames."""
    from repnerv_tpu_torch.kernels import decode as dk
    from repnerv_tpu_torch.models.generator import DTYPES, KERNEL_MIN_PIXELS, squash_name

    cfg = gen.cfg
    dtype = DTYPES[cfg.compute_dtype]
    h, w, c = cfg.fc_hwd
    x = gen.stem(emb, dtype=dtype, mixed=False)
    x = x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()
    for li, blk in enumerate(gen.layers):
        q = gen.int8.get(str(li))
        if q is not None:
            if x.dtype != torch.int8:
                x = k8.quantize_act_int8(x, q.in_scale)
            x = k8.decode_stage_int8(x.contiguous(), q.packed, cfg.act, squash_name(cfg))
        elif x.shape[1] * x.shape[2] >= KERNEL_MIN_PIXELS:
            x = dk.decode_stage(x.to(dtype).contiguous(), gen._packed_stage(li, None, dtype),
                                cfg.act, squash_name(cfg))
        else:
            x = blk(x, online_fuse=cfg.online_fuse)
    return x


def test_cpu_int8_decode_quantises_in_its_own_span(tmp_path):
    """On the CPU the block before the first int8 block runs the plain K1 and
    the plain pass quantises its output inside ``int8.quantize_act``; the
    frames equal the decode written out with that pass, to the bit."""
    from repnerv_tpu_torch.kernels import decode as dk
    from repnerv_tpu_torch.models.embedding import positional_encoding
    from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, generator_to_deploy
    from repnerv_tpu_torch.utils.profiling import trace

    cfg = _int8_after_k1_cfg()
    gen = calibrate_int8(generator_to_deploy(Generator(cfg, seed=2)),
                         positional_encoding(torch.tensor([0.1, 0.6]), cfg.embed))
    assert set(gen.int8) == {"2"}
    emb = positional_encoding(torch.tensor([0.3, 0.8]), cfg.embed)
    before = (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES, k8.LAUNCHES)
    with torch.no_grad(), trace(str(tmp_path), "cpu") as rec:
        out = gen(emb)[0]
    assert (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES, k8.LAUNCHES) == before
    assert [p for p in rec.spans if p.split("/")[-1] == "int8.quantize_act"]
    assert tuple(out.shape) == (2, 128, 128, 3)
    with torch.no_grad():
        assert torch.equal(out, decode_with_the_plain_pass(gen, emb))


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
@pytest.mark.parametrize(
    "H,W,Cin,C,s,head",
    [
        (8, 16, 8, 3, 1, None),
        (8, 16, 8, 4, 2, "tanh"),
        (8, 16, 8, 4, 2, "sigmoid"),
        (7, 20, 26, 26, 5, None),  # Cin and C not multiples of 16: byte copies
        (7, 20, 26, 26, 5, "tanh"),
        (5, 13, 96, 96, 2, None),  # the flagship's widths: 16-byte copies
        (5, 13, 96, 96, 2, "tanh"),
        (6, 9, 16, 100, 3, "tanh"),  # C over one 96-wide chunk: the head sums two
        (3, 11, 12, 130, 2, None),  # C over one 96-wide chunk
    ],
)
def test_cuda_kernel_matches_plain(cuda, H, W, Cin, C, s, head):
    x_q, w_q, scale, b, hw, hb = _q_inputs(B=2, H=H, W=W, Cin=Cin, C=C, s=s,
                                          head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    p = k8.pack_int8_stage(dev(w_q), dev(scale), dev(b), s,
                           out_scale=None if head else torch.tensor(0.013, device=cuda),
                           head_w=dev(hw), head_b=dev(hb))
    xin = dev(x_q).contiguous()
    before = k8.LAUNCHES
    out = k8.decode_stage_int8(xin, p, "swish", head or "tanh")
    ref = k8.decode_stage_int8_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before + 1
    _assert_stage_close(out, ref, head)


def _assert_stage_close(out, ref, head):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if head is None:
        # the same integer sums and f32 epilogue; expf's ulps may move a
        # value across a .5 boundary
        _assert_int8_close(out.cpu().numpy(), ref.cpu().numpy())
    else:
        assert bool(torch.isfinite(out).all())
        assert (out - ref).abs().max().item() <= 1e-5  # head sum order over C


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_cuda_kernel_activations(cuda, act):
    x_q, w_q, scale, b, _, _ = _q_inputs(B=1, H=6, W=10, Cin=16, C=4, s=2, seed=3)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    p = k8.pack_int8_stage(dev(w_q), dev(scale), dev(b), 2, out_scale=torch.tensor(0.02, device=cuda))
    out = k8.decode_stage_int8(dev(x_q), p, act)
    ref = k8.decode_stage_int8_reference(dev(x_q), p, act)
    _assert_int8_close(out.cpu().numpy(), ref.cpu().numpy())


# the wgmma kernel: B, H, W, Cin, C, s, head; H and W not multiples of any tile
WGMMA_CASES = [
    (2, 5, 13, 96, 96, 2, None),
    (2, 5, 13, 96, 96, 2, "tanh"),
    (1, 37, 70, 96, 96, 2, "sigmoid"),  # several tiles a side, ragged edges
    (3, 9, 33, 32, 40, 2, None),  # C not 96: the 64-wide tile, masked channels
    (2, 11, 19, 16, 8, 3, "tanh"),  # Cin under one product, 9 sub-pixels (odd)
    (1, 4, 6, 80, 64, 1, None),  # stride 1: half of the pair is empty; Cin 80: a half-empty product
    (1, 7, 20, 48, 24, 5, None),  # stride 5
    (1, 6, 9, 128, 96, 2, None),  # a full 128-byte row: four products a slot
    (2, 16, 32, 96, 96, 2, None),  # exact tiles
    # many work items a block: the ring's barriers go round several times
    (2, 90, 160, 96, 96, 2, None),
    (1, 180, 320, 32, 96, 2, "tanh"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Cin,C,s,head", WGMMA_CASES)
def test_cuda_wgmma_kernel_matches_plain(cuda, B, H, W, Cin, C, s, head):
    x_q, w_q, scale, b, hw, hb = _q_inputs(B=B, H=H, W=W, Cin=Cin, C=C, s=s,
                                          head=head is not None)
    dev = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    p = k8.pack_int8_stage(dev(w_q), dev(scale), dev(b), s,
                           out_scale=None if head else torch.tensor(0.013, device=cuda),
                           head_w=dev(hw), head_b=dev(hb))
    assert p.route == "wgmma"
    xin = dev(x_q).contiguous()
    before = dict(k8.ROUTE_LAUNCHES)
    out = k8.decode_stage_int8(xin, p, "swish", head or "tanh")
    ref = k8.decode_stage_int8_reference(xin, p, "swish", head or "tanh")
    torch.cuda.synchronize()
    assert k8.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert k8.ROUTE_LAUNCHES["wmma"] == before["wmma"]
    _assert_stage_close(out, ref, head)


@pytest.mark.gpu
def test_cuda_wgmma_kernel_integer_sums_are_exact(cuda):
    """scale 1, bias 0, relu and inv_out 1 / 2^k leave the integer sums
    readable in the output: full-range int8 inputs against the int64 conv."""
    rng = np.random.default_rng(7)
    cin, c, s = 96, 8, 2
    x = rng.integers(-127, 128, (1, 5, 9, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, c * s * s)).astype(np.int8)
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    ones = torch.ones(c * s * s, device=cuda)
    p = k8.pack_int8_stage(dev(w), ones, None, s, out_scale=torch.tensor(2.0**17, device=cuda))
    assert p.route == "wgmma"
    out = k8.decode_stage_int8(dev(x), p, "relu")
    ref = k8.decode_stage_int8_reference(dev(x), p, "relu")
    assert bool((out != 0).any()) and torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("act", list(k8.ACT_CODES))
def test_cuda_wgmma_kernel_activations(cuda, act):
    x_q, w_q, scale, b, _, _ = _q_inputs(B=1, H=6, W=10, Cin=16, C=8, s=2, seed=3)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    p = k8.pack_int8_stage(dev(w_q), dev(scale), dev(b), 2, out_scale=torch.tensor(0.02, device=cuda))
    assert p.route == "wgmma"
    out = k8.decode_stage_int8(dev(x_q), p, act)
    ref = k8.decode_stage_int8_reference(dev(x_q), p, act)
    _assert_int8_close(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
def test_cuda_wgmma_route_refuses_what_it_cannot_take(cuda):
    """No fallback inside the library: the wgmma route handed Cin 24 (no TMA
    stride) returns an error instead of launching the WMMA kernel."""
    import ctypes

    from repnerv_tpu_torch.kernels.build import load_library

    x_q, w_q, scale, b, _, _ = _q_inputs(Cin=24, C=8, s=2)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)  # noqa: E731
    p = k8.pack_int8_stage(dev(w_q), dev(scale), dev(b), 2, out_scale=torch.tensor(0.02, device=cuda))
    assert p.route == "wmma" and p.wt is None
    wt = p.w.t().contiguous()
    xin = dev(x_q)
    out = torch.zeros(2, 12, 20, 8, device=cuda, dtype=torch.int8)
    ptr = ctypes.c_void_p
    err = load_library().repnerv_fused_conv_ps_act_int8(
        k8.ROUTES.index("wgmma"), ptr(xin.data_ptr()), ptr(p.w.data_ptr()), ptr(wt.data_ptr()),
        ptr(p.scale.data_ptr()), ptr(p.b.data_ptr()), ptr(p.inv_out.data_ptr()), ptr(None),
        ptr(None), ptr(out.data_ptr()), 2, 6, 10, 24, 8, 2, k8.ACT_CODES["swish"], 0, 0,
        ptr(torch.cuda.current_stream().cuda_stream),
    )
    torch.cuda.synchronize()
    assert err != 0
    assert not bool(out.any())  # nothing ran


@pytest.mark.gpu
def test_cuda_torch_divides_by_a_scale_tensor_with_ieee_rounding(cuda):
    """What K1's int8 epilogue matches: ``x / sx`` with ``sx`` a scalar tensor
    on the card is the correctly rounded f32 quotient (a division, not a
    multiplication by the reciprocal, which differs on some values)."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal(1 << 20) * 4).astype(np.float32)).to(cuda)
    v = v.bfloat16().float()  # what the plain pass divides: widened bf16 values
    for scale in (0.0123, 0.3, 1.7e-3):
        sx = torch.tensor(scale, dtype=torch.float32, device=cuda)
        exact = (v.double() / sx.double()).float()  # 53 bits >= 2 * 24 + 2: no double rounding
        assert torch.equal(v / sx, exact)
        assert not torch.equal(v * (1.0 / sx), exact)


# K1 writing the next block's int8 input: B, H, W, Cin, C, s, weight gain, sx
# (None: an abs-max scale of the plain output, as calibrate_int8 makes one)
K1_INT8_CASES = [
    (8, 90, 160, 96, 96, 2, 1.0, None),  # the flagship's block 2
    (2, 37, 70, 32, 32, 2, 1.0, None),  # ragged tiles, the 32-wide tile
    (1, 23, 45, 48, 64, 3, 1.0, None),  # ragged tiles, the 64-wide tile, 9 sub-pixels
    (2, 16, 32, 96, 96, 2, 4.0, 2.0**-6),  # .5 ties (sx a power of two) and +-127 clamps
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Cin,C,s,gain,sx", K1_INT8_CASES)
def test_cuda_k1_int8_out_is_the_plain_pass_to_the_bit(cuda, B, H, W, Cin, C, s, gain, sx):
    """K1 with ``out_scale`` equals K1 and then ``quantize_act_int8``, every
    byte, and counts one launch that quantised."""
    from repnerv_tpu_torch.kernels import decode as dk

    p = _k1_stage(Cin=Cin, C=C, s=s, device=cuda, gain=gain, seed=B + H)
    assert p.route == "wgmma"
    x = torch.from_numpy(np.random.default_rng(H).standard_normal((B, H, W, Cin))
                         .astype(np.float32)).to(cuda).bfloat16()
    y = dk.decode_stage(x, p, "swish")
    scale = torch.tensor(sx if sx is not None else y.float().abs().amax().item() * 0.9 / 127,
                         dtype=torch.float32, device=cuda)
    before = (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES)
    got = dk.decode_stage(x, p, "swish", out_scale=scale)
    want = k8.quantize_act_int8(y, scale)
    torch.cuda.synchronize()
    assert (dk.LAUNCHES, dk.INT8_OUT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.int8 and got.shape == y.shape
    assert torch.equal(got, want)
    q = y.float() / scale
    assert bool((q.abs() > 127.5).any())  # the clamps are reached
    if sx is not None:
        assert int((q - q.floor() == 0.5).sum()) > 1000  # so are exact ties


@pytest.mark.gpu
def test_cuda_k1_int8_out_refused_by_the_wmma_route_and_a_head(cuda):
    """The wrapper raises on the WMMA route and on a head; the library, handed
    the scale anyway, returns an error and runs nothing."""
    import ctypes

    from repnerv_tpu_torch.kernels import decode as dk
    from repnerv_tpu_torch.kernels.build import load_library

    sx = torch.tensor(0.02, device=cuda)
    ptr = ctypes.c_void_p
    for p in (_k1_stage(Cin=12, device=cuda), _k1_stage(head=True, device=cuda)):
        x = torch.ones(1, 4, 6, p.cin, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="wgmma route without a head"):
            dk.decode_stage(x, p, out_scale=sx)
        route = p.route
        wt = p.w.t().contiguous()
        out = torch.zeros(1, 8, 12, p.c_final or p.c, device=cuda,
                          dtype=torch.float32 if p.c_final else torch.int8)
        err = load_library().repnerv_fused_conv_ps_act(
            dk.ROUTES.index(route), ptr(x.data_ptr()), ptr(p.w.data_ptr()), ptr(wt.data_ptr()),
            ptr(p.b.data_ptr()), ptr(p.head_w.data_ptr() if p.c_final else None),
            ptr(p.head_b.data_ptr() if p.c_final else None), ptr(out.data_ptr()),
            ptr(sx.data_ptr()), 1, 4, 6, p.cin, p.c, p.stride, dk.ACT_CODES["swish"], p.c_final,
            0, ptr(torch.cuda.current_stream().cuda_stream),
        )
        torch.cuda.synchronize()
        assert err != 0, route
        assert not bool(out.any())  # nothing ran


def test_the_int8_out_counter_is_registered_and_not_counted_twice():
    """``decode.INT8_OUT_LAUNCHES`` is in the launch record, so captures and
    replays count it; ``total`` does not count its launches again."""
    from repnerv_tpu_torch.kernels import launches

    key = ("repnerv_tpu_torch.kernels.decode", "INT8_OUT_LAUNCHES")
    before = launches.snapshot()
    assert key in before
    one = {k: ({r: 0 for r in v} if isinstance(v, dict) else 0) for k, v in before.items()}
    one["repnerv_tpu_torch.kernels.decode", "LAUNCHES"] = 1
    one["repnerv_tpu_torch.kernels.decode", "ROUTE_LAUNCHES"]["wgmma"] = 1
    one[key] = 1
    launches.add(one)
    try:
        counts = launches.since(before)
        assert counts[key] == 1 and launches.total(counts) == 1
    finally:
        launches.add(one, -1)
    assert launches.snapshot() == before
