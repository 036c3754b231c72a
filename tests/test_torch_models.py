"""The port's model modules (repnerv_tpu_torch/models) against the JAX
package, on the CPU at small sizes.

The same weights go into both sides: JAX initializes, and the port loads
the numpy pytree through ``state_from_jax_params``.  Inputs come from a
numpy seed.  Tolerances, in f32:
  * exact where both sides do the same f32 operations in the same order
    (pixel shuffle, the positional-encoding phase);
  * 1e-6 where an elementwise op or a short contraction may round or order
    differently (activations, fusion einsums over <= 2*Cin terms);
  * 1e-5 through convolutions, what tests/test_pallas.py holds the Pallas
    kernel to under conftest.py's "highest" matmul precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repnerv_tpu.config import ACT_TYPES, BRANCH_TYPES
from repnerv_tpu.models import embedding as jemb
from repnerv_tpu.models import generator as jgen
from repnerv_tpu.models import layers as jlayers
from repnerv_tpu.models import reparam as jreparam
from repnerv_tpu.models.blocks import init_block

from repnerv_tpu_torch.models import generator as tgen
from repnerv_tpu_torch.models import layers as tlayers
from repnerv_tpu_torch.models import reparam as treparam
from repnerv_tpu_torch.models.blocks import NeRVBlock, block_to_deploy
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, generator_to_deploy
from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
from test_model_train import tiny_model
from test_torch_config_codecs import port_model_cfg


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_generator(params, cfg):
    pcfg = port_model_cfg(cfg)  # the port takes its own config class
    return load_state(Generator(pcfg), state_from_jax_params(_np_tree(params), pcfg))


def test_positional_encoding_levels_40():
    """The flagship's 1.25_40 spec: the phase reaches ~2.3e4 at level 39,
    where the (t * base**i) * pi rounding order shows in sin/cos."""
    t = np.random.default_rng(0).random(16).astype(np.float32)
    ref = np.asarray(jemb.positional_encoding(jnp.asarray(t), "1.25_40"))
    out = positional_encoding(torch.from_numpy(t), "1.25_40").numpy()
    assert out.shape == (16, 80)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_array_equal(
        positional_encoding(torch.from_numpy(t), "none").numpy(),
        np.asarray(jemb.positional_encoding(jnp.asarray(t), "none")),
    )


@pytest.mark.parametrize("act", ACT_TYPES)
def test_activations_match_jax(act):
    x = (np.random.default_rng(1).standard_normal(4096) * 8).astype(np.float32)
    x[:4] = [0.0, -3.0, 3.0, 25.0]  # kinks of relu6/hardswish; softplus past torch's threshold
    ref = np.asarray(jlayers.activation(jnp.asarray(x), act))
    out = tlayers.activation(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2, 5])
def test_pixel_shuffle_matches_jax_and_torch(stride):
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 3 * stride * stride))
    x = x.astype(np.float32)
    out = tlayers.pixel_shuffle(torch.from_numpy(x), stride)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jlayers.pixel_shuffle(jnp.asarray(x), stride))
    )
    # the same channel order as torch.nn.PixelShuffle on the NCHW view
    nchw = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    np.testing.assert_array_equal(out.numpy(), nchw.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("norm", ["bn", "in"])
def test_eval_norms_match_jax(norm):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    p = {k: rng.random(4).astype(np.float32) + 0.5 for k in ("scale", "bias", "mean", "var")}
    ref = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), norm, train=False)
    mod = tlayers.make_norm(norm, 4).eval()  # train mode uses the batch statistics
    if norm == "bn":
        mod.load_state_dict(
            {"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
             "running_mean": torch.from_numpy(p["mean"]), "running_var": torch.from_numpy(p["var"])}
        )
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("branch_type", BRANCH_TYPES)
def test_reparam_fuse_matches_jax(branch_type):
    """The port's OIHW fusion equals the JAX HWIO fusion for every branch type."""
    params = init_block(
        jax.random.PRNGKey(4), ngf=6, new_ngf=3, stride=2, branch_type=branch_type
    )
    cfg = tiny_model(branch_type=branch_type)
    full = {"stem": [], "blocks": [_np_tree(params)], "heads": []}
    blk = NeRVBlock(
        ngf=6, new_ngf=3, stride=2, branch_type=branch_type, generator=torch.Generator()
    )
    state = {k.split(".", 2)[2]: torch.from_numpy(np.array(v))
             for k, v in state_from_jax_params(full, port_model_cfg(cfg)).items()}
    blk.load_state_dict(state, strict=True)
    k_ref, b_ref = jreparam.fuse(branch_type, params)
    with torch.no_grad():
        k, b = treparam.fuse(branch_type, blk)
        k, b = k.detach(), None if b is None else b.detach()
    np.testing.assert_allclose(
        k.numpy(), np.asarray(k_ref).transpose(3, 2, 0, 1), atol=1e-6
    )
    if b_ref is None:
        assert b is None
    else:
        np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-6)
    block_to_deploy(blk)
    assert [n for n, _ in blk.named_parameters()] == ["rbr_reparam.weight", "rbr_reparam.bias"]


@pytest.mark.parametrize("branch_type", BRANCH_TYPES)
def test_generator_train_state_matches_jax_and_deploy(branch_type):
    """Train-state weights: the port's fused forward equals JAX's eval forward,
    and the port's deploy model equals its own train-state forward."""
    cfg = tiny_model(branch_type=branch_type, fc_hw_dim="4_4_8", strides=(2, 2), lower_width=6)
    params = jgen.init_generator(jax.random.PRNGKey(5), cfg)
    t = np.asarray([0.1, 0.6], np.float32)
    ref = jgen.apply_generator(params, jemb.positional_encoding(jnp.asarray(t), cfg.embed), cfg, train=False)
    gen = _port_generator(params, cfg)
    emb = positional_encoding(torch.from_numpy(t), cfg.embed)
    with torch.no_grad():
        out = gen(emb)
        assert len(out) == len(ref) == 1 and out[0].dtype == torch.float32
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-5)
        n_train = tgen.param_count(gen)
        assert n_train == jgen.param_count(params)
        dep = generator_to_deploy(gen)
        assert dep.cfg.deploy
        if branch_type != "NeRV_vanilla":  # its one branch is already a single conv
            assert tgen.param_count(dep) < n_train
        np.testing.assert_allclose(dep(emb)[0].numpy(), out[0].numpy(), atol=1e-5)


def test_generator_kernel_path_matches_jax_pallas_path(monkeypatch):
    """The decode gate with the kernel path on, as test_pallas.py's
    generator test: both sides run their fused decode stage on every block
    (min pixels 1), JAX's Pallas kernel in interpret mode, the port's plain
    version (CPU tensors); the last stage has the head fused in."""
    import repnerv_tpu.pallas_kernels.decode as jdec

    orig = jdec.fused_conv_ps_act
    monkeypatch.setattr(
        jdec, "fused_conv_ps_act", lambda *a, **k: orig(*a, **{**k, "interpret": True})
    )
    monkeypatch.setattr(jgen, "PALLAS_MIN_PIXELS", 1)
    monkeypatch.setattr(jgen, "PALLAS_REQUIRE_TPU", False)
    monkeypatch.setattr(tgen, "KERNEL_MIN_PIXELS", 1)
    calls = []
    stage = tgen.decode_kernel.decode_stage
    monkeypatch.setattr(
        tgen.decode_kernel, "decode_stage", lambda *a, **k: calls.append(1) or stage(*a, **k)
    )

    cfg = tiny_model(branch_type="ERB", fc_hw_dim="8_8_8", strides=(5, 2), lower_width=8)
    params = jgen.init_generator(jax.random.PRNGKey(3), cfg)
    dep, dep_cfg = jgen.generator_to_deploy(params, cfg)
    t = np.asarray([0.2, 0.7], np.float32)
    ref = jgen.apply_generator(
        dep, jemb.positional_encoding(jnp.asarray(t), cfg.embed), dep_cfg, train=False
    )[0]
    gen = generator_to_deploy(_port_generator(params, cfg))
    with torch.no_grad():
        out = gen(positional_encoding(torch.from_numpy(t), cfg.embed))[0]
    assert calls == [1, 1]
    assert tuple(out.shape) == (2, 80, 80, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_generator_bf16_matches_jax():
    """compute_dtype bfloat16 on the library-conv path: both sides round at
    the same points, but bf16 convs sum in other orders and round each
    partial differently; the frames ([0, 1] after the squash) agree to a few
    bf16 ulps (2^-8 each)."""
    cfg = tiny_model(branch_type="ERB", fc_hw_dim="4_4_8", strides=(2, 2), lower_width=6)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = jgen.init_generator(jax.random.PRNGKey(6), cfg)
    t = np.asarray([0.3, 0.9], np.float32)
    ref = jgen.apply_generator(params, jemb.positional_encoding(jnp.asarray(t), cfg.embed), cfg, train=False)
    with torch.no_grad():
        out = _port_generator(params, cfg)(positional_encoding(torch.from_numpy(t), cfg.embed))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=2e-2)


def test_generator_trains_in_mixed():
    """compute_dtype "mixed" trains (it was refused before the port had its
    custom VJPs): a train-mode forward of f32 frames that matches the JAX
    package's, and a backward that reaches every parameter."""
    cfg = tiny_model(branch_type="ERB", fc_hw_dim="4_4_8", strides=(2, 2), lower_width=6,
                     compute_dtype="mixed")
    params = jgen.init_generator(jax.random.PRNGKey(7), cfg)
    t = np.asarray([0.3, 0.9], np.float32)
    ref = jgen.apply_generator(params, jemb.positional_encoding(jnp.asarray(t), cfg.embed), cfg,
                               train=True)
    gen = _port_generator(params, cfg).train()
    out = gen(positional_encoding(torch.from_numpy(t), cfg.embed))
    assert out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref[0]), atol=1e-5)
    out[0].sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in gen.parameters())


@pytest.mark.parametrize("online_fuse", [True, False])
def test_ecb_forward_builds_no_host_tensor_after_the_first(monkeypatch, online_fuse):
    """ECB's edge masks are made once per (dtype, device) and kept there: a
    second forward makes no torch.tensor from host data (on the card each
    such copy waits for the stream).  The ECB parity tests keep the values
    honest."""
    blk = NeRVBlock(ngf=4, new_ngf=3, stride=2, branch_type="ECB",
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 6, 4, generator=torch.Generator().manual_seed(1))
    first = blk(x, online_fuse=online_fuse)
    calls = []
    real = torch.tensor

    def counting_tensor(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting_tensor)
    second = blk(x, online_fuse=online_fuse)
    assert calls == []
    assert torch.equal(first, second)
