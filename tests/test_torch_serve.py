"""The port's serving path against the JAX package, on the CPU at small
sizes: the weight bridge, the ``.rnvb`` reader and the decode CLI.

Tolerances: the bridge and the reader are bit-exact (the same numpy
operations on both sides).  Decoded frames go through the same 8-bit PNG
conversion on both sides, ``uint8(clip(255 * x))``; the f32 forwards agree
to 1e-5 (tests/test_pallas.py's bound), so a pixel may land one level
apart where 255 * x sits on an integer boundary.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from repnerv_tpu.compress.bitstream import read_bitstream as jax_read_bitstream
from repnerv_tpu.compress.bitstream import write_bitstream
from repnerv_tpu.compress.quantize import quantize_state
from repnerv_tpu.config import BRANCH_TYPES
from repnerv_tpu.config import TrainConfig as JaxTrainConfig
from repnerv_tpu.models.generator import init_generator
from repnerv_tpu.train.checkpoint import params_to_torch_state
from repnerv_tpu.train.loop import make_decode_fn as jax_make_decode_fn

from repnerv_tpu_torch.cli import decode_main
from repnerv_tpu_torch.compress.bitstream import read_bitstream
from repnerv_tpu_torch.compress.bitstream import write_bitstream as port_write_bitstream
from repnerv_tpu_torch.config import ModelConfig, TrainConfig
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
from repnerv_tpu_torch.train.loop import decode_batch_cap, decode_video, measure_decode_fps
from test_model_train import tiny_model
from test_torch_config_codecs import port_model_cfg


def _cfg(branch_type="ERB", **over):
    """The JAX package's config; ``port_model_cfg`` gives the port its own."""
    return tiny_model(branch_type=branch_type, fc_hw_dim="2_2_4", strides=(2, 2), **over)


@pytest.mark.parametrize("branch_type", BRANCH_TYPES)
@pytest.mark.parametrize("norm", ["none", "bn"])
def test_state_from_jax_params_equals_params_to_torch_state(branch_type, norm):
    cfg = _cfg(branch_type, norm=norm)
    params = init_generator(jax.random.PRNGKey(7), cfg)
    ref = params_to_torch_state(params, cfg)
    pcfg = port_model_cfg(cfg)
    state = state_from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    assert sorted(state) == sorted(ref)  # tree.map sorts dict keys: order differs
    for k in ref:
        assert state[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(state[k], ref[k], err_msg=k)
    gen = load_state(Generator(pcfg), state)  # strict=True
    assert set(gen.state_dict()) == set(state)


@pytest.mark.parametrize("codec", ["huffman", "rans"])
@pytest.mark.parametrize("prune", [False, True])
def test_read_bitstream_bit_equal_to_jax(tmp_path, codec, prune):
    """An artifact written from JAX params: the port's state equals JAX's
    read_bitstream followed by params_to_torch_state, bit for bit.  Pruned
    weights exercise the sparsity bitmaps and the zero-code rule."""
    cfg = _cfg()
    params = init_generator(jax.random.PRNGKey(8), cfg)
    if prune:
        params = jax.tree.map(lambda a: jnp.where(jnp.abs(a) < 0.05, 0.0, a), params)
    path = str(tmp_path / "model.rnvb")
    write_bitstream(path, params, cfg, 8, codec=codec)
    jparams, jcfg, jheader = jax_read_bitstream(path)
    ref = params_to_torch_state(jparams, jcfg)
    state, mcfg, header = read_bitstream(path)
    assert isinstance(mcfg, ModelConfig) and mcfg == port_model_cfg(jcfg) and header == jheader
    assert list(state) == list(ref)
    for k in ref:
        assert state[k].dtype == np.float32
        np.testing.assert_array_equal(state[k], ref[k], err_msg=k)


def test_write_state_bitstream_round_trip(tmp_path):
    """The port's writer on a port state dict reads back as the JAX
    package's quantizer's dequantized state."""
    cfg = port_model_cfg(_cfg())
    gen = Generator(cfg, seed=3)
    state = {k: v.detach().numpy() for k, v in gen.state_dict().items()}
    path = str(tmp_path / "port.rnvb")
    acct = port_write_bitstream(path, state, cfg, quant_bit=8)
    assert acct["file_bytes"] == os.path.getsize(path)
    dequant = quantize_state(state, 8)[0]
    back, mcfg, _ = read_bitstream(path)
    assert mcfg == cfg
    for k in dequant:
        np.testing.assert_array_equal(back[k], dequant[k], err_msg=k)


def _png_frames(out_dir, n):
    return np.stack(
        [np.asarray(Image.open(os.path.join(out_dir, f"pred_{i}.png"))) for i in range(n)]
    )


def test_decode_main_cpu_matches_jax_decode(tmp_path):
    """The port's decode CLI on the CPU decodes the frames that JAX's
    make_decode_fn decodes from the same artifact (train-state ERB, fused
    for serving on both sides)."""
    from repnerv_tpu.models.generator import generator_to_deploy

    cfg = _cfg()
    params = init_generator(jax.random.PRNGKey(9), cfg)
    path = str(tmp_path / "model.rnvb")
    write_bitstream(path, params, cfg, 8)
    n = 5
    out_dir = str(tmp_path / "frames")
    res = decode_main.main([path, "--frames", str(n), "--batch", "2", "--out", out_dir, "--device", "cpu"])
    assert res["frames"] == n and res["hw"] == [8, 8] and res["batch"] == 2
    got = _png_frames(out_dir, n)

    jparams, jcfg, _ = jax_read_bitstream(path)
    jparams, jcfg = generator_to_deploy(jparams, jcfg)
    decode = jax_make_decode_fn(JaxTrainConfig(model=jcfg))
    ref = np.asarray(decode(jparams, jnp.arange(n, dtype=jnp.float32) / n))
    ref = np.clip(ref * 255, 0, 255).astype(np.uint8)
    assert got.shape == ref.shape == (n, 8, 8, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_decode_video_batches_and_checksums():
    cfg = port_model_cfg(_cfg())
    gen = Generator(cfg, seed=1)
    t = torch.arange(6, dtype=torch.float32).reshape(3, 2) / 6
    frames = decode_video(gen, TrainConfig(model=cfg), t)
    sums = decode_video(gen, TrainConfig(model=cfg), t, keep_frames=False)
    assert frames.shape == (3, 2, 8, 8, 3)
    torch.testing.assert_close(sums, frames.sum(dim=(1, 2, 3, 4)), rtol=1e-6, atol=1e-4)


def test_decode_batch_cap_matches_jax():
    from repnerv_tpu.train.loop import decode_batch_cap as jax_cap

    for h, w in [(720, 1280), (1080, 1920), (8, 8), (2160, 3840)]:
        assert decode_batch_cap(h, w) == jax_cap(h, w)


def test_unported_flags_and_cpu_fps_refuse(tmp_path):
    cfg = port_model_cfg(_cfg())
    path = str(tmp_path / "m.rnvb")
    port_write_bitstream(
        path, {k: v.detach().numpy() for k, v in Generator(cfg).state_dict().items()}, cfg, 8
    )
    for flag in (["--mesh_shape", "2"],):
        with pytest.raises(SystemExit):
            decode_main.main([path, "--frames", "2", "--device", "cpu", *flag])
    # fps is a device metric: without a card it fails instead of timing the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_decode_fps(Generator(cfg), TrainConfig(model=cfg), np.arange(2) / 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decode_main.main([path, "--frames", "2"])
