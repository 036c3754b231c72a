"""The port's small modules off the main path, each against the JAX package
on the CPU: the checkpoint inspector (repnerv_tpu_torch/tools/read_ckpt.py),
the upscale-conv variants (models/upscale.py), the transformer positional
table, ``pixel_unshuffle``, ``split_channels``, ``StepTimer`` and
``device_memory_stats``.

Bounds: the inspector prints the same lines as the JAX package's for the
same file; integer and layout functions are equal; f32 arithmetic that
sums or takes a transcendental in another order within 1e-5 (upscale, as
tests/test_upscale.py holds the JAX side to torch) and 1e-6 (the table).
"""

import math
import os

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.config import ModelConfig
from repnerv_tpu_torch.models import embedding as temb
from repnerv_tpu_torch.models import upscale as tup
from repnerv_tpu_torch.models.generator import Generator, generator_to_deploy
from repnerv_tpu_torch.models.layers import pixel_shuffle, pixel_unshuffle
from repnerv_tpu_torch.tools import read_ckpt
from repnerv_tpu_torch.train import checkpoint as ckpt
from repnerv_tpu_torch.utils.misc import split_channels
from repnerv_tpu_torch.utils.profiling import StepTimer, device_memory_stats

TINY = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                   lower_width=4, branch_type="ERB")


# ---------------------------------------------------------------------------
# A6r: the checkpoint inspector
# ---------------------------------------------------------------------------


def _both_print(capsys, argv):
    from repnerv_tpu.tools import read_ckpt as jread

    jread.main(argv)
    ref = capsys.readouterr().out
    read_ckpt.main(argv)
    return capsys.readouterr().out, ref


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("deploy", [False, True])
def test_read_ckpt_prints_the_jax_summary_of_a_pth(tmp_path, capsys, writer, deploy):
    """One .pth written by each package (train or deploy state), read by
    both inspectors, with a preview shorter than the state."""
    path = str(tmp_path / "model.pth")
    if writer == "port":
        model = Generator(TINY, seed=0)
        if deploy:
            model = generator_to_deploy(model)
        ckpt.save_pth(path, model.state_dict(), {"epoch": 3})
    else:
        import jax

        from repnerv_tpu.config import ModelConfig as JaxModelConfig
        from repnerv_tpu.models import generator as jgen
        from repnerv_tpu.train import checkpoint as jckpt

        jcfg = JaxModelConfig(**{k: getattr(TINY, k) for k in TINY.__dataclass_fields__})
        params = jgen.init_generator(jax.random.PRNGKey(0), jcfg)
        if deploy:
            params, jcfg = jgen.generator_to_deploy(params, jcfg)
        jckpt.save_pth(path, params, jcfg, {"epoch": 3})
    got, ref = _both_print(capsys, [path, "--limit", "5"])
    assert got == ref
    assert ("DEPLOY state" in got) == deploy and ("TRAIN state" in got) != deploy
    assert "... (" in got


def test_read_ckpt_prints_the_jax_summary_of_an_rnvb(tmp_path, capsys):
    from repnerv_tpu_torch.compress.bitstream import write_bitstream
    from repnerv_tpu_torch.compress.pipeline import model_state

    model = generator_to_deploy(Generator(TINY, seed=1))
    path = str(tmp_path / "model.rnvb")
    write_bitstream(path, model_state(model), model.cfg, 8)
    got, ref = _both_print(capsys, [path])
    assert got == ref and got.startswith("RNVB bitstream:") and "codec=huffman" in got


def test_read_ckpt_reads_the_resume_file_and_refuses_orbax(tmp_path, capsys):
    from repnerv_tpu_torch.config import TrainConfig
    from repnerv_tpu_torch.train.loop import init_train_state

    state = init_train_state(TrainConfig(model=TINY), "cpu", seed=0)
    ckpt.save_resume(str(tmp_path), state.model, state.optimizer, 5, 1)
    read_ckpt.main([os.path.join(str(tmp_path), ckpt.RESUME_FILE)])
    out = capsys.readouterr().out
    assert "Top-level keys: ['model', 'optimizer', 'step', 'epoch']" in out
    n = len(state.model.state_dict())
    assert f"Tensors: {n}" in out and "TRAIN state (multi-branch reparam convs)" in out
    with pytest.raises(SystemExit, match="Orbax checkpoints .* not ported"):
        read_ckpt.main([str(tmp_path)])


def test_classify_and_summary_equal_jax():
    from repnerv_tpu.tools import read_ckpt as jread

    keys = ["module.layers.0.rbr_reparam.weight", "layers.1.branch.conv.weight",
            "layers.0.rbr_3x3_branch.weight"]
    for i in range(len(keys) + 1):
        assert read_ckpt.classify(keys[:i]) == jread.classify(keys[:i])
    state = {k: np.zeros((2, 3), np.float32) for k in keys}
    assert read_ckpt.summarize_state_dict(state, 2) == jread.summarize_state_dict(state, 2)


# ---------------------------------------------------------------------------
# A10: models/upscale.py (tests/test_upscale.py's cases, against the JAX package)
# ---------------------------------------------------------------------------


def _to_jax(params, conv_type):
    """The port's parameters in the JAX package's layouts (HWIO)."""
    import jax.numpy as jnp

    if conv_type == "deconv":
        p = params["deconv"]
        return {"deconv": {"w": jnp.asarray(p["w"].numpy().transpose(2, 3, 0, 1)),
                           "b": jnp.asarray(p["b"].numpy())}}
    p = params["conv"]
    return {"conv": {"w": jnp.asarray(p["w"].numpy().transpose(2, 3, 1, 0)),
                     "b": jnp.asarray(p["b"].numpy())}}


@pytest.mark.parametrize("conv_type", ["conv", "deconv", "bilinear"])
def test_custom_conv_matches_jax(conv_type):
    """Shapes and bounds of the init; the same weights through both
    packages' ``apply_custom_conv``."""
    import jax.numpy as jnp

    from repnerv_tpu.models import upscale as jup

    gen = torch.Generator().manual_seed(0)
    p = tup.init_custom_conv(4, 6, 2, conv_type, generator=gen)
    w = next(iter(p.values()))["w"]
    fan_in = 4 * 2 * 2 if conv_type == "deconv" else w.shape[1] * w.shape[2] * w.shape[3]
    assert float(w.abs().max()) <= 1 / math.sqrt(fan_in)
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 4)).astype(np.float32)
    out = tup.apply_custom_conv(p, torch.from_numpy(x), 2, conv_type)
    assert tuple(out.shape) == (2, 10, 14, 6)
    ref = jup.apply_custom_conv(_to_jax(p, conv_type), jnp.asarray(x), 2, conv_type)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bilinear_matches_jax_align_corners():
    import jax.numpy as jnp

    from repnerv_tpu.models import upscale as jup

    x = np.random.default_rng(0).normal(size=(1, 5, 6, 3)).astype(np.float32)
    got = tup.upsample_bilinear_align_corners(torch.from_numpy(x), 2).numpy()
    ref = np.asarray(jup.upsample_bilinear_align_corners(jnp.asarray(x), 2))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_deconv_matches_torch_conv_transpose():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 6, 2, 2)).astype(np.float32) * 0.2  # [in, out, kh, kw]
    b = rng.normal(size=(6,)).astype(np.float32)
    got = tup.apply_custom_conv({"deconv": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}},
                                torch.from_numpy(x), 2, "deconv")
    tconv = torch.nn.ConvTranspose2d(3, 6, 2, 2)
    tconv.weight.data = torch.from_numpy(w)
    tconv.bias.data = torch.from_numpy(b)
    ref = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# A10: the transformer positional table, pixel_unshuffle, split_channels
# ---------------------------------------------------------------------------


def test_transformer_positional_table_matches_jax():
    import jax.numpy as jnp

    from repnerv_tpu.models import embedding as jemb

    table = temb.transformer_positional_table(16, 100)
    ref = np.asarray(jemb.transformer_positional_table(16, 100))
    assert tuple(table.shape) == (100, 16) and table.dtype == torch.float32
    np.testing.assert_allclose(table.numpy(), ref, atol=1e-6)
    div = math.exp(2 * 3 * (-math.log(10000.0) / 16))
    assert float(table[7, 6]) == pytest.approx(math.sin(7 * div), abs=1e-5)
    t = np.array([0.07, 0.125, 0.5, 0.985], np.float32)  # 12.5 rounds half to even
    got = temb.transformer_positional_encoding(torch.from_numpy(t), table)
    want = jemb.transformer_positional_encoding(jnp.asarray(t), jnp.asarray(table.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), table[12].numpy())


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_pixel_unshuffle_matches_jax_and_inverts_the_shuffle(stride):
    import jax.numpy as jnp

    from repnerv_tpu.models.layers import pixel_unshuffle as junshuffle

    x = torch.arange(2 * 3 * 4 * 2 * stride * stride, dtype=torch.float32).reshape(
        2, 3, 4, 2 * stride * stride)
    y = pixel_shuffle(x, stride)
    assert torch.equal(pixel_unshuffle(y, stride), x)
    np.testing.assert_array_equal(pixel_unshuffle(y, stride).numpy(),
                                  np.asarray(junshuffle(jnp.asarray(y.numpy()), stride)))
    ref = torch.nn.functional.pixel_unshuffle(y.permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)
    assert torch.equal(pixel_unshuffle(y, stride), ref)


@pytest.mark.parametrize("n,k", [(13, 6), (12, 6), (100, 7), (3, 5)])
def test_split_channels_equals_jax(n, k):
    from repnerv_tpu.utils.misc import split_channels as jsplit

    assert split_channels(n, k) == jsplit(n, k)
    assert sum(split_channels(n, k)) == n


# ---------------------------------------------------------------------------
# A10: StepTimer and device_memory_stats
# ---------------------------------------------------------------------------


def test_step_timer_times_blocks_as_jax():
    import jax.numpy as jnp

    from repnerv_tpu.utils.profiling import StepTimer as JaxStepTimer

    ref = JaxStepTimer()
    with ref.measure():
        ref.sync(jnp.ones((64, 64)) @ jnp.ones((64, 64)))
    timer = StepTimer("cpu")
    for _ in range(2):
        with timer.measure():
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 2 and len(ref.times) == 1
    assert 0 < timer.best_ms <= timer.mean_ms and np.isfinite(ref.mean_ms)
    assert math.isnan(StepTimer("cpu").best_ms) and math.isnan(JaxStepTimer().mean_ms)


def test_device_memory_stats_and_timer_need_a_card_when_asked(monkeypatch):
    from repnerv_tpu.utils.profiling import device_memory_stats as jstats

    assert device_memory_stats("cpu") == {} and isinstance(jstats(), dict)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_memory_stats("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        StepTimer("cuda")


@pytest.mark.gpu
def test_step_timer_and_memory_stats_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events and the device's memory stats")
    x = torch.ones(1024, 1024, device="cuda")
    timer = StepTimer("cuda")
    with timer.measure():
        x @ x
    stats = device_memory_stats("cuda")
    assert timer.best_ms > 0
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"] < stats["bytes_limit"]
