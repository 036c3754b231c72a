"""The port's compression pipeline (repnerv_tpu_torch/compress/{prune,qat,
pipeline}.py) against the JAX package's, on the CPU at small sizes.

The same weights go into both sides (JAX initializes; the port loads the
numpy pytree through ``state_from_jax_params``), and both see the same
synthetic video.  Tolerances:

* masks, the actual prune ratio, the quantizer's report and dequantized
  weights, the ``.rnvb`` bytes: equal (the same numpy code on the same f32
  values; the global threshold is a multiset statistic, so the layouts'
  different element orders do not matter);
* the fake quantizer: equal to JAX's ``fake_quant_leaf`` (the same f32
  operations in the same order), and within 2e-6 of ``quantize_state``'s
  dequant (tests/test_qat.py's bound: jnp/torch vs numpy f32 rounding of
  ``t_min + scale * q``);
* finetuning, whose sums run in another order: the final weights within
  1e-4 of each tensor's largest |value| after 2 epochs, the bound of the
  2-epoch trajectory test in tests/test_torch_train.py (Adam normalizes
  each update, so ~1e-6 gradient differences do not compound at this
  length).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repnerv_tpu.compress import pipeline as jpipe
from repnerv_tpu.compress.prune import global_l1_masks as jax_masks
from repnerv_tpu.compress.qat import make_fake_quant as jax_fake_quant
from repnerv_tpu.compress.quantize import quantize_state
from repnerv_tpu.config import TrainConfig
from repnerv_tpu.data.frames import FrameStore as JStore
from repnerv_tpu.data.frames import synthetic_video
from repnerv_tpu.models.generator import generator_to_deploy, init_generator
from repnerv_tpu.train.checkpoint import params_to_torch_state

from repnerv_tpu_torch.compress import pipeline as tpipe
from repnerv_tpu_torch.compress.prune import global_l1_masks, sparsity_report
from repnerv_tpu_torch.compress.qat import fake_quant_leaf, make_fake_quant
from repnerv_tpu_torch.data.frames import FrameStore
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
from test_model_train import tiny_model
from test_torch_config_codecs import port_model_cfg, port_train_cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(params, cfg):
    pcfg = port_model_cfg(cfg)  # the port takes its own config class
    return load_state(Generator(pcfg), state_from_jax_params(_np(params), pcfg))


def _params(branch_type, deploy, seed=0, **over):
    cfg = tiny_model(branch_type=branch_type, fc_hw_dim="3_4_6", strides=(2, 2), **over)
    params = init_generator(jax.random.PRNGKey(seed), cfg)
    if deploy:
        params, cfg = generator_to_deploy(params, cfg)
    return params, cfg


def _state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


CASES = [("ERB", False), ("ERB", True), ("NeRV_vanilla", False), ("DBB", False)]


@pytest.mark.parametrize("branch_type,deploy", CASES)
def test_global_l1_masks_equal_jax(branch_type, deploy):
    params, cfg = _params(branch_type, deploy)
    ref, ref_ratio = jax_masks(params, branch_type, 0.3)
    masks, ratio = global_l1_masks(_model(params, cfg), branch_type, 0.3)
    assert ratio == ref_ratio
    # the JAX mask tree in the port's names: -1 where JAX has no mask
    filled = jax.tree.map(
        lambda p, m: m if p is None or m is not None else np.full(p.shape, -1.0, np.float32),
        params, ref, is_leaf=lambda x: x is None,
    )
    ref_named = {k: v for k, v in state_from_jax_params(_np(filled), port_model_cfg(cfg)).items()
                 if not (v == -1).all()}
    assert sorted(masks) == sorted(ref_named)
    for k, m in masks.items():
        np.testing.assert_array_equal(m.numpy(), ref_named[k], err_msg=k)
    rep = sparsity_report(masks)
    assert rep["ratio"] == pytest.approx(ratio, abs=1e-12)


@pytest.mark.parametrize("bit,axis", [(8, 0), (6, 0), (4, 1)])
def test_fake_quant_equals_jax_and_quantize_state(bit, axis):
    params, cfg = _params("ERB", True, seed=1)
    ref_masks, _ = jax_masks(params, "ERB", 0.3)
    from repnerv_tpu.compress.prune import apply_masks

    params = apply_masks(params, ref_masks)  # pruned zeros stay out of min / max
    model = _model(params, cfg)
    got = make_fake_quant(bit, axis)(dict(model.named_parameters()))
    ref = state_from_jax_params(_np(jax_fake_quant(bit, axis)(params)), port_model_cfg(cfg))
    dequant = quantize_state(_state(model), bit, axis)[0]
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_array_equal(v.detach().numpy(), ref[k], err_msg=k)
        np.testing.assert_allclose(v.detach().numpy(), dequant[k], atol=2e-6, rtol=0, err_msg=k)


def test_fake_quant_gradient_is_identity():
    w = torch.randn(5, 3, 3, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(5, 3, 3, 3, generator=torch.Generator().manual_seed(1))
    (fake_quant_leaf(w, 4, 0) * g).sum().backward()
    assert torch.equal(w.grad, g)
    zero = torch.zeros(2, 3)  # an all-zero tensor stays zero
    assert torch.equal(fake_quant_leaf(zero, 8, 0), zero)


def _train_cfg(mcfg, **over):
    cfg = TrainConfig(model=mcfg, epochs=4, warmup=0.2, lr=5e-3, loss_type="Fusion6",
                      manual_seed=1)
    cfg.data.batch_size = 1
    return dataclasses.replace(cfg, **over)


@pytest.fixture(scope="module")
def video():
    frames, t = synthetic_video(4, 12, 16, seed=2)
    return (JStore(frames=jnp.asarray(frames), t=t),
            FrameStore(frames=torch.from_numpy(frames), t=t))


@pytest.mark.parametrize("codec", ["huffman", "rans"])
def test_quantize_params_report_equals_jax(video, codec):
    jstore, store = video
    params, mcfg = _params("ERB", True, seed=2)
    cfg = _train_cfg(mcfg, quant_bit=6, codec=codec)
    jrep, rep = jpipe.CompressionReport(), tpipe.CompressionReport()
    jout = jpipe.quantize_params(params, cfg, jrep, frame_hw=jstore.hw, n_frames=4)
    model = _model(params, mcfg)
    out = tpipe.quantize_params(model, port_train_cfg(cfg), rep, frame_hw=store.hw, n_frames=4)
    assert out is model
    for name in ("quant_bit", "avg_bits", "efficiency", "total_bits", "bpp", "num_symbols"):
        assert getattr(rep, name) == getattr(jrep, name), name
    ref = params_to_torch_state(jout, mcfg)
    for k, v in _state(out).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("branch_type", ["ERB", "NeRV_vanilla"])
def test_path_b_bitstream_byte_equal_to_jax(video, tmp_path, branch_type):
    """PATH B (the deploy state for reparam branches, the train state for
    vanilla): prune 0.5, 8 bits, the .rnvb written by each side."""
    jstore, store = video
    params, mcfg = _params(branch_type, branch_type != "NeRV_vanilla", seed=3)
    cfg = _train_cfg(mcfg, prune_ratio=0.5, quant_bit=8)
    jpath, path = str(tmp_path / "jax.rnvb"), str(tmp_path / "port.rnvb")
    jout, jrep = jpipe.compress(params, cfg, jstore, bitstream_path=jpath)
    model = _model(params, mcfg)
    before = _state(model)
    out, rep = tpipe.compress(model, port_train_cfg(cfg), store, bitstream_path=path)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for name in ("prune_ratio_actual", "prune_ok", "avg_bits", "efficiency", "total_bits", "bpp",
                 "num_symbols"):
        assert getattr(rep, name) == getattr(jrep, name), name
    assert rep.extras["bitstream"] == jrep.extras["bitstream"]
    for k, v in _state(model).items():  # the caller's model is left alone
        np.testing.assert_array_equal(v, before[k])
    ref = params_to_torch_state(jout, cfg.model)
    for k, v in _state(out).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def _close(got, ref, rel=1e-4):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=rel * max(np.abs(r).max(), 1e-6), rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("lr_mode", ["fresh", "reference"])
def test_path_a_masked_finetune_matches_jax(video, lr_mode):
    """PATH A: train-state ERB, prune 0.3, 2 finetune epochs x 4 frames at
    -b 1 (Fusion6), fresh Adam, then deploy; no quantization, so the
    finetuned weights themselves are compared.  Pruned weights stay zero."""
    jstore, store = video
    params, mcfg = _params("ERB", False, seed=4)
    cfg = _train_cfg(mcfg, prune_ratio=0.3, finetune=True, finetune_epochs=2,
                     finetune_lr_mode=lr_mode)
    jout, jrep = jpipe.compress(params, cfg, jstore, start_epoch=2)
    model = _model(params, mcfg)
    masks, _ = global_l1_masks(model, "ERB", 0.3)
    out, rep = tpipe.compress(model, port_train_cfg(cfg), store, start_epoch=2)
    assert rep.finetune_epochs == jrep.finetune_epochs == 2
    assert rep.prune_ratio_actual == jrep.prune_ratio_actual
    assert out.cfg.deploy and all(b.rbr_reparam is not None for b in out.layers)
    dep_cfg = dataclasses.replace(mcfg, deploy=True)
    _close(_state(out), params_to_torch_state(jout, dep_cfg))

    # the masked finetune itself (before the fusion) keeps pruned weights at 0
    rep2 = tpipe.CompressionReport()
    pruned, masks = tpipe.prune_params(_model(params, mcfg), port_train_cfg(cfg), rep2)
    tuned = tpipe.finetune(pruned, masks, port_train_cfg(cfg), store, rep2)
    w = dict(tuned.named_parameters())
    for k, m in masks.items():
        assert bool((w[k][m == 0] == 0).all()), k
        assert bool((w[k][m == 1] != 0).any()), k


def test_qat_deploys_first_and_matches_jax(video):
    """--qat on a train-state ERB checkpoint: both sides deploy first, prune
    the deploy targets, finetune through the fake quantizer and quantize.
    The finetuned weights differ in the last bits (summation order), which
    can move a weight that sits on a code boundary to the neighbouring
    code: every dequantized weight is within one quantization step of
    JAX's, and under 1% of them differ by more than 1e-4 of their tensor's
    range."""
    jstore, store = video
    params, mcfg = _params("ERB", False, seed=5)
    cfg = _train_cfg(mcfg, prune_ratio=0.5, quant_bit=8, finetune=True, finetune_epochs=2,
                     finetune_qat=True)
    jout, jrep = jpipe.compress(params, cfg, jstore)
    out, rep = tpipe.compress(_model(params, mcfg), port_train_cfg(cfg), store)
    assert rep.extras.get("qat") is True and jrep.extras.get("qat") is True
    assert out.cfg.deploy
    # the deploy targets were pruned: the same ratio over stem + rbr_reparam
    assert rep.prune_ratio_actual == jrep.prune_ratio_actual
    assert abs(rep.bpp - jrep.bpp) <= 0.01 * jrep.bpp
    ref = params_to_torch_state(jout, dataclasses.replace(mcfg, deploy=True))
    got = _state(out)
    n_far = n_all = 0
    for k, r in ref.items():
        step = (r.max() - r.min()) / 2**8
        d = np.abs(got[k] - r)
        assert d.max() <= step * 1.01 + 1e-7, k
        n_far += int((d > 1e-4 * max(r.max() - r.min(), 1e-6)).sum())
        n_all += r.size
    assert n_far / n_all < 0.01
