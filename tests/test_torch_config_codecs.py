"""The port's own copies of the stdlib / numpy-only modules against the JAX
package's originals, on the CPU: ``config``, ``cli/args``, the quantizer, the
Huffman and rANS codecs (native and pure-Python backends) and the ``.rnvb``
writer.  Everything here is integer or byte exact: equal fields, equal
experiment ids, equal bytes.

Also home of ``port_model_cfg`` / ``port_train_cfg``, which the other port
tests use to hand the port a config of its own classes built from the
fields of a JAX-package config.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest

import repnerv_tpu.cli.args as jargs
import repnerv_tpu.compress.bitstream as jbitstream
import repnerv_tpu.compress.huffman as jhuffman
import repnerv_tpu.compress.native as jnative
import repnerv_tpu.compress.quantize as jquantize
import repnerv_tpu.compress.rans as jrans
import repnerv_tpu.config as jconfig

import repnerv_tpu_torch.cli.args as pargs
import repnerv_tpu_torch.compress.bitstream as pbitstream
import repnerv_tpu_torch.compress.huffman as phuffman
import repnerv_tpu_torch.compress.native as pnative
import repnerv_tpu_torch.compress.quantize as pquantize
import repnerv_tpu_torch.compress.rans as prans
import repnerv_tpu_torch.config as pconfig


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def port_model_cfg(jcfg) -> pconfig.ModelConfig:
    """The port's ModelConfig with the fields of a JAX-package one."""
    return pconfig.ModelConfig(**_fields(jcfg))


def port_train_cfg(jcfg) -> pconfig.TrainConfig:
    """The port's TrainConfig (with its own ModelConfig and DataConfig) with
    the fields of a JAX-package one."""
    fields = _fields(jcfg)
    fields["model"] = port_model_cfg(jcfg.model)
    fields["data"] = pconfig.DataConfig(**_fields(jcfg.data))
    return pconfig.TrainConfig(**fields)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig"])
def test_config_dataclasses_have_the_same_fields_and_defaults(name):
    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    assert pcls is not jcls  # a copy, not a re-export
    assert pcls.__module__ == "repnerv_tpu_torch.config"
    jf, pf = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert [f.type for f in pf] == [f.type for f in jf]
    assert dataclasses.asdict(pcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("name", ["BRANCH_TYPES", "ACT_TYPES", "NORM_TYPES", "LR_TYPES"])
def test_config_constants(name):
    assert getattr(pconfig, name) == getattr(jconfig, name)


def _example_train_cfgs(mod):
    yield mod.TrainConfig()
    yield mod.TrainConfig(
        model=mod.ModelConfig(branch_type="DBB", strides=(4, 3, 2), fc_hw_dim="3_4_8",
                              compute_dtype="bfloat16", decode_int8=True, norm="bn"),
        data=mod.DataConfig(dataset="synth", synthetic_frames=7, synthetic_hw=(24, 32),
                            batch_size=3, vid=(0, 5)),
        epochs=7, lr=1e-3, loss_type="Fusion6", prune_ratio=0.3, quant_bit=6, codec="rans",
        mesh_shape=(2, 2),
    )


def test_config_json_round_trip_equals_jax():
    for jcfg, pcfg in zip(_example_train_cfgs(jconfig), _example_train_cfgs(pconfig)):
        assert pcfg.to_json() == jcfg.to_json()
        # each package reads what the other wrote
        back = pconfig.TrainConfig.from_json(jcfg.to_json())
        assert back == pcfg and isinstance(back.model, pconfig.ModelConfig)
        assert jconfig.TrainConfig.from_json(pcfg.to_json()) == jcfg
        assert port_train_cfg(jcfg) == pcfg


def test_config_derived_values_equal_jax():
    for jcfg, pcfg in zip(_example_train_cfgs(jconfig), _example_train_cfgs(pconfig)):
        assert pcfg.model.embed_length == jcfg.model.embed_length
        assert pcfg.model.stem_dims == jcfg.model.stem_dims
        assert pcfg.model.fc_hwd == jcfg.model.fc_hwd
        assert pcfg.warmup_epochs() == jcfg.warmup_epochs()
        assert pconfig.stage_channels(pcfg.model) == jconfig.stage_channels(jcfg.model)
        assert pconfig.head_plan(pcfg.model) == jconfig.head_plan(jcfg.model)
        assert pconfig.output_hw(pcfg.model) == jconfig.output_hw(jcfg.model)
    assert pconfig._tupled([1, [2, 3]]) == jconfig._tupled([1, [2, 3]])
    assert pconfig._tupled([5, 2, 2]) == (5, 2, 2)


# ---------------------------------------------------------------------------
# cli/args
# ---------------------------------------------------------------------------


def _actions(parser: argparse.ArgumentParser) -> dict:
    out = {}
    for a in parser._actions:
        if not a.option_strings:
            continue
        out[a.option_strings[-1]] = (
            tuple(a.option_strings), a.dest, a.default, a.nargs, a.choices and tuple(a.choices),
            getattr(a.type, "__name__", a.type), type(a).__name__, a.help,
        )
    return out


@pytest.mark.parametrize("eval_mode", [False, True])
def test_build_parser_has_the_same_flags_defaults_and_help(eval_mode):
    jp, pp = jargs.build_parser(eval_mode=eval_mode), pargs.build_parser(eval_mode=eval_mode)
    ja, pa = _actions(jp), _actions(pp)
    assert list(pa) == list(ja)
    for flag in ja:
        assert pa[flag] == ja[flag], flag
    assert pp.fromfile_prefix_chars == jp.fromfile_prefix_chars
    assert vars(pp.parse_args([])) == vars(jp.parse_args([]))


ARG_LISTS = [
    [],
    "--dataset synth --synthetic_frames 16 --synthetic_hw 720 1280 --embed 1.25_40 "
    "--stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 --strides 5 2 2 2 2 --lower_width 96 "
    "--branch_type ERB --act swish --single_res --loss Fusion6 -b 1 --lr 5e-4 -e 2 "
    "--compute_dtype bfloat16 --outf bf".split(),
    "--dataset synth --synthetic_frames 4 --synthetic_hw 24 32 --embed 1.25_4 --stem_dim_num 16_1 "
    "--fc_hw_dim 3_4_6 --strides 2 2 2 --lower_width 4 --branch_type DBB --norm bn --act gelu "
    "--loss L2 -b 2 --lr 5e-3 -e 3 --no_pallas_train --no_pallas_decode --suffix s --warmup 0.1 "
    "--lr_type step --lr_steps 0.5 0.8 --sigmoid --manualSeed 7".split(),
]
EVAL_ARG_LISTS = [
    [],
    ARG_LISTS[1] + "--prune_ratio 0.2 --quant_bit 8 --save_bitstream --decode_int8".split(),
    ARG_LISTS[2] + "--finetune --finetune_epochs 2 --qat --quant_bit 4 --codec rans "
                   "--quant_axis 1".split(),
]


@pytest.mark.parametrize("eval_mode,argv", [(False, a) for a in ARG_LISTS]
                         + [(True, a) for a in EVAL_ARG_LISTS])
def test_args_to_config_and_exp_id_equal_jax(eval_mode, argv):
    ja = jargs.build_parser(eval_mode=eval_mode).parse_args(argv)
    pa = pargs.build_parser(eval_mode=eval_mode).parse_args(argv)
    assert vars(pa) == vars(ja)
    jcfg, pcfg = jargs.args_to_config(ja), pargs.args_to_config(pa)
    assert isinstance(pcfg, pconfig.TrainConfig) and isinstance(pcfg.model, pconfig.ModelConfig)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.to_json() == jcfg.to_json()
    assert pargs.exp_id(pcfg) == jargs.exp_id(jcfg)


# ---------------------------------------------------------------------------
# the codecs: quantizer, Huffman, rANS, native and pure-Python
# ---------------------------------------------------------------------------


def _state(seed=0, prune=False):
    rng = np.random.default_rng(seed)
    state = {
        "stem.0.weight": rng.standard_normal((16, 12)).astype(np.float32),
        "stem.0.bias": rng.standard_normal(16).astype(np.float32),
        "layers.0.conv.weight": (rng.standard_normal((24, 8, 3, 3)) * 0.2).astype(np.float32),
        "layers.0.conv.bias": (rng.standard_normal(24) * 0.1).astype(np.float32),
        "head.weight": rng.standard_normal((3, 6, 1, 1)).astype(np.float32),
        "scalar": np.asarray(0.5, np.float32),
    }
    if prune:
        for k in ("stem.0.weight", "layers.0.conv.weight"):
            state[k] = np.where(np.abs(state[k]) < 0.15, 0.0, state[k]).astype(np.float32)
    return state


@pytest.mark.parametrize("bit,axis", [(8, 0), (6, 1), (4, 0)])
@pytest.mark.parametrize("prune", [False, True])
def test_quantize_state_equals_jax(bit, axis, prune):
    state = _state(bit, prune)
    got, ref = pquantize.quantize_state(state, bit, axis), jquantize.quantize_state(state, bit, axis)
    for k in state:
        np.testing.assert_array_equal(got[0][k], ref[0][k], err_msg=k)  # dequantized
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)  # codes
        assert got[3][k].axis == ref[3][k].axis
        np.testing.assert_array_equal(got[3][k].t_min, ref[3][k].t_min)
        np.testing.assert_array_equal(got[3][k].scale, ref[3][k].scale)
    assert len(got[2]) == len(ref[2])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


def _symbols(seed, n=5000):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal(n) * 9 + 128).clip(0, 255)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """Both backends of both packages: the native one as built, or every
    native entry point answering None (what no toolchain looks like)."""
    if request.param == "native":
        if not (pnative.native_available() and jnative.native_available()):
            pytest.skip("no C++ toolchain: the native backends are not built")
        return "native"
    none = lambda *a, **k: None  # noqa: E731
    for mod in (phuffman, jhuffman):
        monkeypatch.setattr(mod, "native_encode", none)
        monkeypatch.setattr(mod, "native_decode", none)
    for mod in (prans, jrans):
        monkeypatch.setattr(mod, "rans_native_encode", none)
        monkeypatch.setattr(mod, "rans_native_decode", none)
    return "python"


@pytest.mark.parametrize("seed", [0, 1])
def test_huffman_bytes_equal_jax_and_decode_back(backend, seed):
    data = _symbols(seed, 5000 if backend == "native" else 1500)
    uniq, cnt = np.unique(data, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    pc, jc = phuffman.HuffmanCodec.from_frequencies(freqs), jhuffman.HuffmanCodec.from_frequencies(freqs)
    assert pc.get_code_table() == jc.get_code_table()
    (pblob, pbits), (jblob, jbits) = pc.encode(data), jc.encode(data)
    assert pbits == jbits and bytes(pblob) == bytes(jblob)
    np.testing.assert_array_equal(np.asarray(pc.decode(pblob, len(data))), data)
    # a decoder rebuilt from the code lengths alone, as the .rnvb reader does
    tbl = pc.get_code_table()
    again = phuffman.HuffmanCodec.from_lengths({s: tbl[s][0] for s in tbl})
    np.testing.assert_array_equal(np.asarray(again.decode(jblob, len(data))), data)
    assert phuffman.entropy_stats(data, 8) == jhuffman.entropy_stats(data, 8)
    assert phuffman.bits_per_pixel(1e6, 10, 72, 128) == jhuffman.bits_per_pixel(1e6, 10, 72, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_rans_bytes_equal_jax_and_decode_back(backend, seed):
    data = _symbols(seed, 5000 if backend == "native" else 1500)
    uniq, cnt = np.unique(data, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    pc, jc = prans.RansCodec.from_frequencies(freqs), jrans.RansCodec.from_frequencies(freqs)
    assert list(pc.syms) == list(jc.syms) and pc.scale_bits == jc.scale_bits
    np.testing.assert_array_equal(pc.freq, jc.freq)
    (pblob, pbits), (jblob, jbits) = pc.encode(data), jc.encode(data)
    assert pbits == jbits and bytes(pblob) == bytes(jblob)
    np.testing.assert_array_equal(np.asarray(pc.decode(pblob, len(data))), data)
    again = prans.RansCodec(pc.syms, np.asarray(pc.freq, np.uint32), pc.scale_bits)
    np.testing.assert_array_equal(np.asarray(again.decode(jblob, len(data))), data)
    assert prans.entropy_stats_rans(data, 8) == jrans.entropy_stats_rans(data, 8)


def test_native_backends_agree_with_pure_python(monkeypatch):
    """Within the port: the C++ coders write the pure-Python coders' bytes."""
    if not pnative.native_available():
        pytest.skip("no C++ toolchain: the native backends are not built")
    data = _symbols(3, 2000)
    uniq, cnt = np.unique(data, return_counts=True)
    freqs = {float(s): int(c) for s, c in zip(uniq.tolist(), cnt.tolist())}
    hc, rc = phuffman.HuffmanCodec.from_frequencies(freqs), prans.RansCodec.from_frequencies(freqs)
    native = (hc.encode(data), rc.encode(data))
    none = lambda *a, **k: None  # noqa: E731
    monkeypatch.setattr(phuffman, "native_encode", none)
    monkeypatch.setattr(prans, "rans_native_encode", none)
    pure = (hc.encode(data), rc.encode(data))
    for (nb, nbits), (pb, pbits) in zip(native, pure):
        assert nbits == pbits and bytes(nb) == bytes(pb)


def test_native_libraries_are_built_in_the_ports_own_directory():
    """The port compiles native/*.cpp into its own (ignored) build directory,
    never over the libraries beside the sources."""
    pkg = os.path.dirname(os.path.abspath(pconfig.__file__))
    for so in (pnative._SO, pnative._RANS_SO):
        assert os.path.dirname(so) == os.path.join(pkg, "_build")
    for src in (pnative._SRC, pnative._RANS_SRC):
        assert os.path.exists(src) and os.path.dirname(src) == os.path.dirname(jnative._SRC)
    assert pnative._SO != jnative._SO and pnative._RANS_SO != jnative._RANS_SO


# ---------------------------------------------------------------------------
# the .rnvb writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["huffman", "rans"])
@pytest.mark.parametrize("prune", [False, True])
def test_write_bitstream_bytes_equal_jax(tmp_path, codec, prune):
    """The same quantized state through both writers: equal files.  The JAX
    writer takes a params pytree unless handed ``precomputed``; both get the
    same (state, codes, qparams)."""
    state = _state(5, prune)
    jcfg = jconfig.ModelConfig(branch_type="ERB", fc_hw_dim="2_2_4", strides=(2, 2))
    _, codes, _, qparams = jquantize.quantize_state(state, 8, 0)
    jpath, ppath, qpath = (str(tmp_path / n) for n in ("j.rnvb", "p.rnvb", "q.rnvb"))
    jacct = jbitstream.write_bitstream(jpath, None, jcfg, 8, 0, codec,
                                       precomputed=(state, codes, qparams))
    pacct = pbitstream.write_bitstream(ppath, None, port_model_cfg(jcfg), 8, 0, codec,
                                       precomputed=(state, codes, qparams))
    # ... and quantizing in the port's writer itself
    qacct = pbitstream.write_bitstream(qpath, state, port_model_cfg(jcfg), 8, 0, codec)
    with open(jpath, "rb") as f:
        ref = f.read()
    for path, acct in ((ppath, pacct), (qpath, qacct)):
        with open(path, "rb") as f:
            assert f.read() == ref
        assert acct == jacct
    assert ref[:4] == pbitstream.MAGIC == jbitstream.MAGIC
    assert pbitstream.VERSION == jbitstream.VERSION
    # and the port reads it back as the dequantized state, with its own config class
    back, mcfg, header = pbitstream.read_bitstream(ppath)
    dequant = pquantize.quantize_state(state, 8, 0)[0]
    for k in state:
        np.testing.assert_array_equal(back[k], dequant[k], err_msg=k)
    assert isinstance(mcfg, pconfig.ModelConfig) and mcfg == port_model_cfg(jcfg)
    assert header["codec"] == codec


def test_bitstream_helpers_equal_jax():
    rng = np.random.default_rng(0)
    t_min, scale = rng.standard_normal((5, 1)).astype(np.float32), rng.random((5, 1)).astype(np.float32)
    np.testing.assert_array_equal(pbitstream._codes_of_zero(t_min, scale),
                                  jbitstream._codes_of_zero(t_min, scale))
    assert pbitstream.all_in_bpp(12345.0, 16, 720, 1280) == jbitstream.all_in_bpp(12345.0, 16, 720, 1280)
    assert pbitstream.all_in_bpp(1.0, 0, 720, 1280) == 0.0
