"""The port's one-dispatch serving (``train/loop.py``: ``make_video_decode_fn``,
``make_decode_fn``, ``VideoDecode``, ``decode_graph_key``; the sharded decode
of ``parallel/sharding.py``) against the JAX package's ``lax.scan`` decode,
on the CPU at a small size, and the CUDA graph against the eager decode on
the card.

On the CPU ``make_video_decode_fn`` runs ``decode_video``, the eager loop of
batches; the captured batch (``VideoDecode.step``, on fixed buffers) is run
eagerly here too and held to it.  Inputs come from numpy seeds; the JAX
params reach the port through ``state_from_jax_params``.  Tolerances:

* f32 frames: 1e-5 absolute (tests/test_pallas.py's bound: the same
  arithmetic, convolutions summed in other orders); checksums rtol 1e-5
  (sums of 384 such values);
* bf16: 5e-2 (chip_smoke.py's SERVE_BF16_ATOL: the two frameworks round to
  bf16 at other points, and the roundings compound over the stages);
* graph against eager on the card: equal bits (the same kernels in the same
  order, cuDNN held to its deterministic algorithms).

JAX is imported inside the parity tests, so the ``gpu`` tests run where JAX
is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_decode_graph.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repnerv_tpu_torch.config import ModelConfig, TrainConfig
from repnerv_tpu_torch.kernels import launches
from repnerv_tpu_torch.models.embedding import positional_encoding
from repnerv_tpu_torch.models.generator import Generator, calibrate_int8, generator_to_deploy
from repnerv_tpu_torch.parallel import sharding
from repnerv_tpu_torch.train import loop


def _jax_cfg(dtype="float32", deploy=True):
    """A tiny ERB generator (8x8 frames) of the JAX package, deployed or not,
    its params from a seed, and the port's generator with the same weights."""
    import jax

    from repnerv_tpu.models.generator import generator_to_deploy as jdeploy
    from repnerv_tpu.models.generator import init_generator

    from repnerv_tpu_torch.train.checkpoint import load_state, state_from_jax_params
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_model_cfg

    jcfg = tiny_model(branch_type="ERB", fc_hw_dim="2_2_4", strides=(2, 2), compute_dtype=dtype)
    params = init_generator(jax.random.PRNGKey(11), jcfg)
    if deploy:
        params, jcfg = jdeploy(params, jcfg)
    pcfg = port_model_cfg(jcfg)
    gen = load_state(Generator(pcfg), state_from_jax_params(jax.tree.map(np.asarray, params),
                                                            pcfg))
    return params, jcfg, gen.eval()


T_BATCHES = (np.arange(12, dtype=np.float32) / 12).reshape(3, 4)  # 3 batches of 4 frames


@pytest.mark.parametrize("dtype,deploy,keep_frames", [
    ("float32", True, True),
    ("float32", True, False),
    ("float32", False, True),  # a train-state model in eval mode (train_main --eval_fps)
    ("bfloat16", True, True),
    ("bfloat16", True, False),
])
def test_video_decode_matches_jax(dtype, deploy, keep_frames):
    import jax.numpy as jnp

    from repnerv_tpu.config import TrainConfig as JaxTrainConfig
    from repnerv_tpu.train.loop import make_video_decode_fn as jax_video_decode_fn

    params, jcfg, gen = _jax_cfg(dtype, deploy)
    ref = np.asarray(jax_video_decode_fn(JaxTrainConfig(model=jcfg), keep_frames=keep_frames)(
        params, jnp.asarray(T_BATCHES)))
    got = loop.make_video_decode_fn(TrainConfig(model=gen.cfg), keep_frames=keep_frames)(
        gen, torch.from_numpy(T_BATCHES))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert ref.shape == ((3, 4, 8, 8, 3) if keep_frames else (3,))
    if keep_frames:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 if dtype == "float32" else 5e-2)
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    else:  # 384 values each within 5e-2
        np.testing.assert_allclose(got.numpy(), ref, atol=384 * 5e-2)


def test_decode_fn_is_the_one_batch_case_and_matches_jax():
    import jax.numpy as jnp

    from repnerv_tpu.config import TrainConfig as JaxTrainConfig
    from repnerv_tpu.train.loop import make_decode_fn as jax_decode_fn

    params, jcfg, gen = _jax_cfg()
    t = T_BATCHES[1]
    ref = np.asarray(jax_decode_fn(JaxTrainConfig(model=jcfg))(params, jnp.asarray(t)))
    cfg = TrainConfig(model=gen.cfg)
    got = loop.make_decode_fn(cfg)(gen, torch.from_numpy(t))
    assert tuple(got.shape) == ref.shape == (4, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert torch.equal(got, loop.decode_video(gen, cfg, torch.from_numpy(t)[None])[0])


def _tiny(branch_type="ERB", **over) -> ModelConfig:
    return ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                       lower_width=4, branch_type=branch_type, **over)


@pytest.mark.parametrize("keep_frames", [True, False])
def test_cpu_model_runs_decode_video(keep_frames):
    """On a CPU model the decode is the eager oracle itself, to the bit, and
    nothing is captured."""
    cfg = TrainConfig(model=_tiny())
    gen = Generator(cfg.model, seed=4)
    t = torch.from_numpy(T_BATCHES)
    run = loop.make_video_decode_fn(cfg, keep_frames=keep_frames)
    assert isinstance(run, loop.VideoDecode)
    assert torch.equal(run(gen, t), loop.decode_video(gen, cfg, t, keep_frames=keep_frames))
    assert run.captured.graph is None and run.captured.captures == 0 and run.t is None


@pytest.mark.parametrize("keep_frames", [True, False])
def test_captured_batch_run_eagerly_equals_decode_video(keep_frames):
    """What the card captures (``VideoDecode.step``: row ``k`` of the frame
    times, the checksum written at ``k``, ``k += 1``), run eagerly on CPU
    buffers, gives ``decode_video``'s frames and checksums to the bit."""
    cfg = TrainConfig(model=_tiny())
    gen = Generator(cfg.model, seed=5)
    t = torch.from_numpy(T_BATCHES)
    run = loop.make_video_decode_fn(cfg, keep_frames=keep_frames)
    run._buffers(torch.device("cpu"), 3, 4)
    assert tuple(run.t.shape) == (3, 4) and tuple(run.sums.shape) == (3,)
    run.t.copy_(t)
    run.k.zero_()
    frames = torch.stack([run.step(gen) for _ in range(3)])
    assert run.k.item() == 3
    ref = loop.decode_video(gen, cfg, t)
    assert torch.equal(frames, ref)
    if not keep_frames:
        assert torch.equal(run.sums, loop.decode_video(gen, cfg, t, keep_frames=False))


def test_buffers_grow_and_follow_the_batch():
    """More batches than the buffers hold, or another batch size, makes new
    buffers and drops the graph (it reads the old ones); fewer keeps them."""
    run = loop.make_video_decode_fn(TrainConfig(model=_tiny()), keep_frames=False)
    cpu = torch.device("cpu")
    run._buffers(cpu, 3, 4)
    t0 = run.t
    run.captured.graph = run.captured.key = object()  # stands for a captured graph
    run._buffers(cpu, 2, 4)
    assert run.t is t0 and run.captured.graph is not None
    run._buffers(cpu, 5, 4)
    assert tuple(run.t.shape) == (5, 4)
    assert run.captured.graph is None and run.captured.key is None
    run.captured.graph = object()
    run._buffers(cpu, 1, 2)
    assert tuple(run.t.shape) == (1, 2) and run.captured.graph is None


def _int8_model(seed=6) -> Generator:
    cfg = _tiny(decode_int8=True, int8_from_block=-2)
    dep = generator_to_deploy(Generator(cfg, seed=seed)).eval()
    calib = torch.tensor([0.1, 0.5, 0.9])
    gen8 = calibrate_int8(dep, positional_encoding(calib, cfg.embed))
    assert set(gen8.int8) == {"0", "1"}
    return gen8


def _change(case: str, gen: Generator):
    """Apply ``case`` to ``gen``; returns (the model to key, the batch, keep_frames)."""
    if case == "weight in place":
        with torch.no_grad():
            next(gen.parameters()).add_(0.25)
    elif case == "int8 scale in place":
        with torch.no_grad():
            gen.int8["1"].scale.mul_(2.0)
    elif case == "int8 packed weights in place":
        with torch.no_grad():
            gen.int8["0"].packed.w.neg_()
    elif case == "int8 table replaced":
        entry = gen.int8["1"]
        gen.int8 = {**gen.int8, "1": entry._replace(in_scale=entry.in_scale.clone() * 2)}
    elif case == "int8 tables dropped":
        gen.int8 = {}
    elif case == "train mode":
        gen.train()
    elif case == "config":
        gen.cfg = dataclasses.replace(gen.cfg, compute_dtype="bfloat16")
    elif case == "other model":
        return copy.deepcopy(gen), 4, True
    elif case == "batch":
        return gen, 2, True
    elif case == "keep_frames":
        return gen, 4, False
    return gen, 4, True


@pytest.mark.parametrize("case", [
    "weight in place", "int8 scale in place", "int8 packed weights in place",
    "int8 table replaced", "int8 tables dropped", "train mode", "config", "other model",
    "batch", "keep_frames",
])
def test_graph_key_moves_with_what_the_capture_holds(case):
    gen = _int8_model()
    key = loop.decode_graph_key(gen, 4, True)
    model, b, keep = _change(case, gen)
    assert loop.decode_graph_key(model, b, keep) != key


def test_graph_key_stays_when_nothing_changes():
    """Decoding with a model and keying it again gives the same key, int8
    tables or not."""
    gen = _int8_model()
    key = loop.decode_graph_key(gen, 4, True)
    cfg = TrainConfig(model=gen.cfg)
    loop.make_video_decode_fn(cfg)(gen, torch.from_numpy(T_BATCHES))
    _ = [p.sum() for p in gen.parameters()]
    assert loop.decode_graph_key(gen, 4, True) == key
    plain = generator_to_deploy(Generator(_tiny(), seed=6)).eval()
    pkey = loop.decode_graph_key(plain, 4, True)
    loop.decode_video(plain, TrainConfig(model=plain.cfg), torch.from_numpy(T_BATCHES))
    assert loop.decode_graph_key(plain, 4, True) == pkey


@pytest.fixture
def world_of_one():
    """A gloo world of one on the CPU, closed after the test."""
    assert not dist.is_initialized()
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    yield mesh
    sharding.close_mesh(mesh)
    assert not dist.is_initialized()


def test_sharded_decode_world_of_one_equals_the_plain_decode(world_of_one):
    """Each rank's columns through ``make_video_decode_fn``: over a gloo world
    of one the checksums (summed, or local), the kept frames (gathered, or
    local) and the one-batch decode equal the plain decode's to the bit,
    call after call of one decode function."""
    cfg = TrainConfig(model=_tiny())
    gen = Generator(cfg.model, seed=7).eval()
    t = torch.from_numpy(T_BATCHES)
    sums = loop.make_video_decode_fn(cfg, keep_frames=False)(gen, t)
    frames = loop.make_video_decode_fn(cfg)(gen, t)
    mesh = world_of_one
    summed = sharding.make_sharded_video_decode_fn(cfg, mesh)
    local = sharding.make_sharded_video_decode_fn(cfg, mesh, local=True)
    for _ in range(2):
        assert torch.equal(summed(gen, t), sums)
        assert torch.equal(local(gen, t), sums)
    for keep_local in (True, False):
        got = sharding.make_sharded_video_decode_fn(cfg, mesh, keep_frames=True,
                                                    local=keep_local)(gen, t)
        assert torch.equal(got, frames)
    one = sharding.make_sharded_decode(cfg, mesh)
    for i in range(3):
        assert torch.equal(one(gen, t[i]), loop.make_decode_fn(cfg)(gen, t[i]))


# ---------------------------------------------------------------------------
# On the card: the CUDA graph
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph and the K1 / K2 kernels have no "
                    "CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


# the card's shapes (tests/test_torch_fused_epoch.py's CARD): blocks 2 and 3
# (2304 and 9216 input pixels) take K1, or K2 under int8; blocks 0 and 1 the
# library conv
CARD = ModelConfig(embed="1.25_8", stem_dim_num="64_1", fc_hw_dim="9_16_16",
                   strides=(2, 2, 2, 2), lower_width=16, branch_type="ERB")
CARD_T = (torch.arange(12, dtype=torch.float32) / 12).reshape(3, 4)


def _card_model(kind: str, device) -> Generator:
    cfg = dataclasses.replace(CARD, compute_dtype="bfloat16" if kind == "int8" else kind,
                              decode_int8=kind == "int8")
    gen = generator_to_deploy(Generator(cfg, seed=8, device=device)).eval()
    if kind == "int8":
        calib = torch.arange(4, dtype=torch.float32, device=device) / 4
        gen = calibrate_int8(gen, positional_encoding(calib, cfg.embed))
    return gen


def _k12(counts) -> tuple:
    return (counts["repnerv_tpu_torch.kernels.decode", "LAUNCHES"],
            counts["repnerv_tpu_torch.kernels.decode_int8", "LAUNCHES"])


INT8_OUT = ("repnerv_tpu_torch.kernels.decode", "INT8_OUT_LAUNCHES")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_graph_decode_equals_eager_decode_on_the_card(cuda, kind):
    """Graph frames and checksums equal ``decode_video``'s to the bit, call
    after call of one decode function (one capture); one eager batch and
    then one replay a batch, each counted as the eager batch's launches (2 K1,
    or 2 K2 under int8; no K1 writes int8: block 1 runs the library conv)."""
    gen = _card_model(kind, cuda)
    cfg = TrainConfig(model=gen.cfg)
    t = CARD_T.to(cuda)
    ref = loop.decode_video(gen, cfg, t)
    ref_sums = loop.decode_video(gen, cfg, t, keep_frames=False)
    before = launches.snapshot()
    loop.decode_video(gen, cfg, t[:1])
    per_batch = _k12(launches.since(before))
    assert per_batch == ((0, 2) if kind == "int8" else (2, 0))
    run = loop.make_video_decode_fn(cfg)
    sums = loop.make_video_decode_fn(cfg, keep_frames=False)
    for _ in range(2):
        before = launches.snapshot()
        got = run(gen, t)
        counts = launches.since(before)
        assert _k12(counts) == (3 * per_batch[0], 3 * per_batch[1]) and counts[INT8_OUT] == 0
        assert torch.equal(got, ref)
        assert torch.equal(sums(gen, t), ref_sums)
    assert run.captured.captures == sums.captured.captures == 1
    assert run.captured.counts is not None and _k12(run.captured.counts) == per_batch
    got2 = run(gen, t)
    assert got2.data_ptr() != got.data_ptr()  # new tensors at every call
    one = loop.make_decode_fn(cfg)
    for i in range(3):
        assert torch.equal(one(gen, t[i]), ref[i])


@pytest.mark.gpu
def test_graph_int8_decode_quantises_in_k1_on_the_card(cuda, tmp_path):
    """With the block before the first int8 block on K1's wgmma route, a
    replayed batch runs 1 K1 that writes int8 (``INT8_OUT_LAUNCHES`` 1 a
    batch) and 1 K2, and charges no op to ``int8.quantize_act``; its frames
    equal, to the bit, the eager decode written out with the plain pass
    (``decode_stage``, then ``quantize_act_int8``)."""
    from repnerv_tpu_torch.utils.profiling import trace

    from test_torch_decode_int8 import decode_with_the_plain_pass

    cfg = dataclasses.replace(CARD, compute_dtype="bfloat16", decode_int8=True,
                              int8_from_block=-1)
    gen = generator_to_deploy(Generator(cfg, seed=8, device=cuda)).eval()
    calib = torch.arange(4, dtype=torch.float32, device=cuda) / 4
    gen = calibrate_int8(gen, positional_encoding(calib, cfg.embed))
    assert set(gen.int8) == {"3"}
    t = CARD_T.to(cuda)
    with torch.no_grad():
        want = torch.stack([decode_with_the_plain_pass(gen, positional_encoding(row, cfg.embed))
                            for row in t])
    run = loop.make_video_decode_fn(TrainConfig(model=gen.cfg))
    first = run(gen, t)  # the eager batch, the capture, two replays
    assert run.captured.captures == 1
    assert _k12(run.captured.counts) == (1, 1) and run.captured.counts[INT8_OUT] == 1
    assert not [path for g in run.captured.labels.graphs for path, _, _ in g.ranges
                if "int8.quantize_act" in path]
    before = launches.snapshot()
    with trace(str(tmp_path), cuda) as rec:
        got = run(gen, t)
    counts = launches.since(before)
    assert _k12(counts) == (3, 3) and counts[INT8_OUT] == 3
    assert rec.unattributed == []
    assert not [p for p, st in rec.spans.items() if "int8.quantize_act" in p and st.ops]
    assert torch.equal(first, want) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_graph_decode_recaptures_after_a_change_on_the_card(cuda, kind):
    """A weight changed in place (and, under int8, a table) moves the key:
    the next decode captures again and equals the eager decode of the new
    weights; a longer video or another batch captures again too."""
    gen = _card_model(kind, cuda)
    cfg = TrainConfig(model=gen.cfg)
    t = CARD_T.to(cuda)
    run = loop.make_video_decode_fn(cfg)
    first = run(gen, t)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(1.5)
        if kind == "int8":
            gen.int8["3"].packed.scale.mul_(0.5)  # what K2 reads
    got = run(gen, t)
    assert run.captured.captures == 2
    assert torch.equal(got, loop.decode_video(gen, cfg, t))
    assert not torch.equal(got, first)
    assert torch.equal(run(gen, torch.cat([t, t])), torch.cat([got, got]))
    assert run.captured.captures == 3
    assert torch.equal(run(gen, t.reshape(6, 2)), loop.decode_video(gen, cfg, t.reshape(6, 2)))
    assert run.captured.captures == 4


@pytest.mark.gpu
def test_measure_decode_fps_and_nccl_world_of_one_on_the_card(cuda):
    """``measure_decode_fps`` replays the graph (1 + 3 decodes of 3 batches:
    12 batches' launches); over an NCCL world of one the sharded decode's
    frames and checksums equal the plain graph's to the bit."""
    gen = _card_model("bfloat16", cuda)
    cfg = TrainConfig(model=gen.cfg)
    t = CARD_T.to(cuda)
    before = launches.snapshot()
    fps = loop.measure_decode_fps(gen, cfg, CARD_T.reshape(-1).numpy(), 4)
    assert fps > 0 and _k12(launches.since(before)) == (2 * 12, 0)
    mesh = sharding.make_mesh((1,), ("data",), "cuda")
    try:
        assert torch.equal(sharding.make_sharded_video_decode_fn(cfg, mesh)(gen, t),
                           loop.make_video_decode_fn(cfg, keep_frames=False)(gen, t))
        assert torch.equal(sharding.make_sharded_video_decode_fn(cfg, mesh, keep_frames=True)(
            gen, t), loop.make_video_decode_fn(cfg)(gen, t))
    finally:
        sharding.close_mesh(mesh)
