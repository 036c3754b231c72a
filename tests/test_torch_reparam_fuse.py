"""ERB's branch fusion as the kernels of ``kernels/reparam_fuse.py``.

On the CPU: ``reparam.fuse("ERB", ...)`` still takes the plain path, to the
bit and with autograd's gradients; the kernels' launch descriptors, run in
plain PyTorch (``run_reference``) in f64, give ``fuse_erb_plain``'s K and b
and autograd's nine gradients, for cotangents in any layout and for a
tensor-parallel slice (Oo < Om), and at every ERB block shape of erb-720p
and erb-uvg1080p the JAX package's fusion (``repnerv_tpu/models/reparam.py
::fuse``) and its ``jax.vjp`` on the same weights; the plans' tiles and
splits; the counters' registration; the benchmark's ``step_fusion_vjp_ms``
reader.

On the card (``gpu``): the forward and the VJP at every ERB block shape of
erb-720p and erb-uvg1080p and at a tiny odd shape against the plain algebra
in f64, within twice the plain f32 path's own error; the launches of one
replayed erb720 step (2 + 2 a block) and of a vanilla step (none); the traced
step's ``step.backward/reparam.fuse_vjp`` span, and the fold's spans holding
the fold's kernels and nothing else although they run on a stream of their
own.  On the card the kernels are held to the plain algebra in f64; the
descriptors they run are held to it and to the JAX fusion on the CPU.  Run
them there with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_reparam_fuse.py
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH)]

from harness.spec import Spec  # noqa: E402
from repnerv_tpu_torch.kernels import launches  # noqa: E402
from repnerv_tpu_torch.kernels import reparam_fuse as rf  # noqa: E402
from repnerv_tpu_torch.models import reparam  # noqa: E402
from repnerv_tpu_torch.models.blocks import NeRVBlock  # noqa: E402
from repnerv_tpu_torch.utils import profiling  # noqa: E402
from repnerv_tpu_torch.utils.profiling import SpanTime, Trace  # noqa: E402

# (Oo = Om, I) of each ERB block of the benchmark's configurations (M = 2 I)
CELL_SHAPES = {
    "erb720.b0": (650, 26),
    "erb720.b1": (384, 26),
    "erb720.b2-4": (384, 96),
    "erb1080.b0": (1200, 48),
    "erb1080.b1": (864, 48),
}
STRIDES = {"erb720.b0": 5, "erb720.b1": 2, "erb720.b2-4": 2, "erb1080.b0": 5, "erb1080.b1": 3}
NAMES = ("K", "b", "dw3x3", "db3x3", "dw1x3", "db1x3", "dw3x1", "db3x1", "dw1", "dw2", "dw3")


def _tensors(oo, cin, om=None, dtype=torch.float64, device="cpu", seed=0):
    """ERB's nine branch tensors (erb_fold's order) at torch's default
    init bounds; ``om`` != ``oo``: a tensor-parallel view's Cout slice."""
    om = oo if om is None else om
    m = 2 * cin
    gen = torch.Generator().manual_seed(seed)

    def u(shape, fan_in):
        return ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1)
                * fan_in ** -0.5).to(device=device, dtype=dtype)

    return (u((oo, cin, 3, 3), 9 * cin), u((oo,), 9 * cin), u((oo, cin, 1, 3), 3 * cin),
            u((oo,), 3 * cin), u((oo, cin, 3, 1), 3 * cin), u((oo,), 3 * cin),
            u((m, cin, 1, 1), cin), u((om, m, 3, 3), 9 * m), u((oo, om, 1, 1), om))


class _View:
    """What ``fuse_erb`` reads of a block, over the nine tensors."""

    rbr_reparam = None

    def __init__(self, ts):
        def mod(w, b=None):
            return type("Branch", (), {"weight": w, "bias": b})()

        self.rbr_3x3_branch = mod(ts[0], ts[1])
        self.rbr_1x3_branch = mod(ts[2], ts[3])
        self.rbr_3x1_branch = mod(ts[4], ts[5])
        self.rbr_1x1_3x3_1x1_branch_1x1_1 = mod(ts[6])
        self.rbr_1x1_3x3_1x1_branch_3x3 = mod(ts[7])
        self.rbr_1x1_3x3_1x1_branch_1x1_2 = mod(ts[8])


def _plain_with_grads(ts, dk, db):
    """(K, b, the nine gradients) of ``fuse_erb_plain`` through autograd."""
    ts = tuple(t.detach().requires_grad_(True) for t in ts)
    k, b = reparam.fuse_erb_plain(_View(ts))
    return (k.detach(), b.detach(), *torch.autograd.grad((k, b), ts, (dk, db)))


def _close(got, want, rel=1e-12):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= rel * w.abs().max(), name


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ngf,new_ngf,stride", [(4, 6, 2), (5, 7, 3)])
def test_cpu_erb_fuse_takes_the_plain_path_unchanged(dtype, ngf, new_ngf, stride):
    blk = NeRVBlock(ngf=ngf, new_ngf=new_ngf, stride=stride, branch_type="ERB",
                    generator=torch.Generator().manual_seed(3)).to(dtype)
    ts = reparam.erb_tensors(blk)
    assert not rf.takes(ts)
    before = launches.snapshot()
    k, b = reparam.fuse("ERB", blk)
    k0, b0 = reparam.fuse_erb_plain(blk)
    assert torch.equal(k, k0) and torch.equal(b, b0)
    dk, db = torch.randn_like(k), torch.randn_like(b)
    got = torch.autograd.grad((k, b), ts, (dk, db))
    want = torch.autograd.grad(reparam.fuse_erb_plain(blk), ts, (dk, db))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches.total(launches.since(before)) == 0


def test_takes_only_cuda_f32_erb_tensors():
    ts = _tensors(6, 3, dtype=torch.float32)
    assert not rf.takes(ts)  # CPU
    assert not rf.takes(tuple(t.to("meta") for t in ts))
    assert not rf.takes(ts[:1] + (None,) + ts[2:])  # a bias-free branch


@pytest.mark.parametrize("oo,cin,om", [(6, 3, 6), (37, 5, 37), (21, 4, 48), (65, 26, 65)])
def test_forward_descriptors_give_the_plain_fusion_in_f64(oo, cin, om):
    ts = _tensors(oo, cin, om)
    k, b, t = rf.erb_fold_reference(*ts)
    k0, b0 = reparam.fuse_erb_plain(_View(ts))
    _close((k, b), (k0, b0))
    assert torch.equal(b, (ts[1] + ts[3]) + ts[5])  # the plain path's order of adds
    w1, w2 = ts[6][:, :, 0, 0], ts[7]
    _close((t,), (torch.einsum("omuv,mi->oiuv", w2, w1),))


@pytest.mark.parametrize("layout", ["oihw", "hwio", "strided"])
@pytest.mark.parametrize("oo,cin,om", [(6, 3, 6), (37, 5, 37), (21, 4, 48)])
def test_vjp_descriptors_give_autograds_gradients_in_f64(oo, cin, om, layout):
    ts = _tensors(oo, cin, om, seed=1)
    gen = torch.Generator().manual_seed(2)
    dk = torch.randn(oo, cin, 3, 3, generator=gen, dtype=torch.float64)
    db = torch.randn(oo, generator=gen, dtype=torch.float64)
    want = _plain_with_grads(ts, dk, db)[2:]
    if layout == "hwio":  # the layout a permuted weight's gradient arrives in
        dk = dk.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    elif layout == "strided":  # made contiguous first, as any layout
        dk = torch.zeros(oo, cin, 3, 4, dtype=torch.float64)[..., :3].copy_(dk)
    got = rf.erb_fold_vjp_reference(dk, db, *ts)
    _close(got, want)
    assert all(g.is_contiguous() for g in got)


def test_vjp_shapes_are_the_vjp_launches_problems():
    oo, cin, om = 21, 4, 48
    ts = _tensors(oo, cin, om)
    t = torch.empty(om, cin, 3, 3, dtype=torch.float64)
    grads = tuple(torch.empty_like(x) for x in (*ts, t))
    dk = torch.empty(oo, cin, 3, 3, dtype=torch.float64)
    vjp = rf.vjp_launches(dk, dk[:, 0, 0, 0], *ts[6:], t, grads)
    assert rf.shapes_of(vjp) == rf.vjp_shapes(oo, om, cin, 2 * cin)


def _plan_shapes(oo, cin, om):
    return ((((9 * om, cin, 2 * cin),), ((oo, 9 * cin, om),))
            + rf.vjp_shapes(oo, om, cin, 2 * cin))


def _check_plan(shapes, planned):
    """The first launch never splits, every split is one a plan may choose
    and keeps at least SPLIT_MIN_STEPS k steps a block, and the tickets are
    one a split tile."""
    assert len(planned) == len(shapes) and planned[0][1] == (1,)
    for probs, (tile, splits) in zip(shapes, planned):
        assert tile in rf.TILES and len(splits) == len(probs)
        gs = [rf._blank(*p) for p in probs]
        assert all(s in rf.SPLITS for s in splits)
        assert all(g.steps() >= s * rf.SPLIT_MIN_STEPS for g, s in zip(gs, splits) if s > 1)
        assert rf.tickets_of(probs, tile, splits) == sum(
            g.tiles(tile) for g, s in zip(gs, splits) if s > 1)


@pytest.mark.parametrize("shape", sorted(CELL_SHAPES))
def test_plans_at_the_cells_shapes(shape):
    """At each cell shape: the table's plan, forward alone or with the VJP."""
    o, cin = CELL_SHAPES[shape]
    shapes = _plan_shapes(o, cin, o)
    planned = rf.plan(shapes, rf.DEFAULT_SMS)
    assert planned == rf.PLANS[o, o, cin, 2 * cin]
    _check_plan(shapes, planned)
    assert rf.plan(shapes[:2], rf.DEFAULT_SMS) == planned[:2]


@pytest.mark.parametrize("oo,cin,om", [(6, 3, 6), (37, 5, 37), (192, 96, 384), (900, 40, 900)])
def test_plans_elsewhere(oo, cin, om):
    """Elsewhere the 32 x 64 tile, splits while the card's slots hold the
    tiles: a long k range over few tiles splits, and a launch's blocks stay
    within the slots."""
    shapes = _plan_shapes(oo, cin, om)
    planned = rf.plan(shapes, rf.DEFAULT_SMS)
    _check_plan(shapes, planned)
    for probs, (tile, splits) in zip(shapes, planned):
        assert tile == 2
        for p, s in zip(probs, splits):
            assert rf._blank(*p).tiles(2) * s <= 4 * rf.DEFAULT_SMS or s == 1
    dw1 = rf._blank(*shapes[3][1])  # k = 9 Om over M x I
    if dw1.steps() >= 2 * rf.SPLIT_MIN_STEPS and 2 * dw1.tiles(2) <= 4 * rf.DEFAULT_SMS:
        assert planned[3][1][1] > 1


@pytest.mark.parametrize("shape", sorted(CELL_SHAPES))
def test_descriptors_give_the_jax_fusion_and_its_vjp_at_the_cells_shapes(shape):
    """The JAX package's ERB block at the cell's shape, its weights loaded
    into the port's block: the descriptors' K, b (f64) and their VJP of a
    seeded cotangent against ``jreparam.fuse("ERB", ...)`` and its
    ``jax.vjp`` (f32), within 1e-5 of each output's largest value (an
    index wrong anywhere misses by its whole size)."""
    import jax
    import numpy as np

    from repnerv_tpu.models import reparam as jreparam
    from repnerv_tpu.models.blocks import init_block
    from repnerv_tpu_torch.train.checkpoint import state_from_jax_params
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_model_cfg

    o, cin = CELL_SHAPES[shape]
    s = STRIDES[shape]
    params = init_block(jax.random.PRNGKey(6), ngf=cin, new_ngf=o // s**2, stride=s,
                        branch_type="ERB")
    cfg = port_model_cfg(tiny_model(branch_type="ERB"))

    def state_of(tree):
        full = {"stem": [], "blocks": [jax.tree.map(np.asarray, tree)], "heads": []}
        return {k.split(".", 2)[2]: torch.from_numpy(np.array(v))
                for k, v in state_from_jax_params(full, cfg).items()}

    blk = NeRVBlock(ngf=cin, new_ngf=o // s**2, stride=s, branch_type="ERB",
                    generator=torch.Generator())
    blk.load_state_dict(state_of(params), strict=True)
    names = {id(p): n for n, p in blk.named_parameters()}
    order = [names[id(t)] for t in reparam.erb_tensors(blk)]
    ts = tuple(t.detach().double() for t in reparam.erb_tensors(blk))

    rng = np.random.default_rng(7)
    dk_hwio = rng.standard_normal((3, 3, cin, o)).astype(np.float32)
    db = rng.standard_normal(o).astype(np.float32)
    (k_ref, b_ref), vjp = jax.vjp(lambda p: jreparam.fuse("ERB", p), params)
    grads = state_of(vjp((dk_hwio, db))[0])
    want = (torch.from_numpy(np.array(k_ref).transpose(3, 2, 0, 1)),
            torch.from_numpy(np.array(b_ref)), *[grads[n] for n in order])

    k, b, _ = rf.erb_fold_reference(*ts)
    got = (k, b, *rf.erb_fold_vjp_reference(
        torch.from_numpy(dk_hwio.transpose(3, 2, 0, 1)).double(),
        torch.from_numpy(db).double(), *ts))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert (g - w.double()).abs().max() <= 1e-5 * w.abs().max(), name


def test_the_counters_are_registered():
    keys = launches.snapshot()
    for name in ("FWD_LAUNCHES", "VJP_LAUNCHES"):
        assert (rf.__name__, name) in keys


def _reader_trace(unattributed=()):
    replay = "bench.slice/graph.replay:step.3"
    return Trace(profiler=None, unattributed=list(unattributed), spans={
        "bench.slice": SpanTime(1, 1.0, 0.1, 0.001),
        f"{replay}/step.backward": SpanTime(4, device_s=0.008),
        f"{replay}/step.backward/reparam.fuse_vjp": SpanTime(20, device_s=0.0004),
        f"{replay}/step.forward/reparam.fuse": SpanTime(20, device_s=0.002)})


def test_the_benchmarks_vjp_reader(monkeypatch):
    """``step_fusion_vjp_ms``: the span's device ms a step in a train cell,
    None in a decode cell, without the span (the parent program), with an
    unattributed graph, and for a program without spans."""
    read = Spec().reader("step_fusion_vjp_ms")
    train, decode = {"kind": "train", "steps": 4}, {"kind": "decode", "batches": 5}
    monkeypatch.setattr(profiling, "_LAST", _reader_trace())
    assert read(train) == pytest.approx(0.1) and read(decode) is None
    assert Spec().reader("step_fusion_ms")(train) == pytest.approx(0.5)  # the forward alone
    monkeypatch.setattr(profiling, "_LAST", _reader_trace(["step.3"]))
    assert read(train) is None
    monkeypatch.setattr(profiling, "_LAST", Trace(profiler=None, spans={
        "bench.slice": SpanTime(1, 1.0, 1.0, 0.004)}))
    assert read(train) is None
    monkeypatch.delattr(profiling, "last_trace")
    assert read(train) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _errors(got, ref):
    return [float((g.double() - r).abs().max()) for g, r in zip(got, ref)]


@pytest.mark.gpu
@pytest.mark.parametrize("oo,cin,om", [*[(o, i, o) for o, i in CELL_SHAPES.values()],
                                       (37, 5, 37), (96, 96, 384)])
def test_cuda_fold_and_vjp_within_twice_the_plain_f32_error(cuda, oo, cin, om):
    """K, b and the nine gradients against the plain algebra in f64: no
    value's error above twice the plain f32 path's (cuBLAS, TF32 off) own
    largest error; two launches each way; the same bits every call."""
    ts64 = _tensors(oo, cin, om, device=cuda, seed=4)
    gen = torch.Generator().manual_seed(5)
    dk64 = torch.randn(oo, cin, 3, 3, generator=gen, dtype=torch.float64).to(cuda)
    db64 = torch.randn(oo, generator=gen, dtype=torch.float64).to(cuda)
    ref = _plain_with_grads(ts64, dk64, db64)
    ts = tuple(t.float() for t in ts64)
    dk, db = dk64.float(), db64.float()
    assert rf.takes(ts)
    plain = _errors(_plain_with_grads(ts, dk, db), ref)
    before = launches.snapshot()
    leaves = tuple(t.detach().requires_grad_(True) for t in ts)
    k, b = reparam.fuse_erb(_View(leaves))
    got = (k.detach(), b.detach(), *torch.autograd.grad((k, b), leaves, (dk, db)))
    torch.cuda.synchronize()
    counts = launches.since(before)
    assert (counts[rf.__name__, "FWD_LAUNCHES"], counts[rf.__name__, "VJP_LAUNCHES"]) == (2, 2)
    for name, e, p in zip(NAMES, _errors(got, ref), plain):
        assert e <= 2 * p, (name, e, p)
    k2, b2 = rf.erb_fold(*leaves)
    got2 = torch.autograd.grad((k2, b2), leaves, (dk, db))
    assert torch.equal(k2, k) and all(torch.equal(x, y) for x, y in zip(got2, got[2:]))


def _flagship_cfg(branch_type):
    from repnerv_tpu_torch.cli.args import args_to_config, build_parser

    argv = ("--dataset synth --synthetic_frames 4 --synthetic_hw 720 1280 --embed 1.25_40 "
            "--stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 --reduction 2 "
            "--num_blocks 1 --strides 5 2 2 2 2 --lower_width 96 --norm none --conv_type conv "
            "--act swish --single_res --loss Fusion6 -b 1 --lr 0.0005 --warmup 0.2 "
            "--lr_type cosine -e 300 --compute_dtype bfloat16 --branch_type "
            f"{branch_type}").split()
    return args_to_config(build_parser(eval_mode=False).parse_args(argv), eval_mode=False)


def _graph_step(branch_type, device):
    from repnerv_tpu_torch.data.frames import synthetic_video
    from repnerv_tpu_torch.train import loop

    cfg = _flagship_cfg(branch_type)
    video, t = synthetic_video(1, 720, 1280, seed=3)
    frames, t = torch.from_numpy(video).to(device), torch.from_numpy(t).to(device)
    state = loop.init_train_state(cfg, device, seed=0)
    step = loop.make_train_step(cfg, 2, with_msssim=True)
    step(state, frames, t)  # eager on a side stream, then the capture
    return step, state, frames, t


@pytest.mark.gpu
@pytest.mark.parametrize("branch_type,per_step", [("ERB", 5 * 2), ("NeRV_vanilla", 0)])
def test_cuda_replayed_step_counts_the_fusions_launches(cuda, branch_type, per_step):
    """One replay of the erb720 graph step: each of the 5 ERB blocks' fusion
    launches twice forward and twice in its VJP; the vanilla step none."""
    step, state, frames, t = _graph_step(branch_type, cuda)
    before = launches.snapshot()
    step(state, frames, t)
    torch.cuda.synchronize()
    counts = launches.since(before)
    assert step.captures == 1
    assert counts[rf.__name__, "FWD_LAUNCHES"] == per_step
    assert counts[rf.__name__, "VJP_LAUNCHES"] == per_step


@pytest.mark.gpu
def test_cuda_traced_step_shows_the_fusions_vjp_span(cuda, tmp_path):
    """The traced replay of the erb720 step charges the 5 VJPs to
    ``step.backward/reparam.fuse_vjp`` and the 5 forward fusions to
    ``reparam.fuse`` inside ``step.forward`` (block 0's directly, blocks
    1-4's inside their stage's span): 10 launches each, the fold's kernels
    alone, whose device time by kernel name the two spans hold to the last
    bit although the fold's stream runs beside the rest of the step."""
    from repnerv_tpu_torch.utils.profiling import kernel_events, trace

    step, state, frames, t = _graph_step("ERB", cuda)
    with trace(str(tmp_path), "cuda") as rec:
        step(state, frames, t)
    assert rec.unattributed == []
    vjp = [(p, s) for p, s in rec.spans.items() if p.endswith("step.backward/reparam.fuse_vjp")]
    assert len(vjp) == 1 and vjp[0][1].count == 5 and vjp[0][1].ops == 5 * 2
    assert vjp[0][1].device_s > 0
    fwd = [(p, s) for p, s in rec.spans.items() if p.endswith("reparam.fuse")]
    assert all("/step.forward/" in p for p, _ in fwd)
    assert sum(s.count for _, s in fwd) == 5 and sum(s.ops for _, s in fwd) == 5 * 2
    (path,) = list(tmp_path.glob("**/*.pt.trace.json"))
    assert sum(n for name, n in kernel_events(str(path)).items() if rf.KERNEL in name) == 20
    events = profiling._read_events(str(path))
    fold_s = sum(float(e["dur"]) for e in events if e.get("cat") == "kernel"
                 and rf.KERNEL in e.get("name", "")) / 1e6
    assert sum(s.device_s for _, s in fwd) + vjp[0][1].device_s == pytest.approx(fold_s, rel=1e-9)
