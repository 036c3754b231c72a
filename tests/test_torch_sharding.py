"""The port's data-parallel training and decode over torch.distributed
(repnerv_tpu_torch/parallel/sharding.py, the --mesh_shape wiring of the
train, decode and eval CLIs) on the CPU.

* ``make_mesh``, ``process_local_slice`` / ``local_batch`` and torchrun's
  variables, with ``init_process_group`` monkeypatched where a world of more
  than one would be needed.
* Two gloo processes (``tests/_torch_dist_child.py``, joined through a
  ``file://`` store in ``tmp_path``: no port to race for; they import no JAX
  and pin ``OMP_NUM_THREADS=1``), each at a local batch of 1, against one
  process at the global batch of 2 and against the JAX package's
  ``make_sharded_train_step`` over a 2-device mesh from the same weights:
  per-step loss atol 1e-5, PSNR atol 1e-3 dB, final weights within 1e-4 of
  each tensor's largest |value| (the bounds of
  tests/test_torch_fused_epoch.py); the ranks' weights equal to the bit.
  The same world runs the sharded fused epoch, an indivisible batch (equal
  bits with one process at -b 1), ``shard_train_state``, the sharded decode
  and ``train_main --mesh_shape 2`` (only rank 0 writes).
* A world of one (gloo, in this process) equals the plain path to the bit:
  ``train_main --mesh_shape 1`` and ``decode_main --mesh_shape 1``.
* The refusals: unknown axis names, more ranks than torchrun started.  A
  ``model`` axis and ``--norm bn`` over more than one rank, refused until
  they were ported, now lay out and run in the two-rank world (held to JAX
  in tests/test_torch_tensor_parallel.py).

The ``gpu`` test (an NCCL world of one equals the plain step to the bit on
the card) skips here and runs on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sharding.py
"""

import dataclasses
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repnerv_tpu_torch.cli import decode_main, suite_main, train_main
from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import FrameStore, synthetic_video
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.parallel import sharding
from repnerv_tpu_torch.train import checkpoint as ckpt
from repnerv_tpu_torch.train import loop

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_child.py")
CHILD_TIMEOUT = 240  # seconds for the whole two-rank run
# the parallel suite (cli/suite_main.py) over two ranks: a video each
SUITE_ARGV = (
    "--dataset synth --synthetic_frames 8 --synthetic_hw 8 8 --embed 1.25_8 --stem_dim_num 16_1 "
    "--fc_hw_dim 2_2_4 --expansion 1 --strides 2 2 --lower_width 4 -b 4 --lr 5e-3 --loss L2 "
    "--act swish --single_res --branch_type ERB --quant_bit 8 --save_bitstream -e 3 "
    "--n_videos 2 --suite_mode parallel --suite_out suite.json --outf suite --device cpu"
).split()
# the train CLI over two ranks in rows refused until ROADMAP A11 / A13 were
# ported: (flags, batch)
PORTED_ROWS = [(["--mesh_shape", "1", "2", "--mesh_axes", "data", "model"], "1"),
               (["--mesh_shape", "2", "--norm", "bn"], "2")]
TRAIN_ARGV = (
    "--dataset synth --synthetic_frames 4 --synthetic_hw 24 32 --embed 1.25_4 "
    "--stem_dim_num 16_1 --fc_hw_dim 3_4_6 --expansion 1 --strides 2 2 2 "
    "--lower_width 4 --branch_type ERB --act swish --single_res --loss Fusion6 "
    "--lr 5e-3 -e 2 --device cpu"
).split()


def _mesh(rank=0, world=2) -> sharding.Mesh:
    return sharding.Mesh((world,), ("data",), rank, world, torch.device("cpu"))


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _close(a: dict, b: dict, rel=1e-4):
    for k, v in b.items():
        scale = max(float(v.abs().max()), 1e-30)
        assert float((a[k] - v).abs().max()) <= rel * scale, k


@pytest.fixture
def no_world():
    """No process group before or after the test."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh, the slices, torchrun's variables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), ()])
def test_make_mesh_world_of_one(no_world, shape):
    """--mesh_shape 1 (or no shape) without torchrun: a world of one in this
    process, which close_mesh ends."""
    mesh = sharding.make_mesh(shape, ("data",), "cpu")
    assert (mesh.shape, mesh.axis_names, mesh.rank, mesh.world_size) == ((1,), ("data",), 0, 1)
    assert mesh.device == torch.device("cpu") and mesh.owns_group and mesh.data_size == 1
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    sharding.close_mesh(mesh)
    assert not dist.is_initialized()


def test_make_sharded_train_state_is_the_seeds_state_on_every_rank(no_world):
    cfg = TrainConfig(model=ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6",
                                        strides=(2, 2), lower_width=4, branch_type="ERB"))
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    try:
        state = sharding.make_sharded_train_state(cfg, mesh)
    finally:
        sharding.close_mesh(mesh)
    ref = loop.init_train_state(cfg, "cpu")
    assert state.step == 0
    for k, v in _weights(ref.model).items():
        assert torch.equal(state.model.state_dict()[k], v), k


@pytest.mark.parametrize("shape,axes,match", [
    ((2,), ("data",), "torchrun --nproc_per_node 2"),
    ((1, 2), ("data", "model"), None),
    ((2,), ("model",), None),
    ((1,), ("pipe",), "'data'"),
    ((1, 1), ("data",), "axis names"),
])
def test_make_mesh_refuses(request, no_world, shape, axes, match):
    """What make_mesh refuses; a model axis (``match`` None) it lays out: in
    the two-rank world each rank gets its coordinate (rank = d * M + m), the
    model axis's size, and groups of the right sizes."""
    if match is None:
        meshes = [o["mesh"][shape, axes] for o in request.getfixturevalue("world2")["outs"]]
        assert [m["model_index"] for m in meshes] == [0, 1]
        for m in meshes:
            assert (m["shape"], m["axis_names"], m["world_size"]) == (shape, axes, 2)
            assert (m["model_size"], m["data_size"], m["data_index"]) == (2, 1, 0)
            assert (m["model_group"], m["data_group"]) == (2, 1)
        return
    with pytest.raises(ValueError, match=match):
        sharding.make_mesh(shape, axes, "cpu")
    assert not dist.is_initialized()


def test_make_mesh_needs_no_more_ranks_than_the_world(no_world):
    """As the JAX package's make_mesh: a mesh of more devices than there are
    raises."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        sharding.make_mesh((2,), ("data",), "cpu")


@pytest.mark.parametrize("global_n,world,want", [
    (4, 2, [slice(0, 2), slice(2, 4)]),
    (6, 3, [slice(0, 2), slice(2, 4), slice(4, 6)]),
    (2, 2, [slice(0, 1), slice(1, 2)]),
])
def test_process_local_slice_each_rank(global_n, world, want):
    """Rank r of W owns rows [r n/W, (r+1) n/W), the JAX package's
    process_local_slice; local_batch and shard_batch take the same rows."""
    frames = torch.arange(global_n).reshape(global_n, 1, 1, 1).float()
    t = torch.arange(global_n).float()
    for rank in range(world):
        mesh = _mesh(rank, world)
        assert sharding.process_local_slice(global_n, mesh) == want[rank]
        assert sharding.local_batch(global_n, mesh) == want[rank]
        f, tt = sharding.shard_batch(frames, t, mesh)
        assert tt.tolist() == list(range(global_n))[want[rank]]
        assert f.shape[0] == global_n // world


@pytest.mark.parametrize("global_n,world", [(1, 2), (3, 2), (4, 3)])
def test_indivisible_batch_goes_whole_to_every_rank(global_n, world):
    """JAX's single-process rule (sharding.py:166-176): an indivisible global
    batch replicates, every rank computing the whole of it."""
    for rank in range(world):
        assert sharding.local_batch(global_n, _mesh(rank, world)) == slice(0, global_n)
    assert sharding.batch_spec(_mesh()) == ("data",)


def test_torchrun_env_starts_the_group(monkeypatch):
    """RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE -> init_process_group
    over env:// with a timeout; gloo on the CPU, NCCL for one card a rank,
    gloo where ranks share a card."""
    assert sharding.torchrun_env({}) is None
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}
    assert sharding.torchrun_env(env) == {"rank": 3, "world_size": 4, "local_rank": 1,
                                          "local_world_size": 2}
    assert sharding.torchrun_env({"RANK": "0", "WORLD_SIZE": "2"})["local_rank"] == 0
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    assert sharding.maybe_initialize_distributed("cpu", timeout=timedelta(seconds=9))
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw == {"init_method": "env://", "rank": 3, "world_size": 4,
                  "timeout": timedelta(seconds=9)}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharding.backend_for(torch.device("cuda", 1), 2) == "nccl"
    assert sharding.backend_for(torch.device("cuda", 0), 3) == "gloo"
    assert sharding.backend_for(torch.device("cpu"), 1) == "gloo"


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------


def _run_ranks(tmp_path, spec: dict, world: int = 2) -> list:
    spec_path = tmp_path / "spec.pt"
    torch.save(spec, spec_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), str(world), str(tmp_path / "init"), str(spec_path),
         str(tmp_path / f"out{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _setup():
    """The JAX config and weights of tests/test_torch_fused_epoch.py (tiny
    ERB, Fusion6, 12 x 16 frames), at a global batch of 2."""
    from test_torch_fused_epoch import _jax_setup

    tcfg, ptcfg, params, start = _jax_setup(2, "batch")
    video, t_all = synthetic_video(4, 12, 16, seed=2)
    rows = np.asarray([[0, 1], [2, 3]])
    frames = torch.from_numpy(video[rows].astype(np.float32) / 255.0)
    t = torch.from_numpy(t_all[rows].astype(np.float32))
    return tcfg, ptcfg, params, start, video, t_all, frames, t


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One two-rank run of every job, and what the parent computes alone."""
    tmp = tmp_path_factory.mktemp("world2")
    tcfg, ptcfg, params, start, video, t_all, frames, t = _setup()
    cli_dirs = [tmp / "rank0", tmp / "rank1"]
    for d in cli_dirs:
        d.mkdir()
    spec = {
        "jobs": ["step", "psnr", "indivisible", "epoch", "replicate", "decode", "train_cli",
                 "suite", "mesh"],
        "meshes": [((1, 2), ("data", "model")), ((2,), ("model",))],
        "cfg": ptcfg,
        "cfg_b1": dataclasses.replace(ptcfg, data=dataclasses.replace(ptcfg.data, batch_size=1)),
        "start": start, "frames": frames, "t": t,
        # a white second frame: the two ranks' MSEs differ
        "psnr_frames": torch.stack([frames[0, 0], torch.ones_like(frames[0, 0])])[None],
        "psnr_t": t[:1],
        "video": torch.from_numpy(video), "t_all": t_all,
        "decode_t": torch.tensor([[0.0, 0.25], [0.5, 0.75]]),
        "cli_dirs": [str(d) for d in cli_dirs],
        "cli_argvs": [TRAIN_ARGV + ["--mesh_shape", "2", "-b", "2", "--outf", "b2"],
                      TRAIN_ARGV + ["--mesh_shape", "2", "-b", "1", "--outf", "b1"]]
        + [TRAIN_ARGV + ["-b", b] + extra + ["--outf", f"ported{i}"]
           for i, (extra, b) in enumerate(PORTED_ROWS)],
        "suite_argv": SUITE_ARGV,
    }
    outs = _run_ranks(tmp, spec)
    return {"outs": outs, "tcfg": tcfg, "ptcfg": ptcfg, "params": params, "start": start,
            "video": video, "t_all": t_all, "frames": frames, "t": t, "tmp": tmp,
            "cli_dirs": cli_dirs}


def _plain_steps(ptcfg, start, frames, t):
    """One process, the plain step, the global batch."""
    model = ckpt.load_state(Generator(ptcfg.model), start).train()
    state = loop.TrainState(model, loop.make_optimizer(ptcfg, model), 0)
    step = loop.make_train_step(ptcfg, len(frames), with_msssim=False)
    losses, psnrs = [], []
    for f, tt in zip(frames, t):
        state, aux = step(state, f, tt)
        losses.append(float(aux["loss"]))
        psnrs.append(aux["psnr"].tolist())
    return losses, psnrs, _weights(state.model)


@pytest.mark.parametrize("job", ["step", "indivisible", "epoch"])
def test_ranks_weights_equal_to_the_bit(world2, job):
    """Every rank gets the same reduced bucket and Adam is deterministic."""
    a, b = (o[job]["weights"] for o in world2["outs"])
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def test_two_gloo_ranks_equal_one_process_at_the_global_batch(world2):
    losses, psnrs, w = _plain_steps(world2["ptcfg"], world2["start"], world2["frames"],
                                    world2["t"])
    for out in world2["outs"]:
        got = out["step"]
        np.testing.assert_allclose(got["loss"], losses, atol=1e-5)
        np.testing.assert_allclose(got["psnr"], psnrs, atol=1e-3)
        _close(got["weights"], w)


def test_two_gloo_ranks_equal_jax_sharded_train_step(world2):
    """JAX's make_sharded_train_step over a 2-device "data" mesh (the plain
    XLA path: _gspmd_safe_cfg) from the same weights and batches."""
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.parallel.sharding import make_mesh, make_sharded_train_step
    from repnerv_tpu.train import loop as jloop

    tcfg, params = world2["tcfg"], world2["params"]
    state = jloop.TrainState(params, jloop.make_optimizer(tcfg).init(params),
                             jnp.asarray(0, jnp.int32))
    step = make_sharded_train_step(tcfg, 2, make_mesh((2,), ("data",)))
    losses, psnrs = [], []
    for f, tt in zip(world2["frames"].numpy(), world2["t"].numpy()):
        state, aux = step(state, jnp.asarray(f), jnp.asarray(tt))
        losses.append(float(aux["loss"]))
        psnrs.append(float(np.asarray(aux["psnr"]).reshape(-1)[-1]))
    ref = ckpt.state_from_jax_params(jax.tree.map(np.asarray, state.params),
                                     world2["ptcfg"].model)
    for out in world2["outs"]:
        got = out["step"]
        np.testing.assert_allclose(got["loss"], losses, atol=1e-5)
        np.testing.assert_allclose([p[-1] for p in got["psnr"]], psnrs, atol=1e-3)
        _close(got["weights"], {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()})


def test_global_psnr_comes_from_the_all_reduced_mse(world2):
    """Two ranks whose frames give different MSEs: the step's PSNR is
    -10 log10 of their mean MSE (the global batch's), on both ranks, and not
    the mean of their PSNRs."""
    from repnerv_tpu_torch.data.frames import adaptive_avg_pool
    from repnerv_tpu_torch.models.embedding import positional_encoding

    ptcfg, start = world2["ptcfg"], world2["start"]
    model = ckpt.load_state(Generator(ptcfg.model), start).train()
    f = torch.stack([world2["frames"][0, 0], torch.ones_like(world2["frames"][0, 0])])
    tt = world2["t"][0]
    with torch.no_grad():
        out = model(positional_encoding(tt, ptcfg.model.embed))[-1]
    mse = ((out - adaptive_avg_pool(f, out.shape[1:3])) ** 2).mean(dim=(1, 2, 3)).double()
    assert abs(float(mse[0] - mse[1])) > 0.1 * float(mse.max())
    want = float(-10 * torch.log10(mse.mean()))
    mean_of_psnrs = float((-10 * torch.log10(mse)).mean())
    assert abs(want - mean_of_psnrs) > 1e-2
    for o in world2["outs"]:
        assert o["psnr"]["psnr"][0][-1] == pytest.approx(want, abs=1e-4)


def test_indivisible_batch_equals_one_process_at_b1(world2):
    """A global batch of 1 on two ranks: each rank takes it whole, SUM / 2 of
    two equal gradients is exact, and the run is the single-rank one."""
    c1 = dataclasses.replace(world2["ptcfg"], data=DataConfig(batch_size=1))
    losses, psnrs, w = _plain_steps(c1, world2["start"], world2["frames"][:, :1],
                                    world2["t"][:, :1])
    for out in world2["outs"]:
        got = out["indivisible"]
        assert got["loss"] == losses
        for k, v in w.items():
            assert torch.equal(got["weights"][k], v), k


def test_sharded_fused_epoch_equals_one_process(world2):
    """make_sharded_epoch_fn under run_fused_epoch (each rank a column of
    the epoch's global batch matrix) against one process's fused epoch at
    b = 2, 2 epochs."""
    ptcfg = world2["ptcfg"]
    store = FrameStore(frames=torch.from_numpy(world2["video"]), t=world2["t_all"])
    model = ckpt.load_state(Generator(ptcfg.model), world2["start"]).train()
    state = loop.TrainState(model, loop.make_optimizer(ptcfg, model), 0)
    fn = loop.make_epoch_fn(ptcfg, 2, with_msssim=False)
    hist = []
    for epoch in range(2):
        state, m = loop.run_fused_epoch(state, fn, store, ptcfg, epoch)
        hist.append((m.loss, m.psnr.tolist(), m.lr))
    for out in world2["outs"]:
        got = out["epoch"]
        for (l1, p1, lr1), (l2, p2, lr2) in zip(got["history"], hist):
            assert l1 == pytest.approx(l2, abs=1e-5)
            np.testing.assert_allclose(p1, p2, atol=1e-3)
            assert lr1 == lr2
        _close(got["weights"], _weights(state.model))


def test_shard_train_state_lays_out_rank0s_state(world2):
    """Ranks that start from other weights and step counts end with rank
    0's (the resumed or --weight state of the train CLI)."""
    ref = loop.init_train_state(world2["ptcfg"], "cpu", seed=100)
    for out in world2["outs"]:
        assert out["replicate"]["step"] == 7
        for k, v in _weights(ref.model).items():
            assert torch.equal(out["replicate"]["weights"][k], v), k


def test_decode_over_two_ranks_equals_single_decode(world2):
    ptcfg = world2["ptcfg"]
    model = ckpt.load_state(Generator(ptcfg.model), world2["start"]).eval()
    t_b = torch.tensor([[0.0, 0.25], [0.5, 0.75]])
    frames = loop.decode_video(model, ptcfg, t_b, keep_frames=True)
    sums = loop.decode_video(model, ptcfg, t_b, keep_frames=False)
    for out in world2["outs"]:
        got = out["decode"]
        assert got["frames"].shape == frames.shape
        torch.testing.assert_close(got["frames"], frames, atol=1e-6, rtol=0)
        torch.testing.assert_close(got["one_batch"], frames[0], atol=1e-6, rtol=0)
        torch.testing.assert_close(got["checksums"], sums, rtol=1e-6, atol=0)


def test_timed_decode_reduces_checksums_and_times_after_its_loop(world2):
    """The checksum path of a timed decode over two ranks (C23): each rank
    keeps its own columns' checksums (``local=True``, no collective), and
    ``reduce_decode_reps`` sums them over the ranks once, after the reps, to
    ``decode_video``'s checksums, and takes each rep's time as the slowest
    rank's."""
    ptcfg = world2["ptcfg"]
    model = ckpt.load_state(Generator(ptcfg.model), world2["start"]).eval()
    t_b = torch.tensor([[0.0, 0.25], [0.5, 0.75]])
    for out in world2["outs"]:
        r = out["rank"]
        mine = loop.decode_video(model, ptcfg, t_b[:, r : r + 1], keep_frames=False)
        torch.testing.assert_close(out["decode"]["local"], mine, rtol=1e-6, atol=0)
        times, sums = out["decode"]["reduced"]
        assert times == [2.0, 2.0]
        for row in sums:
            torch.testing.assert_close(row, out["decode"]["checksums"], rtol=1e-6, atol=0)


def _rank0_epochs(path):
    lines = [ln for ln in open(path).read().splitlines() if "Epoch[" in ln]
    return [float(ln.split("PSNR: ")[1].split()[0].split(",")[-1]) for ln in lines]


@pytest.mark.parametrize("i,batch", [(0, "2"), (1, "1")])
def test_train_cli_mesh_shape_2_over_two_gloo_processes(world2, tmp_path, monkeypatch, i, batch):
    """train_main --mesh_shape 2 --device cpu on two gloo ranks against one
    process at the global batch: -b 2 through the sharded fused epoch, -b 1
    (indivisible: JAX's WARNING, then the per-step path, every rank the whole
    batch).  Only rank 0 writes: rank 1's directory stays empty."""
    monkeypatch.chdir(tmp_path)
    single = train_main.main(TRAIN_ARGV + ["-b", batch, "--outf", "single"])["history"]
    hists = [o["train_cli"][i] for o in world2["outs"]]
    assert hists[0] == hists[1]
    for got, ref in zip(hists[0], single):
        assert got["epoch"] == ref["epoch"]
        assert got["loss"] == pytest.approx(ref["loss"], abs=1e-5)
        np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-3)
        if batch == "1":
            assert got == ref  # two equal gradients, SUM / 2 exact
    outf = world2["cli_dirs"][0] / "result" / f"b{batch}"
    for name in ("rank0.txt", "model_latest.pth", "model_latest_deploy.pth", ckpt.RESUME_FILE):
        assert (outf / name).exists(), name
    assert not (world2["cli_dirs"][1] / "result" / f"b{batch}").exists()
    log = (outf / "rank0.txt").read_text()
    assert ("WARNING: batch_size 1 is not divisible by the mesh data axis (2)" in log) == (
        batch == "1")
    np.testing.assert_allclose(_rank0_epochs(outf / "rank0.txt"),
                               _rank0_epochs(tmp_path / "result" / "single" / "rank0.txt"),
                               atol=0.01 + 1e-3)


def test_parallel_suite_over_two_ranks_equals_one_rank(world2, tmp_path, monkeypatch):
    """suite_main --suite_mode parallel on two gloo ranks, a video each: the
    table (rank 0 writes it) equals one process fitting both videos, row for
    row; each rank wrote the .rnvb of its own video."""
    monkeypatch.chdir(tmp_path)
    one = suite_main.main(SUITE_ARGV)
    tables = [o["suite"] for o in world2["outs"]]
    for t in tables:
        assert t["videos"] == one["videos"] and t["mode"] == "parallel"
    rank0, rank1 = world2["cli_dirs"]
    assert (rank0 / "suite.json").exists() and not (rank1 / "suite.json").exists()
    assert (rank0 / "result" / "suite" / "bitstreams" / "video0_q8.rnvb").exists()
    assert (rank1 / "result" / "suite" / "bitstreams" / "video1_q8.rnvb").exists()


# ---------------------------------------------------------------------------
# A world of one, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [False, True])
def test_train_cli_world_of_one_equals_the_plain_run(no_world, tmp_path, monkeypatch, host):
    """--mesh_shape 1 through a gloo world of one, whose all-reduce sums one
    rank and divides by 1: the history and weights equal the run without
    the flag to the bit.  The video on the device takes the sharded fused
    epoch; a video in host memory (``cache_device`` off) the sharded
    per-step path, with JAX's WARNING (without the flag: the streaming
    epoch)."""
    if host:
        real = train_main.make_frame_store
        monkeypatch.setattr(train_main, "make_frame_store", lambda data, device, split: real(
            dataclasses.replace(data, cache_device=False), device, split=split))
    monkeypatch.chdir(tmp_path)
    argv = TRAIN_ARGV + ["-b", "2"]
    plain = train_main.main(argv + ["--outf", "plain"])
    mesh1 = train_main.main(argv + ["--outf", "mesh", "--mesh_shape", "1"])
    assert mesh1["history"] == plain["history"]
    for k, v in _weights(plain["state"].model).items():
        assert torch.equal(mesh1["state"].model.state_dict()[k], v), k
    log = open(os.path.join(mesh1["outf"], "rank0.txt")).read()
    assert ("WARNING: video is host-resident" in log) == host
    assert not dist.is_initialized()


def test_decode_main_world_of_one_equals_the_plain_decode(no_world, tmp_path, capsys):
    """decode_main --mesh_shape 1 --out: the same PNGs as without the flag,
    the batch rounded to the data axis."""
    from PIL import Image

    from repnerv_tpu_torch.compress.bitstream import write_bitstream

    cfg = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                      lower_width=4, branch_type="ERB")
    path = str(tmp_path / "m.rnvb")
    gen = Generator(cfg, seed=3)
    write_bitstream(path, {k: v.detach().numpy() for k, v in gen.state_dict().items()}, cfg, 8)
    base = [path, "--frames", "5", "--batch", "2", "--device", "cpu"]
    a = decode_main.main(base + ["--out", str(tmp_path / "a")])
    b = decode_main.main(base + ["--out", str(tmp_path / "b"), "--mesh_shape", "1"])
    assert a["batch"] == b["batch"] == 2
    assert "decoding over a {'data': 1} mesh, batch 2" in capsys.readouterr().out
    for i in range(5):
        pa = np.asarray(Image.open(tmp_path / "a" / f"pred_{i}.png"))
        pb = np.asarray(Image.open(tmp_path / "b" / f"pred_{i}.png"))
        np.testing.assert_array_equal(pa, pb)
    assert not dist.is_initialized()


def test_timed_decode_world_of_one_equals_decode_video(no_world):
    """``measure_decode_fps``'s path over a gloo world of one (C23): the
    local checksums of three reps, reduced once after them, equal
    ``decode_video``'s checksums to the bit, and so do those of the sharded
    decode with its collective; the kept frames, local or gathered, equal
    ``decode_video``'s frames; the reps' times come back as they went."""
    cfg = TrainConfig(model=ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6",
                                        strides=(2, 2), lower_width=4, branch_type="ERB"))
    model = Generator(cfg.model, seed=3).eval()
    t_b = torch.tensor([[0.0, 0.2], [0.4, 0.6], [0.8, 1.0]])
    sums = loop.decode_video(model, cfg, t_b, keep_frames=False)
    frames = loop.decode_video(model, cfg, t_b)
    mesh = sharding.make_mesh((1,), ("data",), "cpu")
    try:
        local = sharding.make_sharded_video_decode_fn(cfg, mesh, local=True)
        times, reduced = sharding.reduce_decode_reps(
            [0.5, 0.25, 0.75], torch.stack([local(model, t_b) for _ in range(3)]), mesh)
        assert times == [0.5, 0.25, 0.75]
        for row in reduced:
            assert torch.equal(row, sums)
        assert torch.equal(sharding.make_sharded_video_decode_fn(cfg, mesh)(model, t_b), sums)
        for keep_local in (True, False):
            got = sharding.make_sharded_video_decode_fn(cfg, mesh, keep_frames=True,
                                                        local=keep_local)(model, t_b)
            assert torch.equal(got, frames)
    finally:
        sharding.close_mesh(mesh)


def test_eval_cli_takes_mesh_shape_and_runs_on_one_device(no_world, tmp_path, monkeypatch,
                                                          capsys):
    """As the JAX eval CLI (which never reads the flag): eval_main with
    --mesh_shape 2 (and a "model" axis) runs PATH B on one device, says so,
    and writes the result of the run without the flags."""
    from repnerv_tpu_torch.cli import eval_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(eval_main, "measure_decode_fps", lambda *a, **k: 1.0)
    monkeypatch.setattr(eval_main, "measure_micro_fps", lambda *a, **k: 1.0)
    argv = TRAIN_ARGV + ["-b", "1", "--outf", "ev"]
    train_main.main(argv)
    path_b = ["--prune_ratio", "0.5", "--quant_bit", "8"]
    plain = eval_main.main(argv + path_b)
    capsys.readouterr()
    meshed = eval_main.main(argv + path_b + ["--mesh_shape", "2", "--mesh_axes", "data", "model"])
    assert "eval_main runs on one device: --mesh_shape 2" in capsys.readouterr().out
    assert meshed == plain
    assert not dist.is_initialized()


@pytest.mark.parametrize("extra,row", [
    (PORTED_ROWS[0][0], None),
    (PORTED_ROWS[1][0], None),
    (["--mesh_shape", "2"], "torchrun --nproc_per_node 2"),
])
def test_train_cli_refuses(request, tmp_path, monkeypatch, capsys, extra, row):
    """What train_main refuses; a model axis and --norm bn over two ranks
    (``row`` None) it runs: in the two-rank world, against one process at
    the global batch (the model axis: -b 1 on each of its ranks; bn: -b 2,
    a frame a rank, the global batch's statistics)."""
    monkeypatch.chdir(tmp_path)
    if row is None:
        i = 2 + [e for e, _ in PORTED_ROWS].index(extra)
        b = PORTED_ROWS[i - 2][1]
        norm = ["--norm", "bn"] if "bn" in extra else []
        single = train_main.main(TRAIN_ARGV + ["-b", b] + norm + ["--outf", "single"])["history"]
        hists = [o["train_cli"][i] for o in request.getfixturevalue("world2")["outs"]]
        assert hists[0] == hists[1]
        for got, ref in zip(hists[0], single):
            assert got["epoch"] == ref["epoch"]
            assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
            np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-3)
        return
    with pytest.raises(SystemExit) as e:
        train_main.main(TRAIN_ARGV + ["-b", "1"] + extra)
    assert e.value.code == 2
    assert row in capsys.readouterr().err
    assert not os.path.exists("result")


def test_sharded_step_refuses_batch_norm_over_ranks():
    """Refused until the global batch's statistics were ported: both makers
    now take --norm bn over two ranks, and their step's forward then runs
    collectives (the eager step); over one rank the plain statistics."""
    cfg = TrainConfig(model=ModelConfig(norm="bn"))
    for make in (sharding.make_sharded_train_step, sharding.make_sharded_epoch_fn):
        make(cfg, 1, _mesh())
    assert sharding.collective_forward(cfg, _mesh())
    assert not sharding.collective_forward(cfg, _mesh(0, 1))
    assert isinstance(sharding.make_sharded_epoch_fn(cfg, 1, _mesh()), sharding.ShardedEpoch)


def test_decode_cli_needs_torchrun_for_more_ranks(tmp_path, capsys):
    with pytest.raises(SystemExit):
        decode_main.main([str(tmp_path / "none.rnvb"), "--frames", "4", "--mesh_shape", "2",
                          "--device", "cpu"])
    assert "torchrun --nproc_per_node 2" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_nccl_world_of_one_equals_the_plain_step_on_the_card():
    """On the card: an NCCL world of one, the sharded fused epoch (two CUDA
    graphs around the all-reduce) against the plain fused epoch, from the
    same weights: per-step losses and final weights equal to the bit under
    cuDNN's deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(model=ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="9_16_8",
                                        strides=(2, 2, 2), lower_width=8, branch_type="ERB"),
                      data=DataConfig(batch_size=1), epochs=2, warmup=0.5, lr=5e-3,
                      loss_type="Fusion6")
    video, t = synthetic_video(6, 72, 128, seed=2)
    store = FrameStore(frames=torch.from_numpy(video).cuda(), t=t)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = sharding.make_mesh((1,), ("data",), "cuda")
    try:
        assert dist.get_backend() == "nccl"
        runs = []
        for make in (lambda: loop.make_epoch_fn(cfg, 6),
                     lambda: sharding.make_sharded_epoch_fn(cfg, 6, mesh)):
            state = loop.init_train_state(cfg, "cuda", seed=0)
            fn, losses = make(), []
            for epoch in range(2):
                state, aux = fn(state, store, loop.epoch_rows(store, cfg, epoch), None)
                losses.append(aux["loss"].cpu().clone())
            assert fn.captured.captures == 1
            runs.append((torch.cat(losses), _weights(state.model)))
        assert torch.equal(runs[0][0], runs[1][0])
        for k, v in runs[0][1].items():
            assert torch.equal(runs[1][1][k], v), k
    finally:
        torch.backends.cudnn.deterministic = saved
        sharding.close_mesh(mesh)
