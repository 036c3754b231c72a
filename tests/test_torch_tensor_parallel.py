"""The port's tensor parallelism over a "model" mesh axis and ``--norm bn``
over data ranks (repnerv_tpu_torch/parallel/sharding.py,
parallel/tensor_parallel.py, models/layers.py::batch_norm_train) on the
CPU, against the JAX package's GSPMD sharding.

* ``params_specs`` / ``shard_params`` against JAX's ``params_specs`` on the
  tiny ERB and NeRV_vanilla trees over (4, 2) and (2, 2): a marker tree
  (each leaf holding its JAX shard index along the split axis, -1 where
  replicated) goes through ``params_to_torch_state``'s layouts, and each
  port entry must split on the dim where the markers vary, or on none.
* Gloo worlds of two and four processes (``tests/_torch_tp_child.py``, a
  ``file://`` store in ``tmp_path``, ``OMP_NUM_THREADS=1``, no JAX in the
  children), from the JAX package's weights (``state_from_jax_params``),
  against JAX's ``make_sharded_train_step`` / ``make_sharded_epoch_fn`` over
  the same mesh from the same weights and batches: per-step loss within
  1e-5 relative, the gathered parameters within atol 1e-5 after the step
  (JAX's own tests/test_sharding.py bounds); over three epochs, PSNR within
  1e-3 dB and the final weights within 1e-4 of each tensor's largest
  |value| (tests/test_torch_fused_epoch.py's trajectory bounds).  Cases:
  ERB and NeRV_vanilla over (1, 2); shards that are not whole PixelShuffle
  groups (fc_hw_dim 2_2_3, strides 2 2: Cout 12 -> 6 a rank); a stage input
  of 1024 px, so that ``fused_stage_train``'s plain versions run on the
  shard; ERB over (2, 2); ``--norm bn`` over (2,) data ranks and under
  (1, 2); three epochs of ``make_sharded_epoch_fn`` over (1, 2).
* Each rank holds only its slices; the replicated leaves end equal to the
  bit on every rank; the ranks of one data index take the same rows and the
  loss is the global batch's (not the model axis times it).
* ``shard_train_state`` / ``gather_train_state`` keep a stepped state's
  values to the bit; ``train_main --mesh_shape 1 2 --mesh_axes data model``
  over two ranks: only rank 0 writes, its checkpoint loads strict into a
  plain ``Generator`` and resumes in a plain run.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repnerv_tpu_torch.cli import train_main
from repnerv_tpu_torch.data.frames import synthetic_video
from repnerv_tpu_torch.models.generator import Generator
from repnerv_tpu_torch.parallel import sharding
from repnerv_tpu_torch.train import checkpoint as ckpt

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_tp_child.py")
CHILD_TIMEOUT = 300  # seconds for a whole world's run
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-5
TRAIN_ARGV = (
    "--dataset synth --synthetic_frames 4 --synthetic_hw 24 32 --embed 1.25_4 "
    "--stem_dim_num 16_1 --fc_hw_dim 3_4_6 --expansion 1 --strides 2 2 2 "
    "--lower_width 4 --branch_type ERB --act swish --single_res --loss Fusion6 "
    "--lr 5e-3 -b 2 --device cpu"
).split()

# name -> (tiny_model overrides, loss, mesh shape, mesh axes)
STEP_CASES = {
    "erb": (dict(branch_type="ERB"), "Fusion6", (1, 2), ("data", "model")),
    "vanilla": (dict(branch_type="NeRV_vanilla"), "L2", (1, 2), ("data", "model")),
    # Cout 12 -> 6 a rank at stride 2: not whole groups of 4
    "partial_groups": (dict(branch_type="ERB", fc_hw_dim="2_2_3"), "L2", (1, 2),
                       ("data", "model")),
    # block 1 takes 32 x 32 = 1024 px: fused_stage_train's gate holds on the shard
    "kernel_gate": (dict(branch_type="ERB", fc_hw_dim="8_8_4", strides=(4, 2)), "L2", (1, 2),
                    ("data", "model")),
    "bn_data": (dict(branch_type="ERB", norm="bn"), "L2", (2,), ("data",)),
    "bn_model": (dict(branch_type="ERB", norm="bn"), "L2", (1, 2), ("data", "model")),
}
STEP_CASES_4 = {
    "erb_2x2": (dict(branch_type="ERB"), "Fusion6", (2, 2), ("data", "model")),
    "bn_2x2": (dict(branch_type="ERB", norm="bn"), "L2", (2, 2), ("data", "model")),
}


def _jax_cfg(over, loss, batch_size=2):
    import jax

    from repnerv_tpu.config import TrainConfig as JaxTrainConfig
    from repnerv_tpu.models import generator as jgen
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_train_cfg

    kw = dict(embed="1.25_4", fc_hw_dim="3_4_6", strides=(2, 2))
    kw.update(over)
    mcfg = tiny_model(**kw)
    tcfg = JaxTrainConfig(model=mcfg, epochs=2, warmup=0.5, lr=5e-3, loss_type=loss,
                          manual_seed=1)
    tcfg.data.batch_size = batch_size
    params = jgen.init_generator(jax.random.PRNGKey(7), mcfg)
    ptcfg = port_train_cfg(tcfg)
    start = ckpt.state_from_jax_params(jax.tree.map(np.asarray, params), ptcfg.model)
    return tcfg, ptcfg, params, start


def _batches(ptcfg, n_steps=2, seed=2):
    h, w = [d * int(np.prod(ptcfg.model.strides)) for d in ptcfg.model.fc_hwd[:2]]
    b = ptcfg.data.batch_size
    video, t_all = synthetic_video(n_steps * b, h, w, seed=seed)
    rows = np.arange(n_steps * b).reshape(n_steps, b)
    return (torch.from_numpy(video[rows].astype(np.float32) / 255.0),
            torch.from_numpy(t_all[rows].astype(np.float32)), video, t_all)


def _run_world(tmp_path, cases: list, world: int) -> list:
    spec_path = tmp_path / "spec.pt"
    torch.save(cases, spec_path)
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
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)["cases"] for r in range(world)]


def _step_case(name, over, loss, shape, axes):
    tcfg, ptcfg, params, start = _jax_cfg(over, loss)
    frames, t, _, _ = _batches(ptcfg)
    return {"name": name, "job": "step", "cfg": ptcfg, "start": start, "frames": frames, "t": t,
            "shape": shape, "axes": axes}, (tcfg, params)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One two-rank run of every case, and the JAX inputs of each."""
    tmp = tmp_path_factory.mktemp("tp2")
    cases, jax_inputs = [], {}
    for name, (over, loss, shape, axes) in STEP_CASES.items():
        case, jax_inputs[name] = _step_case(name, over, loss, shape, axes)
        cases.append(case)
    tcfg, ptcfg, params, start = _jax_cfg(dict(branch_type="ERB"), "Fusion6")
    frames, t, video, t_all = _batches(ptcfg)
    jax_inputs["epochs"] = (tcfg, params)
    cases.append({"name": "epochs", "job": "epochs", "cfg": ptcfg, "start": start,
                  "video": torch.from_numpy(video), "t_all": t_all, "epochs": 3,
                  "shape": (1, 2), "axes": ("data", "model")})
    cases.append({"name": "relayout", "job": "relayout", "cfg": ptcfg, "start": start,
                  "frames": frames, "t": t, "shape": (1, 2), "axes": ("data", "model")})
    dirs = [tmp / "rank0", tmp / "rank1"]
    for d in dirs:
        d.mkdir()
    cases.append({"name": "train_cli", "job": "train_cli", "cfg": ptcfg, "shape": (1, 2),
                  "axes": ("data", "model"), "dirs": [str(d) for d in dirs],
                  "argv": TRAIN_ARGV + ["-e", "2", "--outf", "tp", "--mesh_shape", "1", "2",
                                        "--mesh_axes", "data", "model"]})
    outs = _run_world(tmp, cases, 2)
    return {"outs": outs, "cases": {c["name"]: c for c in cases}, "jax": jax_inputs,
            "dirs": dirs}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp4")
    cases, jax_inputs = [], {}
    for name, (over, loss, shape, axes) in STEP_CASES_4.items():
        case, jax_inputs[name] = _step_case(name, over, loss, shape, axes)
        cases.append(case)
    return {"outs": _run_world(tmp, cases, 4), "cases": {c["name"]: c for c in cases},
            "jax": jax_inputs}


def _jax_steps(tcfg, params, frames, t, shape, axes):
    """JAX's make_sharded_train_step over ``shape`` from ``params`` (laid out
    by JAX's shard_params): losses, PSNRs and the final params as a port
    state dict."""
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.parallel.sharding import make_mesh, make_sharded_train_step, shard_params
    from repnerv_tpu.train import loop as jloop

    mesh = make_mesh(shape, axes)
    p = shard_params(params, mesh)
    state = jloop.TrainState(p, jloop.make_optimizer(tcfg).init(p), jnp.asarray(0, jnp.int32))
    step = make_sharded_train_step(tcfg, len(frames), mesh)
    losses, psnrs = [], []
    for f, tt in zip(frames.numpy(), t.numpy()):
        state, aux = step(state, jnp.asarray(f), jnp.asarray(tt))
        losses.append(float(aux["loss"]))
        psnrs.append(float(np.asarray(aux["psnr"]).reshape(-1)[-1]))
    from test_torch_config_codecs import port_model_cfg

    ref = ckpt.state_from_jax_params(jax.tree.map(np.asarray, state.params),
                                     port_model_cfg(tcfg.model))
    return losses, psnrs, {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}


def _check_step(world, name):
    case = world["cases"][name]
    tcfg, params = world["jax"][name]
    losses, psnrs, ref = _jax_steps(tcfg, params, case["frames"], case["t"], case["shape"],
                                    case["axes"])
    for out in world["outs"]:
        got = out[name]
        np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose([p[-1] for p in got["psnr"]], psnrs, atol=1e-3)
        assert got["step"] == len(losses)
        for k, v in ref.items():
            torch.testing.assert_close(got["weights"][k], v, atol=WEIGHT_ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_tp_step_equals_jax_sharded_step(world2, name):
    """Two steps over two ranks against JAX's make_sharded_train_step over
    the same mesh (its plain XLA path: _gspmd_safe_cfg)."""
    _check_step(world2, name)


@pytest.mark.parametrize("name", list(STEP_CASES_4))
def test_tp_step_over_2x2_equals_jax(world4, name):
    """Four ranks, a (2, 2) data x model mesh, one frame a data rank."""
    _check_step(world4, name)


def test_tp_epochs_equal_jax_sharded_epochs(world2):
    """Three epochs of make_sharded_epoch_fn over (1, 2) (eager: its forward
    runs collectives) driven by run_fused_epoch, against JAX's sharded fused
    epoch over the same mesh."""
    import jax
    import jax.numpy as jnp

    from repnerv_tpu.data.frames import FrameStore as JStore
    from repnerv_tpu.parallel.sharding import make_mesh, make_sharded_epoch_fn, shard_params
    from repnerv_tpu.train import loop as jloop

    case = world2["cases"]["epochs"]
    tcfg, params = world2["jax"]["epochs"]
    mesh = make_mesh((1, 2), ("data", "model"))
    p = shard_params(params, mesh)
    state = jloop.TrainState(p, jloop.make_optimizer(tcfg).init(p), jnp.asarray(0, jnp.int32))
    steps = len(case["t_all"]) // tcfg.data.batch_size
    fn = make_sharded_epoch_fn(tcfg, steps, mesh)
    store = JStore(frames=jnp.asarray(case["video"].numpy()), t=case["t_all"])
    ref = []
    for epoch in range(3):
        state, m = jloop.run_fused_epoch(state, fn, store, tcfg, epoch)
        ref.append((m.loss, float(m.psnr[-1]), m.lr))
    ref_w = ckpt.state_from_jax_params(jax.tree.map(np.asarray, state.params), case["cfg"].model)
    for out in world2["outs"]:
        got = out["epochs"]
        assert got["type"] == "ShardedEpoch" and got["captures"] == 0
        for (l1, p1, lr1), (l2, p2, lr2) in zip(got["history"], ref):
            assert l1 == pytest.approx(l2, rel=LOSS_RTOL)
            assert p1[-1] == pytest.approx(p2, abs=1e-3)
            assert lr1 == pytest.approx(lr2, rel=1e-6)
        for k, v in ref_w.items():
            v = torch.from_numpy(np.asarray(v))
            scale = max(float(v.abs().max()), 1e-30)
            assert float((got["weights"][k] - v).abs().max()) <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# Which leaf splits, and what each rank holds
# ---------------------------------------------------------------------------


def _markers(params, specs, m):
    """Each JAX leaf -> its model-shard index along the split axis, -1
    where replicated."""
    import jax
    from jax.sharding import PartitionSpec as P

    def marker(leaf, spec):
        if leaf is None:
            return None
        out = np.full(leaf.shape, -1.0, np.float32)
        for ax, name in enumerate(spec):
            if name == "model":
                idx = np.arange(leaf.shape[ax]) // (leaf.shape[ax] // m)
                shape = [1] * leaf.ndim
                shape[ax] = -1
                out = np.broadcast_to(idx.reshape(shape), leaf.shape).astype(np.float32)
        return out

    return jax.tree.map(marker, params, specs, is_leaf=lambda x: x is None or isinstance(x, P))


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
@pytest.mark.parametrize("branch", ["ERB", "NeRV_vanilla"])
def test_params_specs_split_each_leaf_as_jax(shape, branch):
    import jax

    from repnerv_tpu.models.generator import init_generator
    from repnerv_tpu.parallel.sharding import make_mesh, params_specs as jax_specs
    from test_model_train import tiny_model
    from test_torch_config_codecs import port_model_cfg

    mcfg = tiny_model(branch_type=branch, embed="1.25_4", fc_hw_dim="3_4_6", strides=(2, 2))
    params = init_generator(jax.random.PRNGKey(0), mcfg)
    m = shape[1]
    marked = _markers(params, jax_specs(params, make_mesh(shape, ("data", "model"))), m)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in ckpt.state_from_jax_params(marked, port_model_cfg(mcfg)).items()}
    n = int(np.prod(shape))
    specs = sharding.params_specs(state, sharding.Mesh(shape, ("data", "model"), 0, n,
                                                       torch.device("cpu")))
    assert set(specs) == set(Generator(port_model_cfg(mcfg)).state_dict())
    n_split = 0
    for k, v in state.items():
        d = specs[k]
        if d is None:
            assert bool((v == -1).all()), k
            continue
        n_split += 1
        idx = torch.arange(v.shape[d]) // (v.shape[d] // m)
        view = [1] * v.dim()
        view[d] = -1
        assert torch.equal(v, idx.reshape(view).expand_as(v).float()), k
    assert n_split >= 4  # the stem's two linears, the first layer's bias, conv weights
    # each rank of the mesh holds the slice of its model index, whole elsewhere
    for rank in range(n):
        mesh = sharding.Mesh(shape, ("data", "model"), rank, n, torch.device("cpu"))
        assert mesh.model_index == rank % m and mesh.data_index == rank // m
        mine = sharding.shard_params(state, mesh)
        for k, v in mine.items():
            if specs[k] is None:
                assert v.shape == state[k].shape, k
            else:
                assert v.shape[specs[k]] * m == state[k].shape[specs[k]], k
                assert bool((v == mesh.model_index).all()), k


def test_flagship_splits_cout_over_the_model_axis():
    """The paper's ERB flagship at M = 2: Cout 650 -> 325 on block 0 and
    384 -> 192 on blocks 1-4, seq_1x1_a over its 2 ngf outputs, the head
    (Cout 3) replicated; the stem column- then row-parallel."""
    from repnerv_tpu_torch.config import ModelConfig

    shapes = {k: v.shape for k, v in Generator(ModelConfig(branch_type="ERB")).state_dict().items()}
    state = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    mesh = sharding.Mesh((1, 2), ("data", "model"), 0, 2, torch.device("cpu"))
    specs = sharding.params_specs(state, mesh)
    mine = sharding.shard_params(state, mesh)
    assert specs["stem.0.weight"] == 0 and specs["stem.0.bias"] == 0
    assert specs["stem.2.weight"] == 1 and specs["stem.2.bias"] is None
    for li, cout in enumerate([650, 384, 384, 384, 384]):
        for attr in ("rbr_3x3_branch", "rbr_3x1_branch", "rbr_1x3_branch",
                     "rbr_1x1_3x3_1x1_branch_3x3", "rbr_1x1_3x3_1x1_branch_1x1_2"):
            assert specs[f"layers.{li}.{attr}.weight"] == 0
            assert mine[f"layers.{li}.{attr}.weight"].shape[0] == cout // 2
        assert specs[f"layers.{li}.rbr_3x3_branch.bias"] is None
        assert mine[f"layers.{li}.rbr_1x1_3x3_1x1_branch_1x1_1.weight"].shape[0] == (
            shapes[f"layers.{li}.rbr_1x1_3x3_1x1_branch_1x1_1.weight"][0] // 2)
    assert specs["head_layers.4.weight"] is None and specs["head_layers.4.bias"] is None


def test_ranks_hold_their_slices_and_equal_replicas(world2, world4):
    """After the steps each rank's split leaves are its slices of the
    gathered whole, and its replicated leaves equal every other rank's to
    the bit (their gradients all-reduced over the model group)."""
    for world, names in ((world2, STEP_CASES), (world4, STEP_CASES_4)):
        for name in names:
            outs = [o[name] for o in world["outs"]]
            case = world["cases"][name]
            n = int(np.prod(case["shape"]))
            specs = sharding.params_specs(
                outs[0]["weights"], sharding.Mesh(case["shape"], case["axes"], 0, n,
                                                  torch.device("cpu")))
            for r, o in enumerate(outs):
                mesh = sharding.Mesh(case["shape"], case["axes"], r, n, torch.device("cpu"))
                want = sharding.shard_params(ckpt_start(case), mesh)
                for k, v in o["shards"].items():
                    assert v.shape == want[k].shape, (name, k)
                    assert torch.equal(v, want[k]), (name, k)
                for k, d in specs.items():
                    if d is None:
                        assert torch.equal(o["weights"][k], outs[0]["weights"][k]), (name, k)


def ckpt_start(case) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in case["start"].items()}


def test_model_ranks_take_one_data_index_rows_and_the_global_loss(world4):
    """The 2-D layout: on a (2, 2) mesh the ranks of one data index take the
    same rows of a batch (rank = d * M + m), and the loss in the reduced
    bucket is the global batch's, not M times it (the ranks of both data
    indices report JAX's loss)."""
    shape, n = (2, 2), 4
    for global_n in (4, 2):
        slices = [sharding.local_batch(global_n, sharding.Mesh(shape, ("data", "model"), r, n,
                                                               torch.device("cpu")))
                  for r in range(n)]
        assert slices[0] == slices[1] and slices[2] == slices[3] and slices[0] != slices[2]
        assert slices[2] == slice(global_n // 2, global_n)
    outs = world4["outs"]
    assert [o["erb_2x2"]["data_index"] for o in outs] == [0, 0, 1, 1]
    assert [o["erb_2x2"]["model_index"] for o in outs] == [0, 1, 0, 1]
    case = world4["cases"]["erb_2x2"]
    tcfg, params = world4["jax"]["erb_2x2"]
    losses, _, _ = _jax_steps(tcfg, params, case["frames"], case["t"], (2,), ("data",))
    for o in outs:
        np.testing.assert_allclose(o["erb_2x2"]["loss"], losses, rtol=LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# The state, checkpoints, the CLI
# ---------------------------------------------------------------------------


def test_shard_train_state_keeps_a_stepped_states_values(world2):
    """A state with Adam's moments and count laid out over (1, 2) and
    gathered back: the weights, moments and step equal the original's to the
    bit, and each rank's moments are its slices of them."""
    for out in world2["outs"]:
        got = out["relayout"]
        assert got["step"] == got["shard_step"] == 1
        for k, v in got["before"]["weights"].items():
            assert torch.equal(got["weights"][k], v), k
        assert len(got["moments"]) == len(got["before"]["moments"])
        for a, b, s in zip(got["moments"], got["before"]["moments"], got["shard_moments"]):
            for k in b:
                assert torch.equal(a[k], b[k]), k
                if k != "step" and s[k].shape != b[k].shape:
                    d = next(i for i, (x, y) in enumerate(zip(s[k].shape, b[k].shape)) if x != y)
                    n = s[k].shape[d]
                    assert torch.equal(s[k], b[k].narrow(d, out["relayout"]["model_index"] * n,
                                                         n))


def test_gather_model_and_relaid_optimizers_keep_the_state(world2):
    """The same stepped state: ``gather_model`` of its shards gives the
    original weights to the bit, with the model's training flag; the Adams
    over the shards and over the gathered state keep every setting of
    ``make_optimizer``'s and share its learning-rate tensor."""
    for out in world2["outs"]:
        got = out["relayout"]
        assert got["eval_weights"].keys() == got["before"]["weights"].keys()
        for k, v in got["before"]["weights"].items():
            assert torch.equal(got["eval_weights"][k], v), k
        assert got["eval_training"] == (True, True)
        assert got["settings"][1] == got["settings"][2] == got["settings"][0]
        assert got["lr_shared"] == [True, True]


def test_train_cli_model_axis_writes_plain_checkpoints_that_resume(world2, tmp_path,
                                                                  monkeypatch):
    """train_main --mesh_shape 1 2 --mesh_axes data model over two ranks
    against one process: the history within the step bounds; only rank 0
    wrote; its .pth loads strict=True into a plain Generator; a plain run
    resumes from its directory and its next epoch matches a plain run's."""
    monkeypatch.chdir(tmp_path)
    single = train_main.main(TRAIN_ARGV + ["-e", "2", "--outf", "single"])
    hists = [o["train_cli"]["history"] for o in world2["outs"]]
    assert hists[0] == hists[1]
    for got, ref in zip(hists[0], single["history"]):
        assert got["epoch"] == ref["epoch"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-3)
    outf = world2["dirs"][0] / "result" / "tp"
    for name in ("rank0.txt", "model_latest.pth", "model_latest_deploy.pth", ckpt.RESUME_FILE):
        assert (outf / name).exists(), name
    assert not (world2["dirs"][1] / "result").exists()
    log = (outf / "rank0.txt").read_text()
    assert "WARNING: a model axis of 2 trains through the eager step" in log
    weights, extra = ckpt.load_pth(str(outf / "model_latest.pth"))
    model = ckpt.load_state(Generator(single["state"].model.cfg), weights)
    for k, v in world2["outs"][0]["train_cli"]["weights"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert extra["epoch"] == 2
    # a third epoch resumed from each directory
    shutil.copytree(outf, tmp_path / "result" / "from_tp")
    shutil.copytree(tmp_path / "result" / "single", tmp_path / "result" / "from_plain")
    (got,) = train_main.main(TRAIN_ARGV + ["-e", "3", "--outf", "from_tp"])["history"]
    (ref,) = train_main.main(TRAIN_ARGV + ["-e", "3", "--outf", "from_plain"])["history"]
    assert got["epoch"] == ref["epoch"] == 3
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)


def test_batch_norm_statistics_are_the_global_batchs():
    """batch_norm_train over a group of one rank equals nn.BatchNorm's
    training-mode arithmetic; its statistics over data ranks (bn_data) are
    held to JAX in test_tp_step_equals_jax_sharded_step."""
    from repnerv_tpu_torch.models.layers import BatchNorm, batch_norm_train

    x = torch.randn(2, 5, 6, 4, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(4).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    got = batch_norm_train(x, bn.weight, bn.bias, bn.eps)
    ref = torch.nn.functional.batch_norm(x.permute(0, 3, 1, 2), None, None, bn.weight, bn.bias,
                                         training=True, eps=bn.eps).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)
    assert torch.equal(bn(x), got)
