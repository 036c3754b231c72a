"""One rank of a two-process gloo world for tests/test_torch_sharding.py.

    python tests/_torch_dist_child.py RANK WORLD INIT_FILE SPEC OUT

Joins the world through ``file://INIT_FILE`` (no port to race for), reads
the parent's ``SPEC`` (torch.save'd: the port's config, the start weights,
the batches, the video), runs the jobs it names through the port's
data-parallel code on the CPU, and torch.saves what it saw to ``OUT``.
Imports no JAX: the parent computes the references and compares.

Jobs: "step" and "psnr" (``make_sharded_train_step`` on this rank's rows
of each global batch), "epoch" (``make_sharded_epoch_fn`` driven by
``run_fused_epoch``), "indivisible" (a global batch of 1 on every rank),
"replicate" (``shard_train_state`` of rank-seeded weights), "decode"
(``make_sharded_video_decode_fn`` with and without kept frames),
"train_cli" (``train_main.main`` in a directory of this rank's), "suite"
(``suite_main.main`` in parallel mode there: a video a rank) and "mesh"
(``make_mesh`` of a model axis over the two ranks).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

rank, world, init_file, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)

from repnerv_tpu_torch.data.frames import FrameStore  # noqa: E402
from repnerv_tpu_torch.models.generator import Generator  # noqa: E402
from repnerv_tpu_torch.parallel import sharding  # noqa: E402
from repnerv_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from repnerv_tpu_torch.train import loop  # noqa: E402

spec = torch.load(spec_path, weights_only=False)
cfg = spec["cfg"]
mesh = sharding.make_mesh((world,), ("data",), "cpu")
out = {"rank": mesh.rank}


def start_state(c):
    model = ckpt.load_state(Generator(c.model), spec["start"]).train()
    return loop.TrainState(model, loop.make_optimizer(c, model), 0)


def weights(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def run_steps(c, frames, t):
    state = start_state(c)
    step = sharding.make_sharded_train_step(c, len(frames), mesh, with_msssim=False)
    losses, psnrs = [], []
    for f, tt in zip(frames, t):
        f_l, t_l = sharding.shard_batch(f, tt, mesh)
        state, aux = step(state, f_l, t_l)
        losses.append(float(aux["loss"]))
        psnrs.append(aux["psnr"].tolist())
    return {"loss": losses, "psnr": psnrs, "weights": weights(state)}


for job in spec["jobs"]:
    if job == "step":
        out["step"] = run_steps(cfg, spec["frames"], spec["t"])
    elif job == "psnr":
        out["psnr"] = run_steps(cfg, spec["psnr_frames"], spec["psnr_t"])
    elif job == "indivisible":
        c1 = spec["cfg_b1"]
        out["indivisible"] = run_steps(c1, spec["frames"][:, :1], spec["t"][:, :1])
    elif job == "epoch":
        store = FrameStore(frames=spec["video"], t=spec["t_all"])
        state = start_state(cfg)
        steps = store.num_samples // cfg.data.batch_size
        fn = sharding.make_sharded_epoch_fn(cfg, steps, mesh, with_msssim=False)
        hist = []
        for epoch in range(2):
            state, m = loop.run_fused_epoch(state, fn, store, cfg, epoch)
            hist.append((m.loss, m.psnr.tolist(), m.lr))
        out["epoch"] = {"history": hist, "weights": weights(state)}
    elif job == "replicate":
        state = loop.init_train_state(cfg, "cpu", seed=100 + mesh.rank)
        state.step = 7 * (mesh.rank + 1)
        state = sharding.shard_train_state(state, mesh)
        out["replicate"] = {"weights": weights(state), "step": state.step}
    elif job == "decode":
        model = ckpt.load_state(Generator(cfg.model), spec["start"]).eval()
        t_b = spec["decode_t"]
        out["decode"] = {
            "frames": sharding.make_sharded_video_decode_fn(cfg, mesh, keep_frames=True)(
                model, t_b),
            "checksums": sharding.make_sharded_video_decode_fn(cfg, mesh)(model, t_b),
            "one_batch": sharding.make_sharded_decode(cfg, mesh)(model, t_b[0]),
        }
    elif job == "train_cli":
        from repnerv_tpu_torch.cli import train_main

        os.chdir(spec["cli_dirs"][mesh.rank])
        out["train_cli"] = [train_main.main(argv)["history"] for argv in spec["cli_argvs"]]
    elif job == "mesh":
        out["mesh"] = {}
        for shape, axes in spec["meshes"]:
            m = sharding.make_mesh(shape, axes, "cpu")
            out["mesh"][shape, axes] = {
                "shape": m.shape, "axis_names": m.axis_names, "world_size": m.world_size,
                "model_size": m.model_size, "data_size": m.data_size,
                "model_index": m.model_index, "data_index": m.data_index,
                "model_group": dist.get_world_size(m.model_group),
                "data_group": dist.get_world_size(m.data_group)}
    elif job == "suite":
        from repnerv_tpu_torch.cli import suite_main

        os.chdir(spec["cli_dirs"][mesh.rank])
        out["suite"] = suite_main.main(spec["suite_argv"])
    else:
        raise ValueError(f"unknown job {job!r}")

torch.save(out, out_path)
dist.destroy_process_group()
