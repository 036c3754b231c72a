"""One rank of a gloo world for tests/test_torch_tensor_parallel.py.

    python tests/_torch_tp_child.py RANK WORLD INIT_FILE SPEC OUT

Joins the world through ``file://INIT_FILE`` (no port to race for), reads
the parent's ``SPEC`` (torch.save'd: a list of cases, each with the mesh it
runs on, the port's config, the whole start weights and its data), runs
each case through the port's tensor- and data-parallel code on the CPU with
TF32 off, and torch.saves what it saw to ``OUT``.  Imports no JAX: the
parent computes the references and compares.

Jobs: "step" (``make_sharded_train_step`` on this rank's rows of each global
batch, from ``shard_train_state`` of the start weights), "epochs"
(``make_sharded_epoch_fn`` driven by ``run_fused_epoch``), "relayout"
(``shard_train_state`` of a state that has stepped, then
``gather_train_state`` and ``gather_model``) and "train_cli" (``train_main.main`` in a directory
of this rank's).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
rank, world, init_file, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)

from repnerv_tpu_torch.data.frames import FrameStore  # noqa: E402
from repnerv_tpu_torch.models.generator import Generator  # noqa: E402
from repnerv_tpu_torch.parallel import sharding  # noqa: E402
from repnerv_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from repnerv_tpu_torch.train import loop  # noqa: E402


def start_state(c, start):
    model = ckpt.load_state(Generator(c.model), start).train()
    return loop.TrainState(model, loop.make_optimizer(c, model), 0)


def tensors(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def run(case):
    c = case["cfg"]
    mesh = sharding.make_mesh(case["shape"], case["axes"], "cpu")
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
    job = case["job"]
    if job == "step":
        state = sharding.shard_train_state(start_state(c, case["start"]), mesh)
        out["shards"] = tensors(state.model.state_dict())
        step = sharding.make_sharded_train_step(c, len(case["frames"]), mesh, with_msssim=False)
        losses, psnrs = [], []
        for f, tt in zip(case["frames"], case["t"]):
            f_l, t_l = sharding.shard_batch(f, tt, mesh)
            state, aux = step(state, f_l, t_l)
            losses.append(float(aux["loss"]))
            psnrs.append(aux["psnr"].tolist())
        out.update(loss=losses, psnr=psnrs, step=state.step,
                   weights=tensors(sharding.gather_train_state(state, mesh).model.state_dict()))
    elif job == "epochs":
        state = sharding.shard_train_state(start_state(c, case["start"]), mesh)
        store = FrameStore(frames=case["video"], t=case["t_all"])
        fn = sharding.make_sharded_epoch_fn(c, store.num_samples // c.data.batch_size, mesh)
        hist = []
        for epoch in range(case["epochs"]):
            state, m = loop.run_fused_epoch(state, fn, store, c, epoch)
            hist.append((m.loss, m.psnr.tolist(), m.lr))
        out.update(history=hist, type=type(fn).__name__, captures=fn.captures,
                   weights=tensors(sharding.gather_train_state(state, mesh).model.state_dict()))
    elif job == "relayout":
        # a state that has stepped (Adam's moments and count), laid out and back
        state = start_state(c, case["start"])
        plain = loop.make_train_step(c, 1, with_msssim=False)
        state, _ = plain(state, case["frames"][0], case["t"][0])
        before = {"weights": tensors(state.model.state_dict()),
                  "moments": [tensors(st) for st in state.optimizer.state_dict()["state"].values()]}
        settings = {k: v for k, v in state.optimizer.defaults.items() if k != "lr"}
        lr = state.optimizer.param_groups[0]["lr"]
        shards = sharding.shard_train_state(state, mesh)
        back = sharding.gather_train_state(shards, mesh)
        whole = sharding.gather_model(shards.model, mesh)
        out.update(eval_weights=tensors(whole.state_dict()),
                   eval_training=(whole.training, shards.model.training),
                   settings=[settings] + [{k: v for k, v in o.defaults.items() if k != "lr"}
                                          for o in (shards.optimizer, back.optimizer)],
                   lr_shared=[o.param_groups[0]["lr"] is lr
                              for o in (shards.optimizer, back.optimizer)])
        out.update(before=before, step=back.step, shard_step=shards.step,
                   weights=tensors(back.model.state_dict()),
                   moments=[tensors(st) for st in back.optimizer.state_dict()["state"].values()],
                   shard_moments=[tensors(st) for st in
                                  shards.optimizer.state_dict()["state"].values()])
    elif job == "train_cli":
        from repnerv_tpu_torch.cli import train_main

        cwd = os.getcwd()
        os.chdir(case["dirs"][mesh.rank])
        try:
            res = train_main.main(case["argv"])
        finally:
            os.chdir(cwd)
        out.update(history=res["history"], weights=tensors(res["state"].model.state_dict()))
    else:
        raise ValueError(f"unknown job {job!r}")
    if mesh.model_group is not None:
        dist.barrier()
    return out


outs = {}
for case in torch.load(spec_path, weights_only=False):
    outs[case["name"]] = run(case)
torch.save({"rank": dist.get_rank(), "cases": outs}, out_path)
dist.destroy_process_group()
