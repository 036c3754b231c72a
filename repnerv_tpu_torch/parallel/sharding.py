"""Data- and tensor-parallel training and data-parallel decode over
``torch.distributed`` (port of ``repnerv_tpu/parallel/sharding.py``).

A JAX device of the mesh is a rank here: one process, one device
(``cuda:LOCAL_RANK`` on a card, the CPU otherwise).  The global batch of
frames splits over the ``"data"`` axis; on a data-only mesh every rank holds
the whole model.

* **Start-up.**  ``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
  ``maybe_initialize_distributed`` reads them and starts the process group:
  NCCL where every rank of a host has a card of its own, gloo on the CPU and
  where ranks share a card (NCCL refuses two ranks on one device; gloo
  all-reduces CUDA tensors through host memory), always with a timeout so
  that a collective that hangs fails.  ``--mesh_shape 1`` without torchrun
  is a world of one inside the process (an in-memory store).
* **The step** (``make_sharded_train_step``, ``make_sharded_epoch_fn``): each
  rank runs the forward and backward of its rows of the batch; the
  gradients, the loss, the per-stage MSE and MS-SSIM go into one flat f32
  bucket, which one ``all_reduce`` over the data group sums (gloo has no
  average) and the step divides by the data axis; then Adam runs on every
  rank on the same values, so the ranks' parameters stay equal to the bit.  PSNR is
  ``-10 log10`` of the averaged MSE, the global batch's (a mean of per-rank
  PSNRs is not).  In the fused epoch on the card the part before the
  all-reduce and the part after it are two CUDA graphs; the all-reduce runs
  between their replays (a gloo collective cannot be captured; capturing
  NCCL is ROADMAP A12).  With a world of one the division is by 1 and the
  step equals the plain step to the bit (its all-reduce still runs); so
  does a ``(1, 1)`` data x model mesh.
* **An indivisible batch** (``-b 1`` on two ranks): every rank takes the
  whole batch, the gradients are equal, and the result is the single-rank
  step's, as JAX's single-process replication (``local_batch``).
* **Decode** (``make_sharded_video_decode_fn``): each rank decodes its
  columns of every batch through ``make_video_decode_fn`` (on the card one
  CUDA graph replay a batch); the checksum's sum is the one collective, run
  outside the graph, and kept frames are gathered.  A timed decode
  (``train/loop.py::measure_decode_fps``) keeps the checksums on the rank
  and reduces them, with the reps' times, once after its loop
  (``reduce_decode_reps``).
* **Tensor parallelism** over a ``"model"`` axis (``make_mesh((D, M),
  ("data", "model"))``, rank ``r = d * M + m`` as JAX's row-major device
  grid): ``params_specs`` splits the leaves JAX's does, ``shard_train_state``
  keeps each rank's slices (and those of Adam's moments), and the step runs
  ``parallel/tensor_parallel.py``'s forward on them, its collectives over
  the model group; the bucket of the rank's shard gradients is all-reduced
  over the data group (the ranks of its model index) and divided by the data
  axis.  The ranks of one data index take the same rows.  The epoch is
  eager: gloo collectives inside the forward cannot be captured (capturing
  NCCL is ROADMAP A12).  ``gather_train_state`` puts the whole model back
  together on every rank (checkpoints), ``gather_model`` its weights
  (evaluation).
* **``--norm bn`` over data ranks**: the batch statistics of the global
  batch (``models/layers.py::batch_norm_train``, all-reduced over the data
  group), as JAX's ``jnp.mean`` / ``jnp.var`` over the GSPMD-sharded batch;
  eager as above.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import TrainConfig, head_plan
from ..models.generator import Generator
from ..train.loop import (
    FusedEpoch,
    Masks,
    TrainState,
    _make_forward_backward,
    _schedule,
    _StepBuffers,
    apply_update,
    init_train_state,
    make_optimizer_like,
    make_video_decode_fn,
)
from ..train.schedule import lr_at_step
from ..utils.profiling import capture_graph
from .tensor_parallel import divides

TIMEOUT = timedelta(seconds=300)  # a collective that waits longer fails
AXES = ("data", "model", "video")


@dataclass(frozen=True)
class Mesh:
    """The ranks of a ``torch.distributed`` world laid out as a mesh of
    ``shape`` over ``axis_names`` ("data" and "model", or "video" for the
    suite), rank ``r`` at ``np.unravel_index(r, shape)`` (JAX's
    ``np.asarray(devices).reshape(shape)``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world_size: int
    device: torch.device  # this rank's
    owns_group: bool = False  # make_mesh started the process group
    data_group: Any = None  # the ranks of this rank's model index; None: the world
    model_group: Any = None  # the ranks of this rank's data index; None: no model axis

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 off the mesh's axes)."""
        if name not in self.axis_names:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(name)])

    @property
    def data_size(self) -> int:
        return self.axis_size("data")

    @property
    def model_size(self) -> int:
        return self.axis_size("model")

    @property
    def data_index(self) -> int:
        return self.axis_index("data")

    @property
    def model_index(self) -> int:
        return self.axis_index("model")

    def model_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slice of ``t`` along ``dim`` on the model
        axis."""
        n = t.shape[dim] // self.model_size
        return t.narrow(dim, self.model_index * n, n)


def torchrun_env(environ=None) -> Optional[Dict[str, int]]:
    """rank, world_size, local_rank, local_world_size from torchrun's
    variables, or None when they are not set."""
    environ = os.environ if environ is None else environ
    if "RANK" not in environ or "WORLD_SIZE" not in environ:
        return None
    rank, world = int(environ["RANK"]), int(environ["WORLD_SIZE"])
    return {"rank": rank, "world_size": world,
            "local_rank": int(environ.get("LOCAL_RANK", rank)),
            "local_world_size": int(environ.get("LOCAL_WORLD_SIZE", world))}


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards there are),
    or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but no CUDA device is available")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL where each rank of a host has a card of its own, else gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(device="cuda", timeout: timedelta = TIMEOUT) -> bool:
    """Start the process group from torchrun's variables (``env://``) when
    they are set; True when a group exists afterwards."""
    if dist.is_initialized():
        return True
    env = torchrun_env()
    if env is None:
        return False
    dev = rank_device(device, env["local_rank"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, env["local_world_size"])
    dist.init_process_group(backend, init_method="env://", rank=env["rank"],
                            world_size=env["world_size"], timeout=timeout)
    return True


def make_mesh(shape: Sequence[int] = (), axes: Sequence[str] = ("data",), device="cuda",
              timeout: timedelta = TIMEOUT) -> Mesh:
    """The mesh over the torchrun world (started here if need be); ``()``
    means every rank on the first axis.  ``--mesh_shape 1`` without torchrun
    starts a world of one in this process; more ranks without torchrun, or
    another count than torchrun started, raise.  A model axis of more than
    one rank makes the data and model process groups (``_mesh_groups``)."""
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if not set(axes) <= set(AXES):
        raise ValueError(f"mesh axes {axes}: the port lays ranks out over 'data' and 'model' "
                         f"(or 'video')")
    if shape:
        axes = axes[: len(shape)]
        if len(axes) != len(shape):
            raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, got {axes}")
    n = math.prod(shape) if shape else None
    owns = False
    if not maybe_initialize_distributed(device, timeout):
        if n not in (None, 1):
            raise ValueError(f"mesh {shape} needs {n} processes: start them with "
                             f"torchrun --nproc_per_node {n} -m <module> ...")
        dev = rank_device(device, 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(dev, 1), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        owns = True
    rank, world = dist.get_rank(), dist.get_world_size()
    env = torchrun_env()
    dev = rank_device(device, env["local_rank"] if env else rank)
    if not shape:
        shape, axes = (world,), axes[:1]
    if n is not None and n > world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {world}")
    if n is not None and n < world:
        raise ValueError(f"mesh {shape} uses {n} of the {world} ranks torchrun started: "
                         f"start {n} (torchrun --nproc_per_node {n})")
    mesh = Mesh(shape, axes, rank, world, dev, owns)
    if mesh.model_size > 1:
        data_group, model_group = _mesh_groups(mesh, timeout)
        mesh = dataclasses.replace(mesh, data_group=data_group, model_group=model_group)
    return mesh


def _mesh_groups(mesh: Mesh, timeout: timedelta = TIMEOUT):
    """(data group, model group) of this rank: the ranks of its model index,
    and those of its data index.  Every rank makes every group, in one order
    (a rank that skipped one would hang the others)."""
    grid = np.arange(math.prod(mesh.shape)).reshape(mesh.shape)
    axis = mesh.axis_names.index("model")
    rows = np.moveaxis(grid, axis, -1).reshape(-1, mesh.model_size)  # a model group a row
    groups = []
    for members in [rows[:, m] for m in range(mesh.model_size)] + list(rows):
        members = [int(r) for r in members]
        group = dist.new_group(ranks=members, timeout=timeout)
        if mesh.rank in members:
            groups.append(group)
    return tuple(groups)  # its data group is made first


def close_mesh(mesh: Optional[Mesh]) -> None:
    """End the process group when ``make_mesh`` started it, or at the end of
    a torchrun world."""
    if mesh is not None and dist.is_initialized() and (mesh.owns_group or torchrun_env()):
        dist.destroy_process_group()


def batch_spec(mesh: Mesh) -> Tuple[str, ...]:
    """The axes a batch's leading dim splits over: ("data",) or ()."""
    return ("data",) if "data" in mesh.axis_names else ()


def process_local_slice(global_n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of a leading global batch dim: data
    coordinate ``d`` of a data axis of ``D`` owns ``[d*n/D, (d+1)*n/D)``, so
    the ranks of one data index (a model group) take the same rows.  Every
    rank draws the same permutation and keeps only this slice."""
    per = global_n // mesh.data_size
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def local_batch(global_n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``global_n``: its slice where
    the batch divides by the data axis, else the whole batch (every rank then
    computes the same gradients; JAX's single-process replication)."""
    if not batch_spec(mesh) or global_n % mesh.data_size:
        return slice(0, global_n)
    return process_local_slice(global_n, mesh)


def shard_batch(frames: torch.Tensor, t: torch.Tensor, mesh: Mesh):
    """This rank's rows of the global batch (frames [B, H, W, 3], t [B])."""
    sl = local_batch(frames.shape[0], mesh)
    return frames[sl], t[sl]


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> list:
    """Broadcast each tensor from rank 0, in place."""
    tensors = list(tensors)
    if mesh.world_size > 1:
        for t in tensors:
            dist.broadcast(t, src=0)
    return tensors


def params_specs(state: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, Optional[int]]:
    """The dim along which each entry of a whole model's ``state_dict()``
    splits over the model axis, or None (replicated): JAX's ``params_specs``
    over the reference's names and PyTorch's layouts.  The stem's first
    linear is column parallel (JAX's ``dout``: torch dim 0, its bias too),
    its later ones row parallel (JAX's ``din``: torch dim 1); a conv weight
    (JAX's HWIO split on O: OIHW dim 0) splits, its bias, the heads' and the
    norms' 1-D leaves do not (nor ECB's ``scale``, 1-D in JAX).  A dim splits
    where the model axis has more than one rank and divides it."""
    m = mesh.model_size

    def spec(name: str, t: torch.Tensor) -> Optional[int]:
        if name.startswith("stem."):
            layer = int(name.split(".")[1]) // 2  # stem.{2i}.*: linear i
            if name.endswith(".weight"):
                dout, din = t.shape
                if layer == 0 and divides(dout, m):
                    return 0
                return 1 if layer > 0 and divides(din, m) else None
            return 0 if layer == 0 and divides(t.shape[0], m) else None
        if t.dim() == 4 and not name.endswith(".scale") and divides(t.shape[0], m):
            return 0
        return None

    return {k: spec(k, v) for k, v in state.items()}


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole model's state (``params_specs``), the
    replicated entries as they are."""
    specs = params_specs(state, mesh)
    return {k: v if specs[k] is None else mesh.model_slice(v, specs[k]) for k, v in state.items()}


def _gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def gather_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[int]],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A whole model's state from every rank's shards (``state`` of the
    model that ``shard_train_state`` made, or a snapshot of it): every rank
    of the model group must call it."""
    return {k: v if specs[k] is None else _gather(v.detach(), specs[k], mesh)
            for k, v in state.items()}


def _relayout(state: TrainState, specs: Mapping[str, Optional[int]], mesh: Mesh,
              each) -> TrainState:
    """``state`` with every split parameter and its Adam moments replaced by
    ``each(tensor, dim)`` (a slice, or a gather): the parameters in place in
    a copy of the model, the moments in a new optimizer."""
    model = copy.deepcopy(state.model)
    old = dict(state.model.named_parameters())
    for name, p in old.items():
        if specs[name] is not None:
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    nn.Parameter(each(p.detach(), specs[name]).clone()))
    new = dict(model.named_parameters())
    opt = make_optimizer_like(state.optimizer, list(new.values()))
    for name, p in old.items():
        st = state.optimizer.state.get(p)
        if not st:
            continue
        d = specs[name]
        opt.state[new[name]] = {
            k: (each(v, d).clone() if d is not None and torch.is_tensor(v) and v.shape == p.shape
                else v.clone() if torch.is_tensor(v) else v)
            for k, v in st.items()}
    return TrainState(model, opt, state.step)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Lay out an existing whole state (fresh, resumed, or from ``--weight``)
    over the mesh, keeping its values: rank 0's parameters, buffers, Adam
    moments and step count go to every rank; then, under a model axis, each
    rank keeps its slices of the leaves ``params_specs`` splits and of their
    moments (the model then carries ``shard_specs``)."""
    opt = state.optimizer
    tensors = [v for v in state.model.state_dict().values()]
    for p in state.model.parameters():
        tensors.extend(v for _, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v))
    replicate([t.data for t in tensors], mesh)
    step = torch.tensor([state.step], dtype=torch.long, device=mesh.device)
    replicate([step], mesh)
    state.step = int(step.item())
    if mesh.model_size == 1:
        return state
    specs = params_specs(state.model.state_dict(), mesh)
    state = _relayout(state, specs, mesh, mesh.model_slice)
    state.model.shard_specs = specs
    return state


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole state on every rank from the shards of ``shard_train_state``
    (a plain model and its Adam; ``state`` itself as it is without a model
    axis).  Every rank of the model group must call it."""
    specs = state.model.shard_specs
    if specs is None:
        return state
    full = _relayout(state, specs, mesh, lambda t, d: _gather(t, d, mesh))
    full.model.shard_specs = None
    return full


def gather_model(model: Generator, mesh: Mesh, into: Optional[Generator] = None) -> Generator:
    """The whole model on every rank from ``model``'s shards: their gathered
    weights loaded into ``into`` (a whole ``Generator`` of ``model``'s
    config, made here when None), for evaluation; ``model`` itself without a
    model axis.  Adam's state is not gathered.  Every rank of the model
    group must call it."""
    if model.shard_specs is None:
        return model
    if into is None:
        into = Generator(model.cfg, device=mesh.device)
        into.train(model.training)
    into.load_state_dict(gather_state_dict(model.state_dict(), model.shard_specs, mesh))
    return into


def make_sharded_train_state(cfg: TrainConfig, mesh: Mesh) -> TrainState:
    """A fresh state on this rank's device: the seed's whole model on every
    rank, then its slices (JAX's init-then-shard: the weights a plain run
    starts from)."""
    return shard_train_state(init_train_state(cfg, mesh.device), mesh)


def collective_forward(cfg: TrainConfig, mesh: Mesh) -> bool:
    """The step's forward runs collectives (a model axis, or ``--norm bn``
    over data ranks): it runs eagerly, outside any CUDA graph."""
    return mesh.model_size > 1 or (cfg.model.norm == "bn" and mesh.data_size > 1)


class DataParallelUpdate:
    """The data-parallel step in three parts: ``forward_backward`` (this
    rank's rows, and under a model axis its shards; gradients and metrics
    into one flat bucket), ``reduce`` (one all-reduce of the bucket over the
    data group) and ``apply`` (the average over the data axis, the prune
    masks and Adam; returns the step's metrics).  The bucket is [gradients of
    every parameter in ``parameters()`` order, loss, MSE per stage, MS-SSIM
    per stage]; after ``forward_backward`` each ``.grad`` is a view of it."""

    def __init__(self, cfg: TrainConfig, with_msssim: bool, param_transform, mesh: Mesh):
        self.mesh = mesh
        self.with_msssim = with_msssim
        self.n_stage = sum(head_plan(cfg.model))
        self.collective = collective_forward(cfg, mesh)
        self._forward_backward = _make_forward_backward(cfg, param_transform,
                                                        mesh if self.collective else None)
        self.bucket: Optional[torch.Tensor] = None
        self._views: list = []
        self._key = None
        self.n_grad = 0

    def forward_backward_fn(self, state: TrainState, frames, t):
        """``train/loop.py``'s forward-backward: over the mesh (on the
        model's shards under a model axis; the global batch statistics of
        ``--norm bn``) where the forward runs collectives."""
        if self.mesh.model_size > 1 and state.model.shard_specs is None:
            raise ValueError("a model axis of more than one rank trains the shards of "
                             "shard_train_state / make_sharded_train_state, not a whole model")
        return self._forward_backward(state, frames, t)

    def _bucket(self, params: list) -> torch.Tensor:
        key = tuple((p.data_ptr(), p.shape, p.dtype) for p in params)
        if key != self._key:
            if any(p.dtype != torch.float32 for p in params):
                raise TypeError("the gradient bucket holds f32 parameters only")
            self.n_grad = sum(p.numel() for p in params)
            n = self.n_grad + 1 + self.n_stage * (2 if self.with_msssim else 1)
            self.bucket = torch.zeros(n, dtype=torch.float32, device=params[0].device)
            chunks = self.bucket[: self.n_grad].split([p.numel() for p in params])
            self._views = [c.view_as(p) for c, p in zip(chunks, params)]
            self._key = key
        return self.bucket

    def forward_backward(self, state: TrainState, frames: torch.Tensor, t: torch.Tensor) -> None:
        outs, targets, loss = self.forward_backward_fn(state, frames, t)
        params = list(state.model.parameters())
        bucket = self._bucket(params)
        with torch.no_grad():
            parts = []
            for p in params:
                if p.grad is None:
                    raise RuntimeError("data-parallel step: a parameter got no gradient")
                parts.append(p.grad.reshape(-1))
            parts.append(loss.reshape(1))
            parts.append(torch.stack([torch.mean((o.float() - tg.float()) ** 2)
                                      for o, tg in zip(outs, targets)]))
            if self.with_msssim:
                from ..ops.metrics import msssim_fn

                parts.append(msssim_fn(outs, targets)[0])
            torch.cat(parts, out=bucket)
            for p, v in zip(params, self._views):
                p.grad = v

    def reduce(self) -> None:
        dist.all_reduce(self.bucket, op=dist.ReduceOp.SUM, group=self.mesh.data_group)

    def apply(self, state: TrainState, masks: Masks, lr) -> dict:
        """The average over the data axis (gloo has no AVG: SUM, then / its
        size), the update, and the step's metrics as device tensors."""
        n, s = self.n_grad, self.n_stage
        with torch.no_grad():
            self.bucket.div_(self.mesh.data_size)
        apply_update(state, masks, lr)
        with torch.no_grad():
            # copies: the next step overwrites the bucket
            aux = {"loss": self.bucket[n].clone(),
                   "psnr": -10.0 * torch.log10(self.bucket[n + 1 : n + 1 + s])}
            if self.with_msssim:
                aux["msssim"] = self.bucket[n + 1 + s : n + 1 + 2 * s].clone()
        return aux


def make_sharded_train_step(cfg: TrainConfig, steps_per_epoch: int, mesh: Mesh, *,
                            with_msssim: bool = False, param_transform=None):
    """The train step over a mesh: ``step(state, frames, t, masks)`` on this
    rank's rows of the batch (``run_epoch`` hands it them: it reads the
    step's ``mesh``) and, under a model axis, on the shards of ``state``
    (``make_sharded_train_state``) -> (state, aux), aux as
    ``build_train_step_fn``'s, the metrics those of the global batch.  It
    runs eagerly on the card too, unlike ``make_train_step``'s graph step
    (the collectives inside a CUDA graph are ROADMAP A12)."""
    schedule = _schedule(cfg, steps_per_epoch)
    dp = DataParallelUpdate(cfg, with_msssim, param_transform, mesh)

    def step_fn(state: TrainState, frames, t, masks: Masks = None):
        lr = float(lr_at_step(state.step, **schedule))
        dp.forward_backward(state, frames, t)
        dp.reduce()
        aux = dp.apply(state, masks, lr)
        aux["lr"] = lr
        state.step += 1
        return state, aux

    step_fn.mesh = mesh
    return step_fn


class ShardedEpoch(FusedEpoch):
    """The fused epoch over a mesh (``make_sharded_epoch_fn``): the same
    call, buffers and graph key as ``FusedEpoch``; it keeps this rank's
    columns of the global batch matrix.  A step is the part before the
    all-reduce, the all-reduce, and the part after it; on the card the two
    parts are two CUDA graphs, replayed around the all-reduce.  A step whose
    forward runs collectives (``collective_forward``: a model axis, or
    ``--norm bn`` over data ranks) runs eagerly on every device."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, with_msssim: bool,
                 param_transform, mesh: Mesh):
        super().__init__(cfg, steps_per_epoch, with_msssim, param_transform)
        self.mesh = mesh
        self.dp = DataParallelUpdate(cfg, with_msssim, param_transform, mesh)

    def _before(self, state: TrainState, store, buf: _StepBuffers, masks: Masks) -> None:
        rows = buf.perm.index_select(0, buf.k).reshape(-1)
        self.dp.forward_backward(state, self._frames(store, buf, rows),
                                 buf.t_all.index_select(0, rows))

    def _after(self, state: TrainState, buf: _StepBuffers, masks: Masks) -> None:
        k = buf.k
        aux = self.dp.apply(state, masks, buf.lr.index_select(0, k).reshape(()))
        with torch.no_grad():
            buf.loss.index_copy_(0, k, aux["loss"].reshape(1))
            buf.psnr.index_copy_(0, k, aux["psnr"].reshape(1, -1))
            if buf.msssim is not None:
                buf.msssim.index_copy_(0, k, aux["msssim"].reshape(1, -1))
        k.add_(1)

    def step(self, state: TrainState, store, buf: _StepBuffers, masks: Masks) -> None:
        self._before(state, store, buf, masks)
        self.dp.reduce()
        self._after(state, buf, masks)

    def _held(self, store) -> list:
        return super()._held(store) + [self.dp.bucket]

    def _capture_graphs(self, state: TrainState, store, buf: _StepBuffers, masks: Masks, stream):
        # thread-local: the process group's own threads (NCCL's watchdog
        # queries its events) may call CUDA while this thread captures
        before, after = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with capture_graph(before, stream, capture_error_mode="thread_local"):
            self._before(state, store, buf, masks)
        with capture_graph(after, stream, capture_error_mode="thread_local"):
            self._after(state, buf, masks)
        return before, after

    def _steps(self, state: TrainState, store, buf: _StepBuffers, masks: Masks, n: int) -> None:
        if not self.dp.collective:
            return super()._steps(state, store, buf, masks, n)
        for _ in range(n):
            self.step(state, store, buf, masks)

    def _replay(self) -> None:
        before, after = self.graph
        before.replay()
        self.dp.reduce()
        after.replay()

    def __call__(self, state: TrainState, store, perm, masks: Masks):
        return super().__call__(state, store, perm[:, local_batch(perm.shape[1], self.mesh)],
                                masks)


def make_sharded_epoch_fn(cfg: TrainConfig, steps_per_epoch: int, mesh: Mesh, *,
                          with_msssim: bool = False, param_transform=None) -> ShardedEpoch:
    """The whole-epoch train function over a mesh: ``run_fused_epoch`` drives
    it with the global batch matrix of the epoch, the same on every rank."""
    return ShardedEpoch(cfg, steps_per_epoch, with_msssim, param_transform, mesh)


def make_sharded_video_decode_fn(cfg: TrainConfig, mesh: Mesh, *, keep_frames: bool = False,
                                 local: bool = False):
    """``run(model, t_batches [n_batches, B])``: each rank decodes its
    columns of every batch (B must divide by the data axis) with the whole
    ``model``, through one ``make_video_decode_fn`` that lives as long as
    ``run`` (on the card: a CUDA graph replay a batch).  Returns the
    per-batch checksums [n_batches], summed over the data group (the one
    collective, outside the graph), or with ``keep_frames`` the frames
    [n_batches, B, H, W, 3] gathered from it.  With ``local`` it stops
    before the collective: this rank's checksums (or frames), on its own
    stream, for ``reduce_decode_reps`` to sum once after a timed loop."""
    n_dev = mesh.data_size
    decode = make_video_decode_fn(cfg, keep_frames=keep_frames)

    def run(model, t_batches: torch.Tensor) -> torch.Tensor:
        n, b = t_batches.shape
        if b % n_dev:
            raise ValueError(f"decode batch {b} does not divide by the data axis ({n_dev})")
        ys = decode(model, t_batches[:, process_local_slice(b, mesh)])
        if local:
            return ys
        if not keep_frames:
            dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=mesh.data_group)
            return ys
        if n_dev == 1:
            return ys
        parts = [torch.empty_like(ys) for _ in range(n_dev)]
        dist.all_gather(parts, ys.contiguous(), group=mesh.data_group)
        return torch.cat(parts, dim=1)

    return run


def reduce_decode_reps(times: Sequence[float], checksums: torch.Tensor, mesh: Mesh):
    """The collectives of a timed sharded decode, once, after its loop:
    each rep's seconds as its slowest rank's (a max over the data group) and
    the reps' local checksums [reps, n_batches] summed over it.  A
    collective inside the timed window would time its own latency and that
    of the host threads that drive it (PERF.md, C23)."""
    t = torch.tensor(list(times), dtype=torch.float64, device=checksums.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.data_group)
    dist.all_reduce(checksums, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return t.tolist(), checksums


def make_sharded_decode(cfg: TrainConfig, mesh: Mesh):
    """``decode(model, t [B]) -> frames [B, H, W, 3]``, each rank rendering
    its frames of the batch (one graph replay a call on the card), gathered."""
    run = make_sharded_video_decode_fn(cfg, mesh, keep_frames=True)

    def decode(model, t: torch.Tensor) -> torch.Tensor:
        return run(model, t.reshape(1, -1))[0]

    return decode
