"""Checkpoints (port of ``repnerv_tpu/train/checkpoint.py``) and the weight
bridge between the JAX package's parameter pytree and the port's modules.

Both sides name tensors as the reference PyTorch model does
(``stem.{2i}.weight``, ``layers.{li}.rbr_3x3_branch.weight``,
``head_layers.{hi}.weight``, ...), so a state built here loads into a
``Generator`` with ``strict=True``.

* ``.pth`` files keep the reference's dict layout, ``{"state_dict": ...,
  **extra}`` (epoch and the best metrics), and are what the JAX package's
  ``save_pth`` writes;
* the resume file (``resume_latest.pt``) takes the place of the JAX
  package's Orbax state: model, optimizer, global step and epoch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..models.generator import Generator, Int8Entry, int8_entry

# JAX branch-param key -> reference nn.Module attribute
BRANCH_NAME_MAP = {
    "branch": "branch",
    "k3x3": "rbr_3x3_branch",
    "k3x1": "rbr_3x1_branch",
    "k1x3": "rbr_1x3_branch",
    "k1x1": "rbr_1x1_branch",
    "seq_1x1_a": "rbr_1x1_3x3_1x1_branch_1x1_1",
    "seq_1x1_b": "rbr_1x1_3x3_1x1_branch_1x1_2",
    "seq_1x1": "rbr_1x1_3x3_branch_1x1",
    "seq_3x3": "rbr_1x1_3x3_branch_3x3",
    "avg_1x1": "rbr_1x1_avg_branch_1x1",
    "sbx": "rbr_conv1x1_sbx_branch",
    "sby": "rbr_conv1x1_sby_branch",
    "lpl": "rbr_conv1x1_lpl_branch",
    "rbr_reparam": "rbr_reparam",
}


def _torch_name(key: str, branch_type: str) -> str:
    if key == "seq_3x3" and branch_type == "ERB":
        return "rbr_1x1_3x3_1x1_branch_3x3"  # ERB's middle 3x3 has its own name
    return BRANCH_NAME_MAP[key]


def state_from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """JAX params pytree (leaves as numpy arrays) -> the port's state dict:
    HWIO conv -> OIHW, [in, out] linear -> [out, in]."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(tree["stem"]):
        out[f"stem.{2 * i}.weight"] = np.asarray(layer["w"]).T
        if "b" in layer:
            out[f"stem.{2 * i}.bias"] = np.asarray(layer["b"])

    for li, block in enumerate(tree["blocks"]):
        for key, sub in block.items():
            if key == "norm":
                if sub:
                    out[f"layers.{li}.norm.weight"] = np.asarray(sub["scale"])
                    out[f"layers.{li}.norm.bias"] = np.asarray(sub["bias"])
                    out[f"layers.{li}.norm.running_mean"] = np.asarray(sub["mean"])
                    out[f"layers.{li}.norm.running_var"] = np.asarray(sub["var"])
                continue
            name = f"layers.{li}.{_torch_name(key, cfg.branch_type)}"
            if key in ("sbx", "sby", "lpl"):
                out[f"{name}.k0"] = np.asarray(sub["k0"]).transpose(3, 2, 0, 1)
                out[f"{name}.b0"] = np.asarray(sub["b0"])
                out[f"{name}.scale"] = np.asarray(sub["scale"]).reshape(-1, 1, 1, 1)
                out[f"{name}.bias"] = np.asarray(sub["bias"])
            else:
                out[f"{name}.weight"] = np.asarray(sub["w"]).transpose(3, 2, 0, 1)
                if "b" in sub:
                    out[f"{name}.bias"] = np.asarray(sub["b"])

    for hi, head in enumerate(tree["heads"]):
        if head is not None:
            out[f"head_layers.{hi}.weight"] = np.asarray(head["w"]).transpose(3, 2, 0, 1)
            if "b" in head:
                out[f"head_layers.{hi}.bias"] = np.asarray(head["b"])
    return out


def int8_tables_from_jax(
    table: Mapping[str, Mapping[str, Any]], gen: Generator
) -> Dict[str, Int8Entry]:
    """A JAX params' ``"int8"`` subtree (leaves as numpy arrays) -> the int8
    decode tables of ``gen`` (``Generator.int8``, on its device, the last
    block packed with its head), the same values: the layouts agree (w_q is
    HWIO on both sides)."""
    device = next(gen.parameters()).device

    def t(v):
        return torch.from_numpy(np.array(v)).to(device) if v is not None else None

    return {
        k: int8_entry(gen, int(k), t(e["w_q"]), t(e["scale"]), t(e["in_scale"]),
                      t(e.get("b")), t(e.get("out_scale")))
        for k, e in table.items()
    }


def load_state(model: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a numpy state dict into ``model`` (on its device), strict=True.
    A deploy-state artifact needs a deploy model (``cfg.deploy``) and a
    train-state artifact a model with branches."""
    device = next(model.parameters()).device
    tensors = {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in state.items()
    }
    model.load_state_dict(tensors, strict=True)
    return model


def save_pth(path: str, state: Mapping[str, torch.Tensor], extra: Optional[dict] = None) -> None:
    """Write ``{"state_dict": <CPU tensors>, **extra}`` from a state dict."""
    ckpt = {"state_dict": {k: v.detach().cpu() for k, v in state.items()}}
    if extra:
        ckpt.update(extra)
    torch.save(ckpt, path)


def load_pth(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a reference-layout ``.pth`` -> (numpy state for ``load_state``,
    extra).  Drops a ``module.`` (DDP) prefix and thop's
    ``total_ops``/``total_params`` entries, as the JAX package does."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in state.items():
        if "total_ops" in k or "total_params" in k:
            continue
        out[k[len("module."):] if k.startswith("module.") else k] = v.numpy()
    extra = {k: v for k, v in ckpt.items() if k != "state_dict"}
    return out, extra


RESUME_FILE = "resume_latest.pt"


def save_resume(outf: str, model: nn.Module, optimizer: torch.optim.Optimizer, step: int,
                epoch: int) -> None:
    """Write the resumable training state (atomically: a cut run never leaves
    a partial file)."""
    path = os.path.join(outf, RESUME_FILE)
    tmp = path + ".tmp"
    torch.save(
        {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
         "step": int(step), "epoch": int(epoch)},
        tmp,
    )
    os.replace(tmp, path)


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: Mapping[str, Any]) -> None:
    """Load a saved ``optimizer.state_dict()`` into ``optimizer`` and keep
    its own settings: the learning-rate tensor and the ``fused`` /
    ``capturable`` flags of ``train/loop.py::make_optimizer`` stay (torch's
    ``load_state_dict`` would take the file's), and every Adam step count
    goes where they want it (on the parameter's device for fused or
    capturable Adam, else on the host).  So a file written by either kind of
    optimizer, on the card or on the CPU, loads into the other.  It makes new
    state tensors: a captured train step must be captured after it."""
    own = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, settings in zip(optimizer.param_groups, own):
        group.update(settings)
        on_device = group.get("fused") or group.get("capturable")
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device if on_device else "cpu", torch.float32)


def load_resume(outf: str, model: nn.Module, optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    """Load the resume file into ``model`` and ``optimizer``
    (``load_optimizer_state``); return (step, epoch)."""
    device = next(model.parameters()).device
    ckpt = torch.load(os.path.join(outf, RESUME_FILE), map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    load_optimizer_state(optimizer, ckpt["optimizer"])
    return int(ckpt["step"]), int(ckpt["epoch"])
