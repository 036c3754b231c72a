"""The weight bridge between the JAX package's parameter pytree and the
port's modules (the numpy mirror of
``repnerv_tpu.train.checkpoint.params_to_torch_state``).

Both sides name tensors as the reference PyTorch model does
(``stem.{2i}.weight``, ``layers.{li}.rbr_3x3_branch.weight``,
``head_layers.{hi}.weight``, ...), so a state built here loads into a
``Generator`` with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig

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
