"""Global magnitude pruning (port of ``repnerv_tpu/compress/prune.py``).

Parity target: ``torch.nn.utils.prune.global_unstructured(L1Unstructured)``
over the reference's target modules (main_eval.py:211-648), as the JAX
package selects them: the stem's Linear weights and each block's branch conv
weights (``branch`` / ``rbr_reparam`` for vanilla, all six ERB branches in the
train state, ``rbr_reparam`` in the deploy state); biases never.  One global
threshold over all targets, the k-th smallest |w| by ``np.partition``.

Masks are keyed by parameter name (``train/loop.Masks``): {0, 1} f32
tensors on the model's device for the targets, nothing for the rest.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..train.checkpoint import _torch_name
from ..train.loop import Masks

# JAX branch keys whose weight is pruned, per branch type (the JAX
# package's _PRUNE_BRANCH_KEYS); the port names them through BRANCH_NAME_MAP
PRUNE_BRANCH_KEYS = {
    "NeRV_vanilla": ("branch", "rbr_reparam"),
    "ERB": ("k3x3", "k3x1", "k1x3", "seq_1x1_a", "seq_3x3", "seq_1x1_b", "rbr_reparam"),
    "ACB": ("k3x3", "k3x1", "k1x3", "rbr_reparam"),
    "RepVGG": ("k3x3", "k1x1", "rbr_reparam"),
    "DBB": ("k3x3", "k1x1", "seq_1x1", "seq_3x3", "avg_1x1", "rbr_reparam"),
    "ECB": ("k3x3", "seq_1x1", "seq_3x3", "rbr_reparam"),
}


def target_names(model: nn.Module, branch_type: str) -> List[str]:
    """Names of every prunable weight of ``model``, stem first."""
    params = dict(model.named_parameters())
    names = [n for n in params if n.startswith("stem.") and n.endswith(".weight")]
    for li in range(len(model.layers)):
        for key in PRUNE_BRANCH_KEYS[branch_type]:
            name = f"layers.{li}.{_torch_name(key, branch_type)}.weight"
            if name in params:
                names.append(name)
    return names


def global_l1_masks(model: nn.Module, branch_type: str, prune_ratio: float):
    """-> (masks, actual zero ratio over the targets)."""
    params = dict(model.named_parameters())
    names = target_names(model, branch_type)
    weights = {n: params[n].detach().cpu().numpy() for n in names}
    allw = np.concatenate([np.abs(w).ravel() for w in weights.values()])
    k = int(round(prune_ratio * allw.size))
    if k <= 0:
        thresh = -np.inf
    elif k >= allw.size:
        thresh = np.inf
    else:
        # L1Unstructured removes the k smallest |w|: the threshold is the
        # k-th smallest magnitude, ties pruned
        thresh = np.partition(allw, k - 1)[k - 1]
    masks: Dict[str, torch.Tensor] = {}
    total = zeros = 0
    for n, w in weights.items():
        m = (np.abs(w) > thresh).astype(np.float32)
        total += m.size
        zeros += int(m.size - m.sum())
        masks[n] = torch.from_numpy(m).to(params[n].device)
    return masks, zeros / max(total, 1)


@torch.no_grad()
def apply_masks(model: nn.Module, masks: Masks) -> nn.Module:
    """Zero the pruned weights of ``model`` in place."""
    for name, p in model.named_parameters():
        m = masks.get(name) if masks else None
        if m is not None:
            p.mul_(m.to(p.dtype))
    return model


def verify_ratio(actual: float, requested: float, tol: float = 0.05) -> bool:
    """Mask-ratio self-check, reference tolerance (main_eval.py:276-287)."""
    return actual > 0 and abs(actual - requested) <= tol


def sparsity_report(masks: Masks) -> Dict[str, float]:
    total = sum(m.numel() for m in masks.values())
    zeros = sum(float(m.numel() - m.sum().item()) for m in masks.values())
    return {"target_elems": total, "zeros": zeros, "ratio": zeros / max(total, 1)}
