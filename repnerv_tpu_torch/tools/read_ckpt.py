"""Checkpoint inspector (port of ``repnerv_tpu/tools/read_ckpt.py``, itself
the reference's read_pth.py).

Reads a PyTorch ``.pth`` (the reference's layout, loaded ``weights_only``),
the port's resume file (``resume_latest.pt``: its model state) or a ``.rnvb``
compressed bitstream (``compress/bitstream.py``).  Prints the top-level
keys, a state-dict preview (name / shape / dtype), tensor and element
counts, and the same structural notes: ``module.`` prefix (DDP),
``rbr_reparam`` (deploy state), ERB branch names (train state).  For
``.rnvb`` it also prints the codec, the quantization grid, the payload bits
and the size on disk.  The JAX package's Orbax directories are not read:
the port resumes from ``resume_latest.pt``.

    python -m repnerv_tpu_torch.tools.read_ckpt path [--limit N]
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict


def _load_pth(path: str) -> Any:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def summarize_state_dict(state: Dict[str, Any], limit: int = 20) -> Dict[str, Any]:
    n_tensors = 0
    n_elems = 0
    lines = []
    for i, (k, v) in enumerate(state.items()):
        shape = tuple(getattr(v, "shape", ()))
        dtype = getattr(v, "dtype", type(v).__name__)
        numel = 1
        for s in shape:
            numel *= s
        n_tensors += 1
        n_elems += numel
        if i < limit:
            lines.append(f"  {k}: shape={shape} dtype={dtype}")
    return {"tensors": n_tensors, "elements": n_elems, "preview": lines}


def classify(state_keys) -> str:
    keys = list(state_keys)
    notes = []
    if any(k.startswith("module.") for k in keys):
        notes.append("DDP-wrapped ('module.' prefix)")
    if any("rbr_reparam" in k for k in keys):
        notes.append("DEPLOY state (fused rbr_reparam convs)")
    if any("rbr_3x3_branch" in k for k in keys):
        notes.append("TRAIN state (multi-branch reparam convs)")
    if any(k.startswith("layers.") and ".branch." in k for k in keys):
        notes.append("TRAIN state (NeRV_vanilla single branch)")
    return "; ".join(notes) if notes else "unclassified"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--limit", type=int, default=20)
    args = p.parse_args(argv)

    if os.path.isdir(args.path):
        raise SystemExit(
            f"{args.path} is a directory: Orbax checkpoints are the JAX package's and are not "
            "ported (the port resumes from resume_latest.pt)"
        )

    if args.path.endswith(".rnvb"):
        from ..compress.bitstream import read_bitstream

        params, mcfg, header = read_bitstream(args.path)
        size = os.path.getsize(args.path)
        print(f"RNVB bitstream: {args.path}")
        print(
            f"codec={header['codec']} quant_bit={header['quant_bit']} "
            f"quant_axis={header['quant_axis']} "
            f"symbols={header['n_symbols']:,} "
            f"payload_bits={header['payload_bits']:,}"
        )
        print(
            f"on-disk: {size:,} bytes "
            f"(payload {header['payload_bits'] / 8 / size:.1%}, rest = "
            "header/codec table/qparams/sparsity bitmaps)"
        )
        print(f"model: branch={mcfg.branch_type} deploy={mcfg.deploy}")
        tensors = header["tensors"]
        print(f"Tensors: {len(tensors)}")
        for t in tensors[: args.limit]:
            print(
                f"  {t['key']}: shape={tuple(t['shape'])} axis={t['axis']} "
                f"zeros={t['n_zero']}/{t['n_elem']}"
            )
        if len(tensors) > args.limit:
            print(f"  ... ({len(tensors) - args.limit} more)")
        print(f"Structure: {classify(t['key'] for t in tensors)}")
        return

    ckpt = _load_pth(args.path)
    print(f"Checkpoint: {args.path}")
    if isinstance(ckpt, dict):
        print(f"Top-level keys: {list(ckpt.keys())}")
        # a .pth keeps its tensors under "state_dict", the resume file under "model"
        state = ckpt.get("state_dict", ckpt.get("model", ckpt))
    else:
        state = ckpt
    if hasattr(state, "items"):
        info = summarize_state_dict(state, args.limit)
        print(f"Tensors: {info['tensors']}  Elements: {info['elements']:,}")
        for line in info["preview"]:
            print(line)
        if info["tensors"] > args.limit:
            print(f"  ... ({info['tensors'] - args.limit} more)")
        print(f"Structure: {classify(state.keys())}")


if __name__ == "__main__":
    main()
