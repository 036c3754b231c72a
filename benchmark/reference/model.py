"""Plain PyTorch reference of the NeRV generator the benchmark runs.

Written from the papers' equations (NeRV, arXiv:2110.13903; Online-RepNeRV,
arXiv:2511.11071) with the reference implementation's tensor names, in NCHW
and float32 with TF32 off.  It imports nothing of the program: it takes the
benchmark's raw inputs (weights drawn from the seed by name, frame times)
and works out for itself what the program derives from them (the deploy
fold, the int8 tables).

    frame index t -> PE(t) = [sin(t b^i pi), cos(t b^i pi)]_{i < levels}
      -> MLP stem (Linear + act per layer) -> view [B, c, h, w]
      -> per block: conv (NeRV_vanilla: one 3x3; ERB: 3x3 + 3x1 + 1x3
         + (1x1 -> 3x3 -> 1x1), each branch run as itself) -> PixelShuffle(s)
         -> act
      -> 1x1 head -> (tanh + 1) / 2.

``prec`` selects the rounding of every conv's and linear's operands: None
(f32), "fp8" (e4m3 with one scale a tensor) or, for int8 blocks, "int4".
The lower precisions exist only for the control: the reference computed
one precision below what the configuration states, in the program's
place.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_f32():
    """Full-f32 cuDNN convs and matmuls for the duration (no TF32)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def dims(m: dict) -> dict:
    """The sizes a model configuration implies."""
    base, levels = m["embed"].split("_")
    stem_dim, stem_num = (int(v) for v in m["stem_dim_num"].split("_"))
    h, w, c = (int(v) for v in m["fc_hw_dim"].split("_"))
    blocks = []  # (cin, new_ngf, stride): the reference model's channel schedule
    ngf = c
    for i, s in enumerate(m["strides"]):
        if i == 0:
            new = int(ngf * m["expansion"])
        else:
            new = max(ngf // (1 if s == 1 else m["reduction"]), m["lower_width"])
        blocks.append((ngf, new, s))
        ngf = new
    hs, ws = [h], [w]
    for _, _, s in blocks:
        hs.append(hs[-1] * s)
        ws.append(ws[-1] * s)
    return {"base": float(base), "levels": int(levels), "stem": [2 * int(levels)]
            + [stem_dim] * stem_num + [h * w * c], "hwc": (h, w, c), "blocks": blocks,
            "hs": hs, "ws": ws}


def param_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every trained tensor, in the reference
    model's ``state_dict`` names.  Only ``single_res`` (one head at the last
    block) and norm "none" are modelled."""
    if not m["single_res"] or m["norm"] != "none" or m.get("num_blocks", 1) != 1:
        raise ValueError("the reference models single_res, norm none, one block a stage")
    d = dims(m)
    out = []
    for i, (a, b) in enumerate(zip(d["stem"][:-1], d["stem"][1:])):
        out += [(f"stem.{2 * i}.weight", (b, a), a), (f"stem.{2 * i}.bias", (b,), a)]
    for i, (cin, new, s) in enumerate(d["blocks"]):
        cout = new * s * s
        for name, (kh, kw, ci, co, bias) in branches(m["branch_type"], cin, cout).items():
            fan = ci * kh * kw
            out.append((f"layers.{i}.{name}.weight", (co, ci, kh, kw), fan))
            if bias:
                out.append((f"layers.{i}.{name}.bias", (co,), fan))
    last = len(d["blocks"]) - 1
    c = d["blocks"][-1][1]
    out += [(f"head_layers.{last}.weight", (3, c, 1, 1), c), (f"head_layers.{last}.bias", (3,), c)]
    return out


def branches(branch_type: str, cin: int, cout: int) -> Dict[str, tuple]:
    """A block's branches: name -> (kh, kw, in, out, bias), in the order the
    branch sum adds them; ERB's 1x1 -> 3x3 -> 1x1 chain is its last three."""
    if branch_type == "NeRV_vanilla":
        return {"branch": (3, 3, cin, cout, True)}
    if branch_type == "ERB":
        return {
            "rbr_3x3_branch": (3, 3, cin, cout, True),
            "rbr_3x1_branch": (3, 1, cin, cout, True),
            "rbr_1x3_branch": (1, 3, cin, cout, True),
            "rbr_1x1_3x3_1x1_branch_1x1_1": (1, 1, cin, 2 * cin, False),
            "rbr_1x1_3x3_1x1_branch_3x3": (3, 3, 2 * cin, cout, False),
            "rbr_1x1_3x3_1x1_branch_1x1_2": (1, 1, cout, cout, False),
        }
    raise ValueError(f"the reference models NeRV_vanilla and ERB, not {branch_type}")


# ---------------------------------------------------------------------------
# rounding for the control
# ---------------------------------------------------------------------------


class _Straight(torch.autograd.Function):
    """The forward rounds, the backward passes the gradient straight on."""

    @staticmethod
    def forward(ctx, x, q):
        return q

    @staticmethod
    def backward(ctx, g):
        return g, None


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude on the format's largest value), back in f32."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return _Straight.apply(x, q) if x.requires_grad else q


def rounded(x: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    return x if prec is None else fp8(x)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name != "swish":
        raise ValueError(f"the reference models swish, not {name}")
    return x * torch.sigmoid(x)


def positional_encoding(t: torch.Tensor, base: float, levels: int) -> torch.Tensor:
    """[B] -> [B, 2 levels]: sin and cos of (t * base^i) * pi, interleaved,
    in f32."""
    powers = torch.tensor([base ** i for i in range(levels)], dtype=torch.float32,
                          device=t.device)
    phase = (t.float()[:, None] * powers[None]) * torch.tensor(math.pi, dtype=torch.float32)
    return torch.stack([phase.sin(), phase.cos()], dim=-1).reshape(t.shape[0], 2 * levels)


def stem(p: Params, m: dict, t: torch.Tensor, prec: Optional[str] = None) -> torch.Tensor:
    """PE and the MLP stem, viewed as the first feature map [B, c, h, w]."""
    d = dims(m)
    x = positional_encoding(t, d["base"], d["levels"])
    for i in range(len(d["stem"]) - 1):
        w, b = p[f"stem.{2 * i}.weight"], p[f"stem.{2 * i}.bias"]
        x = act(rounded(x, prec) @ rounded(w, prec).t() + b, m["act"])
    h, w_, c = d["hwc"]
    return x.reshape(x.shape[0], c, h, w_)


def block_conv(p: Params, m: dict, i: int, x: torch.Tensor, prec: Optional[str] = None):
    """Block ``i``'s conv as the sum of its branches, each a conv of its own."""
    cin, new, s = dims(m)["blocks"][i]
    out, chain = None, None
    for name, (kh, kw, _, _, bias) in branches(m["branch_type"], cin, new * s * s).items():
        w = rounded(p[f"layers.{i}.{name}.weight"], prec)
        b = p.get(f"layers.{i}.{name}.bias") if bias else None
        if name.startswith("rbr_1x1_3x3_1x1"):
            chain = F.conv2d(rounded(x if chain is None else chain, prec), w, None,
                             padding=(kh // 2, kw // 2))
            continue
        y = F.conv2d(rounded(x, prec), w, b, padding=(kh // 2, kw // 2))
        out = y if out is None else out + y
    return out if chain is None else out + chain


def head(p: Params, m: dict, x: torch.Tensor, prec: Optional[str] = None) -> torch.Tensor:
    last = len(dims(m)["blocks"]) - 1
    y = F.conv2d(rounded(x, prec), rounded(p[f"head_layers.{last}.weight"], prec),
                 p[f"head_layers.{last}.bias"])
    return (torch.tanh(y) + 1.0) * 0.5


def forward(p: Params, m: dict, t: torch.Tensor, prec: Optional[str] = None) -> torch.Tensor:
    """The training model's frames [B, 3, H, W] at times ``t``."""
    x = stem(p, m, t, prec)
    for i, (_, _, s) in enumerate(dims(m)["blocks"]):
        x = act(F.pixel_shuffle(block_conv(p, m, i, x, prec), s), m["act"])
    return head(p, m, x, prec)


# ---------------------------------------------------------------------------
# the deployed model and its int8 tail
# ---------------------------------------------------------------------------


def deploy_fold(p: Params, m: dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each block's branches as one 3x3 conv (weight [O, I, 3, 3], bias
    [O]), summed in float64 and rounded to f32 once: a 3x1 or 1x3 kernel is a
    3x3 one with zero columns or rows, and the bias-free 1x1 -> 3x3 -> 1x1
    chain contracts over its inner channels."""
    folded = []
    for i, (cin, new, s) in enumerate(dims(m)["blocks"]):
        def w(name):
            return p[f"layers.{i}.{name}.weight"].double()

        def b(name):
            return p[f"layers.{i}.{name}.bias"].double()

        if m["branch_type"] == "NeRV_vanilla":
            k, bias = w("branch"), b("branch")
        else:
            k = w("rbr_3x3_branch").clone()
            k[:, :, :, 1:2] += w("rbr_3x1_branch")
            k[:, :, 1:2, :] += w("rbr_1x3_branch")
            w1 = w("rbr_1x1_3x3_1x1_branch_1x1_1")[:, :, 0, 0]  # [2I, I]
            w2 = w("rbr_1x1_3x3_1x1_branch_3x3")  # [O, 2I, 3, 3]
            w3 = w("rbr_1x1_3x3_1x1_branch_1x1_2")[:, :, 0, 0]  # [O, O]
            k += torch.einsum("po,omuv,mi->piuv", w3, w2, w1)
            bias = b("rbr_3x3_branch") + b("rbr_3x1_branch") + b("rbr_1x3_branch")
        folded.append((k.float(), bias.float()))
    return folded


def deploy_forward(p: Params, m: dict, folded, t: torch.Tensor, prec: Optional[str] = None,
                   int8: Optional[dict] = None) -> torch.Tensor:
    """The deployed model's frames [B, 3, H, W]; with ``int8`` (``int8_tables``)
    its trailing blocks in the int8 scheme, ``int8["bits"]`` wide."""
    x = stem(p, m, t, prec)
    n = len(folded)
    codes = None  # the int8 blocks pass integer codes on
    for i, ((k, bias), (_, _, s)) in enumerate(zip(folded, dims(m)["blocks"])):
        if int8 is not None and i >= int8["first"]:
            q = int8["blocks"][i]
            if codes is None:
                codes = quantize(x, q["in_scale"], int8["qmax"])
            acc = F.conv2d(codes.double(), q["w_q"].double(), padding=1).float()
            y = acc * q["scale"][None, :, None, None] + bias[None, :, None, None]
            y = act(F.pixel_shuffle(y, s), m["act"])
            if i < n - 1:
                codes = torch.clamp(torch.round(y * q["inv_out"]), -int8["qmax"], int8["qmax"])
            else:
                x = y
            continue
        x = act(F.pixel_shuffle(F.conv2d(rounded(x, prec), rounded(k, prec), bias, padding=1), s),
                m["act"])
    return head(p, m, x, prec if int8 is None else None)


def quantize(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def int8_tables(p: Params, m: dict, folded, calib_t: torch.Tensor, first_from_end: int,
                bits: int = 8) -> dict:
    """The symmetric scheme of the int8 tail, from a calibration decode in
    f32 over ``calib_t``: per block from ``len + first_from_end`` on, the
    weights per output channel ``sw = amax / qmax``, ``w_q = round(w / sw)``;
    the block's input step ``sx = amax(input) / qmax``; ``scale = sx * sw``;
    and the next block's step, by whose inverse the output is requantized.
    ``bits`` 4 gives the control's int4 tail."""
    qmax = 2 ** (bits - 1) - 1
    n = len(folded)
    first = n + first_from_end
    amax = []
    x = stem(p, m, calib_t)
    for (k, bias), (_, _, s) in zip(folded, dims(m)["blocks"]):
        amax.append(x.abs().amax())
        x = act(F.pixel_shuffle(F.conv2d(x, k, bias, padding=1), s), m["act"])
    blocks = {}
    for i in range(first, n):
        k = folded[i][0]
        sw = k.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / qmax
        in_scale = amax[i].clamp_min(1e-12) / qmax
        blk = {"w_q": quantize(k, sw[:, None, None, None], qmax), "in_scale": in_scale,
               "scale": in_scale * sw}
        if i + 1 < n:
            blk["inv_out"] = 1.0 / (amax[i + 1].clamp_min(1e-12) / qmax)
        blocks[i] = blk
    return {"first": first, "qmax": qmax, "blocks": blocks}
