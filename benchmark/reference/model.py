"""Plain PyTorch reference of the NeRV generator the benchmark runs.

Written from the papers' equations (NeRV, arXiv:2110.13903; Online-RepNeRV,
arXiv:2511.11071, and the branch blocks it takes: ACNet, arXiv:1908.03930;
RepVGG, arXiv:2101.03697; DBB, arXiv:2103.13425; ECBSR's Edge-oriented
Convolution Block, Zhang, Zeng & Zhang, ACM MM 2021) with the reference
implementation's tensor names, in NCHW and float32 with TF32 off.  It
imports nothing of the program: it takes the benchmark's raw inputs
(weights drawn from the seed by name, frame times) and works out for itself
what the program derives from them (the deploy fold, the int8 tables).

    frame index t -> PE(t) = [sin(t b^i pi), cos(t b^i pi)]_{i < levels}
      -> MLP stem (Linear + act per layer) -> view [B, c, h, w]
      -> per block: conv (the sum of the branch type's branches, each run
         as itself: ``branches``) -> PixelShuffle(s) -> act
      -> 1x1 head -> (tanh + 1) / 2.

The branch types as Online-RepNeRV's code defines them, which departs from
the papers in three ways: no branch has a BatchNorm, RepVGG has no identity
branch, and DBB's average-pool branch starts with a bias-free 1x1 conv.

``prec`` selects the rounding of every conv's and linear's operands: None
(f32), "fp8" (e4m3 with one scale a tensor) or, for int8 blocks, "int4".
The lower precisions exist only for the control: the reference computed
one precision below what the configuration states, in the program's
place.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn

# ECBSR's edge masks, by the name of the edge branch that applies each
SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = tuple(zip(*SOBEL_X))
LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
EDGES = {"rbr_conv1x1_sbx_branch": SOBEL_X, "rbr_conv1x1_sby_branch": SOBEL_Y,
         "rbr_conv1x1_lpl_branch": LAPLACIAN}
# the fan-in whose uniform bound 1/sqrt(fan) is sqrt(3) 1e-3: the standard
# deviation 1e-3 of an edge branch's ``scale`` and ``bias`` (randn * 1e-3)
EDGE_FAN = 1.0 / 3e-6


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
    block) and norm "none" are modelled.  An edge branch's ``scale`` and
    ``bias`` take the fan-in ``EDGE_FAN``: uniform within +-sqrt(3) 1e-3,
    the standard deviation of the reference's randn * 1e-3."""
    if not m["single_res"] or m["norm"] != "none" or m.get("num_blocks", 1) != 1:
        raise ValueError("the reference models single_res, norm none, one block a stage")
    d = dims(m)
    out = []
    for i, (a, b) in enumerate(zip(d["stem"][:-1], d["stem"][1:])):
        out += [(f"stem.{2 * i}.weight", (b, a), a), (f"stem.{2 * i}.bias", (b,), a)]
    for i, (cin, new, s) in enumerate(d["blocks"]):
        for name, br in branches(m["branch_type"], cin, new * s * s).items():
            pre, fan, co = f"layers.{i}.{name}", br.cin * br.kh * br.kw, br.cout
            if br.kind == "edge":
                out += [(f"{pre}.k0", (co, br.cin, 1, 1), fan), (f"{pre}.b0", (co,), fan),
                        (f"{pre}.scale", (co, 1, 1, 1), EDGE_FAN), (f"{pre}.bias", (co,), EDGE_FAN)]
                continue
            out.append((f"{pre}.weight", (co, br.cin, br.kh, br.kw), fan))
            if br.bias:
                out.append((f"{pre}.bias", (co,), fan))
    last = len(d["blocks"]) - 1
    c = d["blocks"][-1][1]
    out += [(f"head_layers.{last}.weight", (3, c, 1, 1), c), (f"head_layers.{last}.bias", (3,), c)]
    return out


class Branch(NamedTuple):
    """One branch of a block, or one conv of a branch that is a chain.

    ``kind``: "conv", a kh x kw conv (with its bias if ``bias``); "chain",
    one bias-free conv of a chain, which runs on the chain's last output
    (the block's input for the first), consecutive ones forming one chain;
    "avg", a bias-free 1x1 conv then AvgPool2d(3, 1, 1) counting the
    padding; "edge", ECB's SeqConv3x3: a 1x1 conv ``k0`` with bias ``b0``,
    a one-pixel border filled with ``b0``, then a depthwise 3x3 conv with
    the weight ``scale`` times ``mask`` and the bias ``bias``."""

    kind: str
    kh: int
    kw: int
    cin: int
    cout: int
    bias: bool = False
    mask: Optional[tuple] = None


def branches(branch_type: str, cin: int, cout: int) -> Dict[str, Branch]:
    """A block's branches by name, in the order the branch sum adds them
    (a chain where its last conv is)."""
    def conv(kh, kw, bias=True):
        return Branch("conv", kh, kw, cin, cout, bias)

    chain = {"rbr_1x1_3x3_branch_1x1": Branch("chain", 1, 1, cin, 2 * cin),
             "rbr_1x1_3x3_branch_3x3": Branch("chain", 3, 3, 2 * cin, cout)}
    if branch_type == "NeRV_vanilla":
        return {"branch": conv(3, 3)}
    if branch_type in ("ACB", "ERB"):
        out = {"rbr_3x3_branch": conv(3, 3), "rbr_3x1_branch": conv(3, 1),
               "rbr_1x3_branch": conv(1, 3)}
        if branch_type == "ERB":
            out.update({
                "rbr_1x1_3x3_1x1_branch_1x1_1": Branch("chain", 1, 1, cin, 2 * cin),
                "rbr_1x1_3x3_1x1_branch_3x3": Branch("chain", 3, 3, 2 * cin, cout),
                "rbr_1x1_3x3_1x1_branch_1x1_2": Branch("chain", 1, 1, cout, cout)})
        return out
    if branch_type == "RepVGG":
        return {"rbr_3x3_branch": conv(3, 3), "rbr_1x1_branch": conv(1, 1)}
    if branch_type == "DBB":
        return {"rbr_3x3_branch": conv(3, 3), "rbr_1x1_branch": conv(1, 1), **chain,
                "rbr_1x1_avg_branch_1x1": Branch("avg", 1, 1, cin, cout)}
    if branch_type == "ECB":
        return {"rbr_3x3_branch": conv(3, 3), **chain,
                **{name: Branch("edge", 1, 1, cin, cout, mask=mask)
                   for name, mask in EDGES.items()}}
    raise ValueError(f"the reference models NeRV_vanilla, ERB, ACB, RepVGG, DBB and ECB, "
                     f"not {branch_type}")


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
    """Block ``i``'s conv as the sum of its branches, each run as itself."""
    cin, new, s = dims(m)["blocks"][i]
    out, chain = None, None
    for name, br in branches(m["branch_type"], cin, new * s * s).items():
        pre = f"layers.{i}.{name}"
        if br.kind == "chain":
            chain = F.conv2d(rounded(x if chain is None else chain, prec),
                             rounded(p[f"{pre}.weight"], prec), None,
                             padding=(br.kh // 2, br.kw // 2))
            continue
        if chain is not None:  # the chain ended at the conv before
            out, chain = out + chain, None
        if br.kind == "edge":
            y = edge_branch(p, pre, br.mask, x, prec)
        elif br.kind == "avg":
            y = F.avg_pool2d(F.conv2d(rounded(x, prec), rounded(p[f"{pre}.weight"], prec)),
                             3, stride=1, padding=1, count_include_pad=True)
        else:
            y = F.conv2d(rounded(x, prec), rounded(p[f"{pre}.weight"], prec),
                         p.get(f"{pre}.bias") if br.bias else None,
                         padding=(br.kh // 2, br.kw // 2))
        out = y if out is None else out + y
    return out if chain is None else out + chain


def edge_branch(p: Params, pre: str, mask: tuple, x: torch.Tensor,
                prec: Optional[str] = None) -> torch.Tensor:
    """ECB's SeqConv3x3 edge branch ``pre`` on ``x``: the 1x1 conv, its
    output framed by a one-pixel border of ``b0``, and the depthwise conv of
    ``scale * mask`` with ``bias`` over it (VALID, so the size is kept)."""
    b0 = p[f"{pre}.b0"]
    y = F.pad(F.conv2d(rounded(x, prec), rounded(p[f"{pre}.k0"], prec), b0), (1, 1, 1, 1))
    border = torch.ones(y.shape[2:], dtype=torch.bool, device=y.device)
    border[1:-1, 1:-1] = False
    y = torch.where(border, b0[None, :, None, None], y)
    w = p[f"{pre}.scale"] * torch.tensor(mask, dtype=y.dtype, device=y.device)
    return F.conv2d(rounded(y, prec), rounded(w, prec), p[f"{pre}.bias"], groups=w.shape[0])


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
    [O]), summed in float64 in ``branches``' order and rounded to f32 once.
    A kh x kw conv is a 3x3 one with zero rows and columns; a bias-free
    chain is its kernels contracted over the inner channels
    (``_contract``); the average branch, a 3x3 mean counting the padding
    after a bias-free 1x1 conv W, is W / 9 on every tap; an edge branch is
    the kernel ``k0 * scale * mask`` and the bias
    ``b0 * sum(scale * mask) + bias`` (``b0``'s border makes the map
    ``k0 x + b0`` everywhere).  Every mask sums to 0, so ``b0`` adds nothing
    and its gradient is zero by algebra: round-off alone moves it under
    Adam, and the check's ``TINY_GRAD`` rule leaves it out of the change."""
    folded, dev = [], p["stem.0.weight"].device
    for i, (cin, new, s) in enumerate(dims(m)["blocks"]):
        def t(name):
            return p[f"layers.{i}.{name}"].double()
        o = new * s * s
        k = torch.zeros(o, cin, 3, 3, dtype=torch.float64, device=dev)
        bias = torch.zeros(o, dtype=torch.float64, device=dev)
        chain = []
        for name, br in branches(m["branch_type"], cin, o).items():
            if br.kind == "chain":
                chain.append(t(f"{name}.weight"))
                continue
            if chain:  # the chain ended at the conv before
                k, chain = k + _contract(chain), []
            if br.kind == "edge":
                scaled = t(f"{name}.scale") * torch.tensor(br.mask, dtype=k.dtype, device=k.device)
                k = k + t(f"{name}.k0") * scaled  # [O, I, 1, 1] * [O, 1, 3, 3]
                bias = bias + t(f"{name}.b0") * scaled.sum(dim=(1, 2, 3)) + t(f"{name}.bias")
            elif br.kind == "avg":
                k = k + t(f"{name}.weight") / 9.0
            else:
                r, c = 1 - br.kh // 2, 1 - br.kw // 2
                k[:, :, r:r + br.kh, c:c + br.kw] += t(f"{name}.weight")
                bias = bias + t(f"{name}.bias")
        if chain:
            k = k + _contract(chain)
        folded.append((k.float(), bias.float()))
    return folded


def _contract(ws: List[torch.Tensor]) -> torch.Tensor:
    """A bias-free chain, a 1x1 conv, a 3x3 and for ERB another 1x1, as one
    3x3 kernel."""
    w1, w2 = ws[0][:, :, 0, 0], ws[1]  # [M, I], [O, M, 3, 3]
    if len(ws) == 2:
        return torch.einsum("omuv,mi->oiuv", w2, w1)
    return torch.einsum("po,omuv,mi->piuv", ws[2][:, :, 0, 0], w2, w1)


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
