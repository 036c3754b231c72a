"""ERB's online reparameterisation on the card: a block's branch fusion in
two launches of ``csrc/reparam_fuse.cu`` and its VJP in two more.

``erb_fold(w3x3, b3x3, w1x3, b1x3, w3x1, b3x1, w1, w2, w3)`` returns what
``models/reparam.py::fuse_erb_plain`` returns, the fused 3x3 kernel
[O, I, 3, 3] (contiguous OIHW) and bias [O], and is differentiable in all
nine tensors.  ``models/reparam.py::fuse_erb`` calls it when ``takes`` holds
(every branch tensor a CUDA f32 tensor on one device, with ERB's shapes);
any other tensors take the plain path.  With w1 [M, I, 1, 1], w2 [Om, M, 3,
3], w3 [Oo, Om, 1, 1] (Oo = Om but for a tensor-parallel view's Cout slice):

* forward launch 1: T = w2 . w1 [Om, I, 9] (contract m), the bias sum, and
  the tickets of the later launches set to 0; launch 2: K = ((w3x3 +
  pad(w1x3)) + pad(w3x1)) + w3 . T, fuse_erb's order of adds.
* VJP launch 1: dw3 = dK (x) T over (i, u, v) and dT = w3^T . dK (kept as
  [Om, 9, I]), beside them the copies of dK into dw3x3 and of its centre
  row and column into dw1x3 and dw3x1, and db into the three bias
  gradients; launch 2: dw2 = dT (x) w1^T over i and dw1 = w2 (x) dT over
  (p, u, v).

A launch is bound by latency at these sizes (PERF.md §6): a block's
loads, barriers and stores, not the FMA pipes, set its time, so each launch
trades tile size against splits of its k ranges (``plan``).

Every launch is a list of ``Gemm`` problems and ``Copy`` tasks that the
kernel runs side by side.  ``run_reference`` runs the same lists in plain
PyTorch on any device and dtype (the CPU tests hold the descriptors and the
VJP's algebra to ``fuse_erb_plain``, autograd and the JAX package's fusion
with it).  ``plan`` gives each launch's tile and how far a problem with too
few tiles for the card splits its k range (the split partials are added in
a fixed order by the tile's last block, so a launch gives the same bits
every time).  The forward runs inside the caller's ``reparam.fuse`` span,
the VJP inside ``reparam.fuse_vjp``.  Where autograd needs the VJP, the
forward runs on a stream of the fusion's own, which the caller's stream
waits for, so that autograd runs the VJP there, beside the rest of the
backward.  That stream runs the fold's kernels and nothing else (the
cotangents are made contiguous on the caller's stream), and each launch
names its node in a captured graph (``utils/profiling.py::name_node``), so
that a replay's ops are charged to their spans although the two streams
overlap.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.profiling import name_node, span
from .build import load_library

# kernel launches since the count was last set to 0: two a forward, two a VJP
FWD_LAUNCHES = 0
VJP_LAUNCHES = 0

# csrc/reparam_fuse.cu's tiles by code: (BM, BN, threads); its BK and the
# problems and copies a launch takes
TILES = {0: (64, 64, 256), 1: (32, 32, 64), 2: (32, 64, 128), 3: (64, 32, 128)}
BK = 16
MAX_GEMMS, MAX_COPIES = 4, 6
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)  # the splits a plan may choose
SPLIT_MIN_STEPS = 2  # BK-deep k steps a split block keeps at least
DEFAULT_SMS = 132  # an H100 SXM's SMs, for plans made without a card
KERNEL = "erb_fold_tiles"  # the kernel's name, as a trace gives it
# (tile, splits of each problem) of each launch at the ERB blocks of the
# benchmark's cells, by (Oo, Om, I, M): of every tile and 1-64 splits, the
# pick of a cost model fitted to 659 launch times at these shapes, within
# 5% of the fastest measured, on an NVIDIA H100 80GB HBM3 (PERF.md §6)
PLANS = {
    (650, 650, 26, 52): ((2, (1,)), (2, (6,)), (2, (1, 3)), (2, (1, 48))),
    (384, 384, 26, 52): ((2, (1,)), (2, (8,)), (2, (3, 6)), (2, (1, 32))),
    (384, 384, 96, 192): ((2, (1,)), (2, (3,)), (2, (3, 1)), (2, (1, 16))),
    (1200, 1200, 48, 96): ((2, (1,)), (2, (3,)), (2, (1, 3)), (2, (1, 64))),
    (864, 864, 48, 96): ((2, (1,)), (2, (2,)), (2, (2, 4)), (1, (1, 48))),
}

Tensors = Tuple[torch.Tensor, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


Ix = Tuple[int, int, int]  # (div, hi, lo): x lies at (x // div) hi + (x % div) lo


def one(stride: int) -> Ix:
    """An index of one stride."""
    return (1, stride, 0)


def pair(hi: int) -> Ix:
    """An index over (q, uv), uv in [0, 9) of unit stride and q at ``hi``."""
    return (9, hi, 1)


def offsets(ix: Ix, n: int) -> torch.Tensor:
    """The offsets of indices 0 .. n-1 (int64, on the CPU)."""
    x = torch.arange(n)
    return (x // ix[0]) * ix[1] + (x % ix[0]) * ix[2]


@dataclasses.dataclass
class Gemm:
    """C[r, c] = epi(sum over k of A[r, k] B[k, c]), each operand addressed
    by ``Ix`` indices from its tensor's first element: A[r, k] at a_outer(r)
    + a_k(k), B[k, c] at b_k(k) + b_outer(c), C[r, c] at c_row(r) +
    c_col(c).  An operand's k has unit stride, or one stride.  ``epi`` 1
    adds ERB's three small kernels (the launch's ``fold``) first."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    rows: int
    cols: int
    k: int
    a_outer: Ix
    a_k: Ix
    b_outer: Ix
    b_k: Ix
    c_row: Ix
    c_col: Ix
    epi: int = 0
    work: Optional[torch.Tensor] = None  # split: [tiles, splits, BM, BN] partials
    ticket: Optional[torch.Tensor] = None  # split: an int a tile, 0 at the launch

    def steps(self) -> int:
        """BK-deep k steps of one output tile."""
        return _cdiv(self.k, BK)

    def tiles(self, tile: int) -> int:
        bm, bn = TILES[tile][:2]
        return _cdiv(self.rows, bm) * _cdiv(self.cols, bn)


@dataclasses.dataclass
class Copy:
    """dst[e] = (src0[o] + src1[o]) + src2[o] over the given sources, o =
    base + i0 s0 + i1 s1 + i2 s2 for e = (i0 d1 + i1) d2 + i2 < n."""

    srcs: Tuple[torch.Tensor, ...]
    dst: torch.Tensor
    s0: int
    d1: int = 1
    s1: int = 0
    d2: int = 1
    s2: int = 0
    base: int = 0


@dataclasses.dataclass
class Launch:
    """One launch: its problems, copies, ERB's small kernels for ``epi`` 1,
    the ints it sets to 0, its tile code and each problem's splits."""

    gemms: List[Gemm]
    copies: List[Copy] = dataclasses.field(default_factory=list)
    fold: Optional[Tensors] = None  # (w3x3, w1x3, w3x1), contiguous
    zero: Optional[torch.Tensor] = None
    tile: int = 2
    splits: Optional[List[int]] = None


def forward_launches(w33, b33, w13, b13, w31, b31, w1, w2, w3, t, k, b) -> List[Launch]:
    """The forward's two launches into T [Om, I, 3, 3], K [Oo, I, 3, 3] and
    b [Oo], all contiguous.  T's rows are (p, uv) pairs, so that w2's
    [Om, M, 9] is read along its unit stride."""
    oo, cin = w33.shape[:2]
    om, m = w2.shape[:2]
    n9 = 9 * cin
    t_of = Gemm(a=w2, b=w1, c=t, rows=9 * om, cols=cin, k=m,
                a_outer=pair(9 * m), a_k=one(9), b_outer=one(1), b_k=one(cin),
                c_row=pair(n9), c_col=one(9))
    k_of = Gemm(a=w3, b=t, c=k, rows=oo, cols=n9, k=om,
                a_outer=one(om), a_k=one(1), b_outer=one(1), b_k=one(n9),
                c_row=one(n9), c_col=one(1), epi=1)
    bias = Copy(srcs=(b33, b13, b31), dst=b, s0=1)
    return [Launch([t_of], [bias]), Launch([k_of], fold=(w33, w13, w31))]


def vjp_launches(dk, db, w1, w2, w3, t, grads) -> List[Launch]:
    """The VJP's two launches into ``grads`` (dw3x3, db3x3, dw1x3, db1x3,
    dw3x1, db3x1, dw1, dw2, dw3, in erb_fold's order; contiguous) and dT
    [Om, 9, I] (the last of ``grads``), from contiguous dK and db."""
    dw33, db33, dw13, db13, dw31, db31, dw1, dw2, dw3, dt = grads
    oo, cin = dk.shape[:2]
    om, m = w2.shape[:2]
    n9 = 9 * cin
    dw3_of = Gemm(a=dk, b=t, c=dw3, rows=oo, cols=om, k=n9,
                  a_outer=one(n9), a_k=one(1), b_outer=one(n9), b_k=one(1),
                  c_row=one(om), c_col=one(1))
    # dT is kept uv-major, [Om, 9, I], so that both of its readers walk I
    dt_of = Gemm(a=w3, b=dk, c=dt, rows=om, cols=n9, k=oo,
                 a_outer=one(1), a_k=one(om), b_outer=one(1), b_k=one(n9),
                 c_row=one(n9), c_col=(9, 1, cin))
    dw2_of = Gemm(a=dt, b=w1, c=dw2, rows=9 * om, cols=m, k=cin,
                  a_outer=one(cin), a_k=one(1), b_outer=one(cin), b_k=one(1),
                  c_row=pair(9 * m), c_col=one(9))
    dw1_of = Gemm(a=w2, b=dt, c=dw1, rows=m, cols=cin, k=9 * om,
                  a_outer=one(9), a_k=pair(9 * m), b_outer=one(1), b_k=one(cin),
                  c_row=one(cin), c_col=one(1))
    copies = [
        Copy(srcs=(dk,), dst=dw33, s0=1),
        Copy(srcs=(dk,), dst=dw13, s0=n9, d1=cin, s1=9, d2=3, s2=1, base=3),  # u = 1
        Copy(srcs=(dk,), dst=dw31, s0=n9, d1=cin, s1=9, d2=3, s2=3, base=1),  # v = 1
        *[Copy(srcs=(db,), dst=d, s0=1) for d in (db33, db13, db31)],
    ]
    return [Launch([dw3_of, dt_of], copies), Launch([dw2_of, dw1_of])]


# ---------------------------------------------------------------------------
# Plans: each launch's tile and splits
# ---------------------------------------------------------------------------

Shapes = Tuple[Tuple[Tuple[int, int, int], ...], ...]


def _blank(rows: int, cols: int, k: int) -> Gemm:
    ix = one(0)
    return Gemm(a=None, b=None, c=None, rows=rows, cols=cols, k=k,
                a_outer=ix, a_k=ix, b_outer=ix, b_k=ix, c_row=ix, c_col=ix)


def shapes_of(launches: Sequence[Launch]) -> Shapes:
    """Each launch's problems as (rows, cols, k)."""
    return tuple(tuple((g.rows, g.cols, g.k) for g in ln.gemms) for ln in launches)


def vjp_shapes(oo: int, om: int, cin: int, m: int) -> Shapes:
    """``shapes_of(vjp_launches(...))`` for a dK of [oo, cin, 3, 3] and w2
    of [om, m, 3, 3]."""
    return (((oo, om, 9 * cin), (om, 9 * cin, oo)), ((9 * om, m, cin), (m, cin, 9 * om)))


@functools.lru_cache(maxsize=None)
def plan(shapes: Shapes, sms: int) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """(tile, splits of each problem) of each launch of ``shapes`` (the
    forward's two, then the VJP's two, if any): ``PLANS`` at the shapes it
    holds; elsewhere the 32 x 64 tile, and each problem's k range split as
    far as the card's block slots (four an SM at that tile) hold its tiles,
    every split block keeping at least ``SPLIT_MIN_STEPS`` k steps.  The
    first launch never splits: no launch before it sets its tickets to 0.
    A plan depends on the shapes and the card's SM count alone, so every
    call of a shape runs the same launches and gives the same bits."""
    (om9, cin, m), = shapes[0]
    (oo, _, _), = shapes[1]
    known = PLANS.get((oo, om9 // 9, cin, m))
    if known is not None:
        return known[:len(shapes)]
    out = []
    for li, probs in enumerate(shapes):
        splits = []
        for shp in probs:
            g = _blank(*shp)
            splits.append(max(s for s in SPLITS if s == 1 or (
                li > 0 and g.steps() >= s * SPLIT_MIN_STEPS and g.tiles(2) * s <= 4 * sms)))
        out.append((2, tuple(splits)))
    return tuple(out)


def tickets_of(probs, tile: int, splits: Sequence[int]) -> int:
    """The tickets of one launch's split problems: one an output tile."""
    return sum(_blank(*shp).tiles(tile) for shp, s in zip(probs, splits) if s > 1)


def assign(launches: Sequence[Launch], planned, tickets: torch.Tensor) -> None:
    """Set each launch's tile and splits from ``planned``, and give each
    split problem its slice of ``tickets`` and a buffer for its partial
    tiles."""
    at = 0
    for ln, (tile, splits) in zip(launches, planned):
        ln.tile, ln.splits = tile, list(splits)
        for g, s in zip(ln.gemms, splits):
            if s > 1:
                n = g.tiles(tile)
                g.ticket = tickets[at:at + n]
                bm, bn = TILES[tile][:2]
                g.work = torch.empty(n * s * bm * bn, device=g.c.device, dtype=torch.float32)
                at += n
    if at != tickets.numel():
        raise ValueError("reparam_fuse: the tickets do not match the plan")


# ---------------------------------------------------------------------------
# The plain version of a launch, and the kernel's
# ---------------------------------------------------------------------------


def run_reference(ln: Launch) -> None:
    """What the kernel computes for ``ln``, in plain PyTorch on ``ln``'s
    tensors (any device and dtype); the sums in another order."""
    if ln.zero is not None:
        ln.zero.zero_()
    for g in ln.gemms:
        a = g.a.reshape(-1)[offsets(g.a_outer, g.rows)[:, None] + offsets(g.a_k, g.k)]
        b = g.b.reshape(-1)[offsets(g.b_k, g.k)[:, None] + offsets(g.b_outer, g.cols)]
        acc = a @ b
        if g.epi == 1:
            w33, w13, w31 = ln.fold
            base = w33.clone()
            base[:, :, 1, :] += w13[:, :, 0, :]
            base[:, :, :, 1] += w31[:, :, :, 0]
            acc = base.reshape(g.rows, g.cols) + acc
        g.c.view(-1)[offsets(g.c_row, g.rows)[:, None] + offsets(g.c_col, g.cols)] = acc
    for cp in ln.copies:
        n0 = cp.dst.numel() // (cp.d1 * cp.d2)
        idx = (cp.base + torch.arange(n0)[:, None, None] * cp.s0
               + torch.arange(cp.d1)[None, :, None] * cp.s1
               + torch.arange(cp.d2)[None, None, :] * cp.s2).reshape(-1)
        v = cp.srcs[0].reshape(-1)[idx]
        for s in cp.srcs[1:]:
            v = v + s.reshape(-1)[idx]
        cp.dst.view(-1).copy_(v)


def _records(ln: Launch):
    gem = []
    for g, s in zip(ln.gemms, ln.splits):
        gem += [g.a.data_ptr(), g.b.data_ptr(), g.c.data_ptr(),
                g.work.data_ptr() if s > 1 else 0, g.ticket.data_ptr() if s > 1 else 0,
                *g.a_outer, *g.a_k, *g.b_outer, *g.b_k, *g.c_row, *g.c_col,
                g.rows, g.cols, g.k, s, g.epi]
    cop = []
    for cp in ln.copies:
        srcs = [s.data_ptr() for s in cp.srcs] + [0] * (3 - len(cp.srcs))
        cop += [*srcs, cp.dst.data_ptr(), cp.s0, cp.s1, cp.s2, cp.base, cp.d1, cp.d2,
                cp.dst.numel()]
    fold = [t.data_ptr() for t in ln.fold] + [ln.fold[0].shape[1]] if ln.fold else [0, 0, 0, 0]
    return gem, cop, fold


def run_kernel(ln: Launch) -> None:
    """One launch of ``csrc/reparam_fuse.cu`` for ``ln`` (CUDA tensors);
    a refused launch raises."""
    if not (len(ln.gemms) <= MAX_GEMMS and len(ln.copies) <= MAX_COPIES):
        raise ValueError("reparam_fuse: too many problems for one launch")
    lib = load_library()  # builds csrc/*.cu on first use
    gem, cop, fold = _records(ln)
    name_node(KERNEL)
    i64 = ctypes.c_longlong
    dev = ln.gemms[0].c.device
    with torch.cuda.device(dev):
        err = lib.repnerv_erb_fold(
            (i64 * max(len(gem), 1))(*gem), len(ln.gemms),
            (i64 * max(len(cop), 1))(*cop), len(ln.copies),
            (i64 * 4)(*fold),
            ctypes.c_void_p(ln.zero.data_ptr() if ln.zero is not None else None),
            ln.zero.numel() if ln.zero is not None else 0,
            ln.tile,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"reparam_fuse kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sms_of(device: torch.device) -> int:
    return _sms(device) if device.type == "cuda" else DEFAULT_SMS


# ---------------------------------------------------------------------------
# The fusion and its VJP
# ---------------------------------------------------------------------------


def takes(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """Whether the kernels take ERB's nine branch tensors (erb_fold's
    order): all CUDA f32 tensors on one device, with ERB's shapes."""
    if any(t is None for t in tensors):
        return False
    first = tensors[0]
    if first.device.type != "cuda" or any(
            t.dtype != torch.float32 or t.device != first.device for t in tensors):
        return False
    w33, b33, w13, b13, w31, b31, w1, w2, w3 = tensors
    if w33.dim() != 4 or w2.dim() != 4:
        return False
    oo, cin = w33.shape[:2]
    om, m = w2.shape[:2]
    if max(t.numel() for t in tensors) >= 2**31 or om * 9 * cin >= 2**31:
        return False  # the kernel's offsets are ints
    return (tuple(w33.shape) == (oo, cin, 3, 3) and tuple(w13.shape) == (oo, cin, 1, 3)
            and tuple(w31.shape) == (oo, cin, 3, 1) and tuple(w1.shape) == (m, cin, 1, 1)
            and tuple(w2.shape) == (om, m, 3, 3) and tuple(w3.shape) == (oo, om, 1, 1)
            and all(tuple(t.shape) == (oo,) for t in (b33, b13, b31)))


def _forward(tensors: Tensors, runner, with_vjp: bool):
    """The forward's launches by ``runner``: (K, b, T, what the VJP needs or
    None).  Its first launch sets every ticket of the later ones to 0."""
    global FWD_LAUNCHES
    w33, b33, w13, b13, w31, b31, w1, w2, w3 = tensors
    oo, cin = w33.shape[:2]
    om, m = w2.shape[:2]
    opts = dict(device=w33.device, dtype=w33.dtype)
    t = torch.empty(om, cin, 3, 3, **opts)
    k = torch.empty(oo, cin, 3, 3, **opts)
    b = torch.empty(oo, **opts)
    fwd = forward_launches(*tensors, t, k, b)
    shapes = shapes_of(fwd) + (vjp_shapes(oo, om, cin, m) if with_vjp else ())
    planned = plan(shapes, sms_of(w33.device))
    counts = [tickets_of(probs, *pl) for probs, pl in zip(shapes, planned)]
    tickets = torch.empty(sum(counts), device=w33.device, dtype=torch.int32)
    n_fwd = counts[0] + counts[1]
    assign(fwd, planned[:2], tickets[:n_fwd])
    if tickets.numel():
        fwd[0].zero = tickets
    for ln in fwd:
        runner(ln)
        FWD_LAUNCHES += runner is run_kernel
    return k, b, t, (tickets[n_fwd:], planned[2:]) if with_vjp else None


def _vjp(dk, db, w1, w2, w3, t, tickets, planned, runner):
    """The VJP's launches by ``runner``: the nine gradients in erb_fold's
    order."""
    global VJP_LAUNCHES
    dk = dk.contiguous()
    oo, cin = dk.shape[:2]
    om, m = w2.shape[:2]
    opts = dict(device=dk.device, dtype=dk.dtype)
    grads = (torch.empty(oo, cin, 3, 3, **opts), torch.empty(oo, **opts),
             torch.empty(oo, cin, 1, 3, **opts), torch.empty(oo, **opts),
             torch.empty(oo, cin, 3, 1, **opts), torch.empty(oo, **opts),
             torch.empty(m, cin, 1, 1, **opts), torch.empty(om, m, 3, 3, **opts),
             torch.empty(oo, om, 1, 1, **opts), torch.empty(om, 9, cin, **opts))
    vjp = vjp_launches(dk, db, w1, w2, w3, t, grads)
    assign(vjp, planned, tickets)
    for ln in vjp:
        runner(ln)
        VJP_LAUNCHES += runner is run_kernel
    return grads[:9]


class _ErbFold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *tensors):
        k, b, t, vjp = _forward(tensors, run_kernel, True)
        ctx.save_for_backward(*tensors[6:])
        ctx.t, ctx.vjp = t, vjp
        return k, b

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dk, db):
        w1, w2, w3 = ctx.saved_tensors
        with span("reparam.fuse_vjp"):
            grads = _vjp(dk, db.contiguous(), w1, w2, w3, ctx.t, *ctx.vjp, run_kernel)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


class _Contiguous(torch.autograd.Function):
    """(K, b) as they are, whose backward makes the cotangents contiguous,
    on the caller's stream: the fold's stream runs nothing but the fold."""

    @staticmethod
    def forward(ctx, k, b):
        return k.view_as(k), b.view_as(b)

    @staticmethod
    def backward(ctx, dk, db):
        return dk.contiguous(), db.contiguous()


_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    """The fusion's own stream on ``device``, made at its first use."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def needs_vjp(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether autograd will ask for the fold's VJP."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def erb_fold(*tensors: torch.Tensor):
    """(K [Oo, I, 3, 3], b [Oo]) of ERB's nine branch tensors (w3x3, b3x3,
    w1x3, b1x3, w3x1, b3x1, w1, w2, w3; ``takes`` holds) in two launches.
    Where autograd needs it, differentiable with a VJP of two launches: the
    forward then runs on the fusion's stream, which the caller's stream
    waits for, and autograd, which runs a backward on its forward's stream,
    runs the VJP there beside the rest of the backward."""
    tensors = tuple(x.contiguous() for x in tensors)
    if not needs_vjp(tensors):
        k, b, _, _ = _forward(tensors, run_kernel, False)
        return k, b
    cur = torch.cuda.current_stream(tensors[0].device)
    side = _side_stream(tensors[0].device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        k, b = _ErbFold.apply(*tensors)
    cur.wait_stream(side)
    k.record_stream(cur)
    b.record_stream(cur)
    return _Contiguous.apply(k, b)


def erb_fold_reference(*tensors: torch.Tensor):
    """``erb_fold``'s launches in plain PyTorch (``run_reference``), on any
    device and dtype: (K, b, T)."""
    k, b, t, _ = _forward(tuple(x.contiguous() for x in tensors), run_reference, False)
    return k, b, t


def erb_fold_vjp_reference(dk: torch.Tensor, db: torch.Tensor, *tensors: torch.Tensor):
    """The VJP's launches in plain PyTorch: the nine gradients of ``dk``,
    ``db`` with respect to ``tensors``, in erb_fold's order."""
    tensors = tuple(x.contiguous() for x in tensors)
    _, _, t, vjp = _forward(tensors, run_reference, True)
    return _vjp(dk, db.contiguous(), *tensors[6:], t, *vjp, run_reference)
