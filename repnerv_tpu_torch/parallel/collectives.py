"""``torch.distributed`` collectives as autograd functions, for the tensor
parallel forward (``parallel/tensor_parallel.py``) and the batch statistics
of ``--norm bn`` over data ranks (``models/layers.py::batch_norm_train``).

Three pairs, forward and backward:

* ``all_gather``: the ranks' tensors concatenated along a dim; backward, the
  sum of the ranks' cotangents and this rank's slice of it (a reduce-scatter,
  as an all-reduce and a slice: gloo has no reduce-scatter);
* ``all_reduce``: the sum; backward the sum again (``grad_sum``: each
  rank's cotangent is its share, as where the result feeds a computation
  that differs by rank) or the identity (each rank's cotangent is already
  the whole, as where every rank computes the same loss from it);
* ``copy``: the identity; backward the sum (a replicated tensor that each
  rank uses in part, so that each rank's gradient is a share).

Sums run in f32 whatever the tensor's type and come back in it (more exact
than a bf16 sum, and gloo need not know bf16); a gather moves bf16 bits as
f16, with no arithmetic.  ``BYTES`` counts, by kind, the bytes of each
collective's result on this rank, backward ones included.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BYTES = {"all_gather": 0, "all_reduce": 0}  # since the counts were last set to 0


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in f32, in ``t``'s dtype."""
    out = t.float().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    BYTES["all_reduce"] += out.numel() * out.element_size()
    return out.to(t.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.group, ctx.index, ctx.size = dim, group, index, x.shape[dim]
        xc = x.contiguous()
        wire = xc.view(torch.float16) if xc.dtype == torch.bfloat16 else xc
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts, dim).view(x.dtype)
        BYTES["all_gather"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        g = _sum(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_sum(g, ctx.group) if ctx.grad_sum else g), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group, n: int, index: int) -> torch.Tensor:
    """``x`` of the ``n`` ranks of ``group`` (this one at ``index``),
    concatenated along ``dim`` in rank order; each rank's ``x`` has the
    same shape."""
    return _AllGather.apply(x, dim, group, n, index)


def all_reduce(x: torch.Tensor, group, grad_sum: bool) -> torch.Tensor:
    """The sum of ``x`` over ``group``; backward the sum too with
    ``grad_sum``, else the identity."""
    return _AllReduce.apply(x, group, grad_sum)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; backward the sum of the cotangents over ``group``."""
    return _Copy.apply(x, group)
