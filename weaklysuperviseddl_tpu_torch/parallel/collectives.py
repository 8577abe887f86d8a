"""The collectives that GSPMD inserts in the JAX package, written out for
``torch.distributed``, with the gradients each needs.

  * ``all_reduce_sum``: a sum over a group whose backward sums the cotangents
    over the group again. It is right where every rank differentiates its
    own share of a global objective that reads the sum (BatchNorm's
    statistics over a batch split on 'data': each rank's loss is its rows').
    It is wrong where every rank holds the same replicated objective: the
    gradient would come back the group's size times too large; there take
    ``all_reduce_value`` (no gradient) and differentiate the local terms.
  * ``TensorParallel``: a convolution's share of its output channels on
    the 'model' axis (Megatron's column parallelism). Its input
    enters through an identity whose backward sums the input gradient over
    the group (each rank's slice of the output reaches only part of it); its
    output leaves through a gather whose backward takes this rank's slice of
    the gradient, not a sum of it (the layers after the gather run
    replicated, so every rank already holds the whole gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``x``, differentiable: the backward sums the
    cotangents over the group."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_value(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``x`` as a value: no gradient flows through it."""
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


class _EnterGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, dim):
        ctx.index, ctx.width, ctx.dim = index, x.shape[dim], dim
        return _gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None, \
            None, None


class TensorParallel:
    """One layer's share of its ``channels`` output channels on the 'model'
    axis: rank ``index`` of ``size`` in ``group`` holds rows ``rows`` of the
    weight (its dim 0, the output channels of [O,I,kh,kw])."""

    def __init__(self, group, index: int, size: int, channels: int):
        if channels % size:
            raise ValueError(f"{channels} channels do not split over a model axis of {size}")
        self.group, self.index, self.size = group, index, size
        share = channels // size
        self.rows = slice(index * share, (index + 1) * share)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The layer's input: the identity, with the input gradient summed
        over the group in the backward."""
        return _EnterGroup.apply(x, self.group)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice of the output, concatenated along ``dim``."""
        return _GatherSlices.apply(y, self.group, self.index, self.size, dim)

    @torch.no_grad()
    def full(self, local: torch.Tensor) -> torch.Tensor:
        """A sharded tensor (a weight, or Adam's moment of one) made whole."""
        return _gather(local, self.group, self.size, 0)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor."""
        return full[self.rows]
