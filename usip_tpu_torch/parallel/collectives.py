"""Collectives with gradients, for ``torch.distributed`` (the port's
counterparts of the ``psum``/``all_gather``/``pmax`` that usip_tpu's
``shard_map`` bodies differentiate through).

A tensor on a mesh axis is either *replicated* (the same value on every
rank of the axis) or *varying* (each rank its own part). The gradient of a
replicated tensor is, on every rank, the whole gradient; that of a varying
one its own part. A loss computed from replicated values is replicated, and
each rank's backward seeds it with 1. The functions keep that rule:

* ``psum``: varying -> replicated sum; backward the identity;
* ``pvary``: replicated -> used by varying work; backward the sum of the
  ranks' parts (an all-reduce);
* ``sync_sum`` = ``pvary(psum(x))``: statistics summed over the axis and
  used by each rank's own rows (BatchNorm), all-reduced both ways;
* ``all_gather``: varying parts -> the replicated whole along ``dim``;
  backward this rank's part of the gradient;
* ``pmax``: the elementwise max of varying parts, replicated, no
  gradient (the differentiable form gathers, then reduces);
* ``all_reduce_grads``: the data-parallel gradient all-reduce, the sum of
  the ranks' parts of each parameter's gradient, through one flat buffer.

At one rank every function is the identity.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from usip_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _single(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.size == 1


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group, size: int, rank: int, dim: int
                ) -> Tensor:
        ctx.dim, ctx.rank, ctx.width = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        part = g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width)
        return part.contiguous(), None, None, None, None


def psum(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    return x if _single(mesh) else _PSum.apply(x, mesh.group)


def pvary(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    return x if _single(mesh) else _PVary.apply(x, mesh.group)


def sync_sum(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    return x if _single(mesh) else _SyncSum.apply(x, mesh.group)


def all_gather(x: Tensor, mesh: Optional[Mesh], dim: int = 0) -> Tensor:
    """The ranks' parts of equal shape, concatenated along ``dim`` in axis
    order."""
    if _single(mesh):
        return x
    return _AllGather.apply(x, mesh.group, mesh.size, mesh.rank, dim)


def all_gather_stack(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The ranks' parts stacked on a new leading axis ``(S, ...)``."""
    return all_gather(x.unsqueeze(0), mesh, 0)


@torch.no_grad()
def pmax(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    if _single(mesh):
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     mesh: Optional[Mesh]) -> None:
    """Sum each parameter's gradient over ``mesh``: one all-reduce of one
    flat fp32 buffer. Every rank runs the same graph, so the parameters that
    have a gradient, and the buffer's layout, are the same on every rank; a
    parameter without one keeps None (Adam skips it, as at one rank)."""
    if _single(mesh):
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
