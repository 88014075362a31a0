"""The collectives GSPMD inserts for the JAX package, written out: each a
``torch.autograd.Function`` whose backward is the transpose JAX's AD gives.

``group`` is a process group, or None for an axis of size 1 (each function
is then the identity, with no communication). The pairs (Megatron's names):

* :func:`reduce` (``psum``): all-reduce forward, identity backward: a
  row-parallel product's partial sums made whole, read by replicated code;
* :func:`copy`: identity forward, all-reduce backward: a replicated
  activation (or weight) entering rank-specific code, whose gradient is
  the sum of every rank's;
* :func:`gather` / :func:`split`: all-gather forward and the rank's own
  block backward, and the reverse: a sharded activation made whole for
  replicated code, and a replicated one cut to this rank's block;
* :func:`gather_sum`: all-gather forward, the sum of every rank's gradient
  cut to this rank's block backward: a sharded weight made whole for
  rank-specific code;
* :func:`shift` (``ppermute`` around the ring): each rank's tensor to the
  next rank, backward the reverse shift;
* :func:`all_to_all`: block ``i`` of dim 0 to rank ``i``, its own transpose.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x, dim, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _own(x, dim, group):
    n = _size(group)
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _Reduce(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group), None, None


class _GatherSum(Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(_all_reduce(g, ctx.group), ctx.dim, ctx.group), None, \
            None


class _Split(Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def _shift(x, group, offset: int):
    n = _size(group)
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + offset) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - offset) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.offset), None, None


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def reduce(x, group):
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def copy(x, group):
    return x if _size(group) == 1 else _Copy.apply(x, group)


def gather(x, dim, group):
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)


def gather_sum(x, dim, group):
    return x if _size(group) == 1 else _GatherSum.apply(x, dim, group)


def split(x, dim, group):
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def shift(x, group, offset: int = 1):
    return x if _size(group) == 1 else _Shift.apply(x, group, offset)


def all_to_all(x, group):
    return x if _size(group) == 1 else _AllToAll.apply(x, group)


def all_reduce_(x, group):
    """In-place sum over ``group`` with no autograd (gradients, counters)."""
    if _size(group) > 1:
        dist.all_reduce(x, group=group)
    return x
