"""The collectives of the sharded paths, as autograd functions.

Megatron's pair for tensor parallelism:

- ``copy_to_group`` ("f"): identity forward, all-reduce backward. It sits
  where a replicated activation enters a column-parallel product: each
  rank's gradient is its shard's part of the whole.
- ``reduce_from_group`` ("g"): all-reduce forward, identity backward. It
  sums a row-parallel product's partial outputs; every rank then holds the
  whole activation and its whole gradient.

and for sequence and pipeline parallelism:

- ``gather_along``: all-gather along a dimension. Its backward is a
  reduce-scatter when every rank goes on to compute its own share of the
  result (``reduce_grad=True``: sequence parallelism's K and V, used by
  each rank's local queries), or the rank's own slice when every rank goes
  on to compute the same (``reduce_grad=False``: a replicated output);
- ``sum_over_group``: all-reduce forward and backward, for sums that every
  rank's share feeds and every rank reads (BatchNorm's batch moments under
  data parallelism);
- ``ring_shift``: send to the next rank of the group, receive from the
  previous one; its backward shifts the other way.

The kernels see plain local tensors: no ``DTensor`` goes through them.
``COUNTS`` counts the collectives these functions issue, by name, forward
and backward (``reset_counts`` sets them to 0). A group of one rank still
issues them, so that a one-rank run shows a path going through its
collectives; only the ring shift and "f" are the identity there.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, in a new tensor (``x`` is left as
    it is; no autograd)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    COUNTS["all_reduce"] += 1
    return y


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank's ``x`` has the same shape; no autograd)."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``x``."""
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    COUNTS["reduce_scatter"] += 1
    return out


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` overwritten with global rank ``src``'s (in place)."""
    dist.broadcast(x, src=src, group=group)
    COUNTS["broadcast"] += 1
    return x


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    COUNTS["ring_shift"] += 1
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": identity forward, all-reduce backward. A group of one
    rank has nothing to sum: ``x`` itself, no autograd node, so that the
    gradients reaching ``x`` add up in the order they would without it."""
    if dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g": all-reduce forward, identity backward."""
    return _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward and backward: a sum every rank feeds and reads."""
    return _SumOverGroup.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group, reduce_grad: bool = True) -> torch.Tensor:
    """All-gather along ``dim`` (every rank's ``x`` of one shape). Backward:
    reduce-scatter with ``reduce_grad``, else this rank's slice."""
    return _GatherAlong.apply(x, dim, group, reduce_grad)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``x`` sent ``step`` ranks on around the group's ring; returns what
    the rank ``step`` before sent. Backward: the other way round. A group
    of one rank returns ``x``."""
    return _RingShift.apply(x, group, step)
