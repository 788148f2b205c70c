"""The collectives of the port's mesh paths, each with a launch count.

JAX inserts its collectives where a sharded expression needs them; the
port calls them by hand, through these wrappers, over the process
groups of a mesh's axes (``launch.mesh.axes_group``): NCCL on the card,
gloo on the CPU.  Each adds one to its ``launches`` count per call, so a
run can show that its meshed path communicated.  None skips a group of
one rank: a 1 x 1 mesh still runs its collectives.

Three are autograd Functions, differentiable any number of times (each
backward calls another's ``apply``, so ``create_graph`` records it): a
partitioned MACE takes its forces, a gradient, through them and trains
through those (``models.mace``).

* :func:`all_gather_rows`: every rank's rows, in rank order; backward
  :func:`reduce_scatter_rows`.
* :func:`reduce_scatter_rows`: a sum over the group, each rank handed
  its rows; backward :func:`all_gather_rows`.
* :func:`all_reduce_sum`: a partial sum made whole on every rank;
  backward the identity (a Function whose own backward sums).

The convention: a value whole on every rank (the output of
:func:`all_reduce_sum`) is seeded on every rank, and that seed counts
once, so its backward passes it through.  Each rank's gradient of a
tensor it gathered whole is then its part of the gradient, and the
gradient of a tensor every rank holds whole (a replicated parameter) is
a partial sum: summed once over the group, it is the whole gradient.

Rows are held in blocks of ``ceil(n / W)`` over a group of W ranks, as
DTensor's ``Shard(0)`` splits n rows (``torch.chunk``): rank q holds
rows ``[q B, min((q + 1) B, n))``, the last ranks fewer, or none.  Each
part travels padded to B rows, in the order its dimensions have in
memory, and comes back laid out as it went.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def row_block(n: int, group) -> Tuple[int, int]:
    """``(lo, hi)``: the rows of ``n`` this rank of ``group`` holds."""
    w = dist.get_world_size(group)
    b = -(-n // w)
    lo = min(dist.get_rank(group) * b, n)
    return lo, min(lo + b, n)


def _memory_order(x: torch.Tensor) -> Tuple[int, ...]:
    """The order of ``x``'s dimensions in memory, outermost first, where
    ``x`` is dense with its rows outermost (an einsum's permuted output);
    else the plain order (the collective then works on a copy)."""
    order = tuple(sorted(range(x.ndim), key=lambda d: (-x.stride(d), d)))
    if order[:1] == (0,) and x.permute(order).is_contiguous():
        return order
    return tuple(range(x.ndim))


def _in_order(x: torch.Tensor, order) -> torch.Tensor:
    """``x``'s dimensions in ``order``, contiguous (a view when ``order``
    is its memory order)."""
    return x.permute(order).contiguous()


def _out_of_order(x: torch.Tensor, order) -> torch.Tensor:
    """The inverse of :func:`_in_order`: a view laid out in memory as
    the input was, so a collective on one rank changes no layout (and a
    1 x 1 mesh no bit of what follows it)."""
    return x.permute(tuple(order.index(d) for d in range(x.ndim)))


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],)
                                     + tuple(x.shape[1:]))])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group = group
        lo, hi = row_block(n, group)
        if x.shape[0] != hi - lo:
            raise ValueError(f"all_gather_rows: this rank holds "
                             f"{x.shape[0]} rows of {n}, not rows "
                             f"[{lo}, {hi})")
        w = dist.get_world_size(group)
        order = _memory_order(x)
        part = _pad_rows(_in_order(x, order), -(-n // w))
        parts = [torch.empty_like(part) for _ in range(w)]
        dist.all_gather(parts, part, group=group)
        all_gather_rows.launches += 1
        out = parts[0] if w == 1 else torch.cat(parts)
        return _out_of_order(out[:n], order)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = x.shape[0]
        ctx.group, ctx.n = group, n
        w = dist.get_world_size(group)
        b = -(-n // w)
        order = _memory_order(x)
        parts = list(_pad_rows(_in_order(x, order), w * b).split(b))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
        reduce_scatter_rows.launches += 1
        lo, hi = row_block(n, group)
        return _out_of_order(out[:hi - lo], order)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.group, ctx.n), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        order = _memory_order(x)
        out = _in_order(x, order).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        all_reduce_sum.launches += 1
        return _out_of_order(out, order)

    @staticmethod
    def backward(ctx, g):
        return _Broadcast.apply(g, ctx.group), None


class _Broadcast(torch.autograd.Function):
    """The identity on a value whole on every rank that each rank then
    uses for its part: backward :func:`all_reduce_sum` (so a gradient of
    ``all_reduce_sum``'s seed, a third derivative, is whole too)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The (n, ...) rows whose block this rank of ``group`` holds as
    ``x`` (:func:`row_block`), every rank's in rank order."""
    return _AllGatherRows.apply(x, group, n)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows of ``x`` summed over ``group``."""
    return _ReduceScatterRows.apply(x, group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, a new tensor."""
    return _AllReduceSum.apply(t, group)


all_gather_rows.launches = 0
reduce_scatter_rows.launches = 0
all_reduce_sum.launches = 0


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked on a new leading axis in
    the group's rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    all_gather_stack.launches += 1
    return torch.stack(out)


all_gather_stack.launches = 0


def barrier() -> None:
    """Wait for every rank of the world (NCCL: on this rank's card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
