"""The collectives of the port's mesh paths, each with a launch count.

JAX inserts its collectives where a sharded expression needs them; the
port calls them by hand, through these two wrappers, over the process
groups of a mesh's axes (``launch.mesh.axes_group``): NCCL on the card,
gloo on the CPU.  Each adds one to its ``launches`` count per call, so a
run can show that its meshed path communicated.  Neither skips a group
of one rank: a 1 x 1 mesh still runs its collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (contiguous ``t``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.launches += 1
    return t


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
