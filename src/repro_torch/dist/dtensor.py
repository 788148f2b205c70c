"""Running the port's functions on DTensors: the training half of the mesh
paths.

The reference jits a step with ``in_shardings`` and lets XLA's SPMD
partitioner insert the collectives; the port places parameters,
optimizer state and batches as ``torch.distributed.tensor.DTensor`` s
over a ``DeviceMesh`` and lets DTensor's sharding propagation insert
them op by op.  These helpers cover what propagation cannot:

* :func:`on_local` runs a hand-written kernel (a ctypes call takes no
  DTensor) on each rank's local tensors and wraps the result back, the
  counterpart of a ``shard_map`` around a Pallas call.  The caller
  names the placements the kernel treats independently (batch rows,
  heads); operands placed otherwise are redistributed to them first,
  explicitly.
* :func:`group_split` names the placements under which a function that
  treats the groups of its input (its dimension 0) independently runs
  on each rank's groups: the MoE routing (``sort`` / ``cummax`` /
  ``scatter`` of the slot ranks), dispatch (``index_put`` and row
  gathers) and combine of ``models.transformer`` run so, through
  :func:`on_local`.
* :func:`rows_local` runs a function that treats the rows of its input
  independently on each rank's rows: DLRM's pairwise-interaction gather
  (``index`` with a leading ``None``); not every torch release has its
  rule.
* :func:`divisible` and :func:`whole_dims` gather the splits a reshape
  cannot keep (a head split that does not divide the heads; the
  sequence split a loss chunk flattens).
* :func:`local_value` is the value of a DTensor or a tensor as a plain
  tensor (the whole tensor, gathered), for reading results.

Elsewhere: ``core.index.gather_clip`` (``index`` with ``clamp``) gathers
the table and keeps the ids' split, ``models.transformer._mm_f32`` (a
product with ``out_dtype``) and the kernels of ``kernels.flash_attn``
run on local operands through :func:`on_local`, the loss's gold logit
is a sum over the vocabulary where a gather would meet a split
vocabulary, and a placed KV cache is written and read by
``dist.sp_decode``.

Nothing here catches an error to fall back: an op with no sharding rule
that is not routed through these raises, as DTensor raises.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(*xs: Any) -> bool:
    return any(is_dtensor(x) for x in xs)


def _first(xs):
    return next(x for x in xs if is_dtensor(x))


def replicate_all(x):
    """``x`` redistributed to ``Replicate()`` on every mesh dimension (a
    plain tensor comes back as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def on_local(fn: Callable, tensors: Sequence[torch.Tensor],
             placements: Sequence, *args, out_placements=None, **kwargs):
    """``fn(*locals, *args, **kwargs)`` on this rank's local parts of the
    DTensors ``tensors``, each redistributed first to ``placements`` (one
    placement a mesh dimension for all of them, or a list of such, one a
    tensor); each tensor of the result comes back as a DTensor with
    ``out_placements`` (default: ``placements``, or the first tensor's;
    a list of such gives one an output, and the inputs' gradients are
    placed against the first).  Differentiable: the redistribution's and
    the wrapping's backwards are DTensor's own."""
    from torch.distributed.tensor.placement_types import Placement
    mesh = _first(tensors).device_mesh
    if isinstance(placements[0], Placement):
        placements = [tuple(placements)] * len(tensors)
    placements = [tuple(p) for p in placements]
    out_pl = out_placements or placements[0]
    if isinstance(out_pl[0], Placement):
        out_pl = tuple(out_pl)
        first = out_pl
    else:
        out_pl = [tuple(p) for p in out_pl]
        first = out_pl[0]
    locs = [t.redistribute(mesh, p).to_local(
        grad_placements=_grad_placements(p, first))
        if is_dtensor(t) else t for t, p in zip(tensors, placements)]
    return _wrap(fn(*locs, *args, **kwargs), mesh, out_pl)


def _grad_placements(p_in, p_out) -> tuple:
    """The placements of an input's local gradient: a partial sum on the
    mesh dimensions where the input is whole but the output is split
    (each rank differentiated its own part of the output), whole where
    the input is a partial sum (its gradient reaches every part), the
    input's own elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if i.is_replicate() and o.is_shard() else
                 Replicate() if i.is_partial() else i
                 for i, o in zip(p_in, p_out))


def _wrap(out, mesh, placements):
    """Every tensor of ``out`` (a tensor, a tuple or a named tuple) as a
    DTensor on ``mesh`` with ``placements`` (a list of them: one an
    element of the tuple)."""
    from torch.distributed.tensor import DTensor
    wrap = lambda o, pl: (DTensor.from_local(o, mesh, pl, run_check=False)
                          if isinstance(o, torch.Tensor) else o)
    if isinstance(out, tuple):
        pls = (placements if isinstance(placements, list)
               else [placements] * len(out))
        vals = [wrap(o, pl) for o, pl in zip(out, pls, strict=True)]
        return type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
    return wrap(out, placements)


def sharded_rows(x) -> tuple:
    """Placements of ``x`` with every split kept and every partial sum
    made whole (``Replicate()``)."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard() else Replicate() for p in x.placements)


def whole_dims(x, dims):
    """``x`` with every split of a dimension in ``dims`` gathered (a
    DTensor about to be reshaped across them: not every torch release
    can view a split dimension); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if p.is_shard() and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def reshape_local(fn: Callable, x, dims: dict):
    """``fn(x)`` for a reshape ``fn`` under which input dimension ``d``
    becomes output dimension ``dims[d]`` (the major dimension of a merge
    or a split): a DTensor keeps the splits of those dimensions, gathers
    the others, and reshapes each rank's local part (not every torch
    release can view a split dimension, or merge one that is not the
    major); a plain tensor as ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard
    pin = tuple(p if p.is_partial() or (p.is_shard() and p.dim in dims)
                else Replicate() for p in x.placements)
    pout = tuple(Shard(dims[p.dim]) if p.is_shard() else p for p in pin)
    return on_local(fn, (x,), pin, out_placements=pout)


def matmul_placements(a, b, rows: int) -> tuple:
    """(a's, b's, the product's placements) of ``a (..., K) @ b (K, N)``
    on each rank's parts, per mesh dimension: a split of a's first
    ``rows`` dimensions stays (b whole there); a contraction split in
    both stays (the product is a partial sum); b's column split stays
    (a whole there); any other split is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rep = Replicate()
    mesh = (a if is_dtensor(a) else b).device_mesh
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        sa = a.placements[i] if is_dtensor(a) else rep
        sb = b.placements[i] if is_dtensor(b) else rep
        if sa.is_shard() and sa.dim < rows:
            pa.append(sa), pb.append(rep), po.append(sa)
        elif sa.is_shard(rows) and sb.is_shard(0):
            pa.append(sa), pb.append(sb), po.append(Partial())
        elif sb.is_shard(1):
            pa.append(rep), pb.append(sb), po.append(Shard(rows))
        else:
            pa.append(rep), pb.append(rep), po.append(rep)
    return [pa, pb], po


def matmul(a, b, fn: Callable = torch.matmul):
    """``fn(a, b)``, ``a (..., K) @ b (K, N)``: DTensors multiply each
    rank's parts (:func:`matmul_placements`), which every torch release
    can, where DTensor's own rule flattens a's leading dimensions
    through a view that a split of any but the first refuses."""
    if not any_dtensor(a, b):
        return fn(a, b)
    pin, pout = matmul_placements(a, b, a.ndim - 1)
    return on_local(fn, (a, b), pin, out_placements=pout)


def group_split(x) -> tuple:
    """Placements of ``x`` that keep the plain splits (``Shard(0)``) of
    its dimension 0 for as long as each divides what is left of it, and
    make every other split or partial sum whole: the placements under
    which a function of independent groups runs on each rank's groups,
    and under which rank r's groups are the r-th block of the whole
    dimension (so a result that stacks C rows a group is split the same
    way along its C-row blocks)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, left = x.device_mesh, x.shape[0]
    pl = []
    for i, p in enumerate(x.placements):
        if type(p) is Shard and p.dim == 0 and left % mesh.size(i) == 0:
            left //= mesh.size(i)
            pl.append(p)
        else:
            pl.append(Replicate())
    return tuple(pl)


def rows_local(fn: Callable, x, *args):
    """``fn(x, *args)`` for an ``fn`` that treats the rows of ``x`` (its
    dimension 0) independently: a DTensor runs on each rank's rows (its
    other splits gathered first) and the result keeps the row split."""
    if not is_dtensor(x):
        return fn(x, *args)
    from torch.distributed.tensor import Replicate
    pl = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    return on_local(fn, (x,), pl, *args)


def like(out, x):
    """``out`` redistributed to ``x``'s splits (:func:`sharded_rows`)
    when both are DTensors: a replicated result taken back to the batch
    split of the activation it came from."""
    if is_dtensor(out) and is_dtensor(x):
        return out.redistribute(x.device_mesh, sharded_rows(x))
    return out


def divisible(x, dim: int, parts: int):
    """``x`` with every split of dimension ``dim`` over a mesh dimension
    whose size does not divide ``parts`` made whole first (a DTensor
    about to be viewed as ``parts`` groups along ``dim``, e.g. heads);
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard(dim) and parts % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh,
                                                                     pl)


def local_value(x):
    """The whole tensor of a DTensor (gathered; every rank of its mesh
    must call), a plain tensor as it is."""
    if is_dtensor(x):
        return x.full_tensor()
    return x
