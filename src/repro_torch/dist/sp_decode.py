"""Decode attention split over slices of the KV cache (port of
``repro.dist.sp_decode``'s merge).

Each slice of the cache's sequence axis yields online-softmax
statistics (running max m, normaliser l, weighted value sum acc) for a
single-token GQA query; the slices merge by the log-sum-exp identity

    m*   = max_i m_i
    l*   = sum_i l_i * exp(m_i - m*)
    acc* = sum_i acc_i * exp(m_i - m*)
    out  = acc* / l*

which is the attention over the whole cache.  The two merge functions
run on one device; :func:`sp_decode_attention` is the step with the
cache's sequence axis split over a mesh axis: each rank takes the stats
of its slice, one ``all_gather`` of the (tiny) stats crosses the axis,
and every rank merges them into the whole attention output.
:func:`placed_decode_attention` is the same step on a placed cache
(DTensors, the batch also split), which ``models.transformer``'s
``decode_step`` takes under a mesh.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def local_decode_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax statistics of one KV slice for single-token GQA
    decode.

    q: (B, Hq, hd); k, v: (B, S_loc, Hkv, hd), the slice; valid:
    (B, S_loc) mask of live cache positions in it.  Returns (m, l, acc):
    running max (B, Hq), -inf where the slice holds no valid position,
    normaliser (B, Hq) and weighted value sum (B, Hq, hd), all float32.
    """
    n_b, n_hq, hd = q.shape
    n_hkv = k.shape[2]
    qg = q.reshape(n_b, n_hkv, n_hq // n_hkv, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    m = s.amax(dim=-1)                                     # (B, Hkv, G)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])                   # masked -> 0
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return (m.reshape(n_b, n_hq), l.reshape(n_b, n_hq),
            acc.reshape(n_b, n_hq, hd))


def combine_decode_stats(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                         ) -> torch.Tensor:
    """Merge slice statistics stacked on a leading slice axis.

    m, l: (n_slices, B, Hq); acc: (n_slices, B, Hq, hd) -> out
    (B, Hq, hd) float32.  A slice with no valid position (m = -inf)
    weighs zero."""
    m_glob = m.amax(dim=0)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_glob = (l * corr).sum(dim=0)
    acc_glob = (acc * corr[..., None]).sum(dim=0)
    return acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]


def _slice(t, n: int, rank: int) -> torch.Tensor:
    """This rank's part of the sequence axis (dim 1) of ``t``: a DTensor's
    local part, or slice ``rank`` of a whole tensor cut in ``n``."""
    if hasattr(t, "to_local"):
        return t.to_local()
    if t.shape[1] % n:
        raise ValueError(f"the cache's {t.shape[1]} positions do not split "
                         f"over {n} ranks")
    s_loc = t.shape[1] // n
    return t[:, rank * s_loc:(rank + 1) * s_loc]


def sp_decode_attention(mesh, axis: str) -> Callable:
    """The decode-attention step with the KV cache's sequence axis split
    over ``mesh``'s ``axis`` (a DeviceMesh of ``launch.mesh``).

    Returns ``fn(q, k, v, lengths) -> (B, Hq, hd)`` float32, to be called
    by every rank of the mesh: q (B, Hq, hd); k, v (B, S, Hkv, hd), whole
    (this rank takes slice ``rank`` of ``S_loc = S / n``) or as DTensors
    sharded on dim 1 over ``axis`` (their local part is the slice);
    ``lengths`` (B,) each row's valid cache length.  Each rank computes
    ``local_decode_stats`` over its slice (positions offset by ``rank *
    S_loc``), all-gathers (m, l, acc) in one collective of O(B * Hq *
    hd) over the axis' group, and merges them with
    ``combine_decode_stats``: every rank returns the whole output.
    """
    from ..launch.mesh import axes_group
    from .collective import all_gather_stack
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                         f"{mesh.mesh_dim_names}")
    group = axes_group(mesh, (axis,))
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)

    def fn(q, k, v, lengths):
        k, v = _slice(k, n, rank), _slice(v, n, rank)
        s_loc = k.shape[1]
        pos = rank * s_loc + torch.arange(s_loc, device=k.device)
        valid = pos[None, :] < lengths[:, None]
        m, l, acc = local_decode_stats(q, k, v, valid)
        stats = all_gather_stack(
            torch.cat([m[..., None], l[..., None], acc], dim=-1), group)
        return combine_decode_stats(stats[..., 0], stats[..., 1],
                                    stats[..., 2:])

    return fn


def _seq_split(k):
    """(the mesh dimension that splits the cache's sequence axis, or
    None; this rank's first position)."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    if len(dims) > 1:
        raise ValueError(f"the cache's sequence axis is split over mesh "
                         f"dimensions {dims}; one at most")
    if not dims:
        return None, 0
    mesh = k.device_mesh
    n = mesh.size(dims[0])
    stride = -(-k.shape[1] // n)                # torch.chunk's sizes
    return dims[0], mesh.get_local_rank(dims[0]) * stride


def batch_placements(k) -> tuple:
    """``k``'s batch split (``Shard(0)``), every other dimension whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in k.placements)


def placed_decode_attention(q, k, v, lengths) -> torch.Tensor:
    """Single-token GQA decode over a placed cache: k, v (B, S, Hkv, hd)
    DTensors with the sequence split over at most one mesh dimension and
    the batch over any; q (B, Hq, hd) and ``lengths`` (B,) valid lengths.
    Each rank takes the statistics of its slice of its rows, all-gathers
    them over the sequence's mesh dimension and merges them: (B, Hq, hd)
    float32, split as the batch is."""
    from ..dist.dtensor import on_local
    from .collective import all_gather_stack
    dim, start = _seq_split(k)
    group = None if dim is None else k.device_mesh.get_group(dim)
    batch = batch_placements(k)

    def local(ql, kl, vl, ll):
        pos = start + torch.arange(kl.shape[1], device=kl.device)
        m, l, acc = local_decode_stats(ql, kl, vl,
                                       pos[None, :] < ll[:, None])
        if group is None:
            return combine_decode_stats(m[None], l[None], acc[None])
        stats = all_gather_stack(
            torch.cat([m[..., None], l[..., None], acc], dim=-1), group)
        return combine_decode_stats(stats[..., 0], stats[..., 1],
                                    stats[..., 2:])

    return on_local(local, (q, k, v, lengths),
                    [batch, k.placements, v.placements, batch],
                    out_placements=batch)


def placed_write_at(cache, at, new) -> None:
    """``cache[b, at[b]] = new[b]`` in place on a placed cache (B, S, ...)
    (a DTensor, the sequence split over at most one mesh dimension): each
    rank writes the rows whose position falls in its slice; a position
    past the cache is dropped."""
    from ..dist.dtensor import is_dtensor
    _, start = _seq_split(cache)
    batch = batch_placements(cache)
    local = cache.to_local()
    at = (at.redistribute(at.device_mesh, batch).to_local()
          if is_dtensor(at) else at)
    new = (new.redistribute(new.device_mesh, batch).to_local()
           if is_dtensor(new) else new)
    rel = at.long() - start
    fits = ((rel >= 0) & (rel < local.shape[1])
            & (at < cache.shape[1]))[:, None, None]
    rows = torch.arange(local.shape[0], device=local.device)
    pos = rel.clamp(0, local.shape[1] - 1)
    with torch.no_grad():
        local[rows, pos] = torch.where(fits, new.to(local.dtype),
                                       local[rows, pos])
