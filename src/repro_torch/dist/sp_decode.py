"""Decode attention split over slices of the KV cache (port of
``repro.dist.sp_decode``'s merge).

Each slice of the cache's sequence axis yields online-softmax
statistics (running max m, normaliser l, weighted value sum acc) for a
single-token GQA query; the slices merge by the log-sum-exp identity

    m*   = max_i m_i
    l*   = sum_i l_i * exp(m_i - m*)
    acc* = sum_i acc_i * exp(m_i - m*)
    out  = acc* / l*

which is the attention over the whole cache.  Both functions run on
one device; the sharded step over a mesh (``sp_decode_attention``) is
not ported yet.
"""
from __future__ import annotations

import math
from typing import Tuple

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


def sp_decode_attention(mesh, axis: str):
    """The decode attention with the cache sharded over ``mesh``'s
    ``axis``: not ported yet (the mesh paths, ROADMAP Queue 1 item 4)."""
    raise NotImplementedError(
        "sp_decode_attention needs a mesh; the mesh paths are not ported "
        "yet (ROADMAP Queue 1 item 4). On one device, merge slices with "
        "local_decode_stats and combine_decode_stats")
