"""Wrapper of the CUDA kernel in ``csrc/seg_interact.cu``, which replaces
``repro/kernels/seg_interact/kernel.py::seg_interact_pallas`` (the source
file says what bounds it on the H100 and what the design does about it),
and its plain PyTorch version.

Both take the ragged layout of the build: per doc b, term embeddings
``e_term (B, U, De)``, token embeddings ``e_tok (B, L, De)``, each
token's segment ``seg (B, L)`` (outside ``[0, n_seg)``: the token is
excluded) and ``term_ids (B, U)`` (negative: a pad term, whose rows are
zeros), and return ``(B, U, n_seg, 3)`` = (dot sum, cosine sum, gauss
max) per (term, segment).

Given CUDA tensors :func:`seg_interact_kernel` validates them, allocates
its output with ``torch.empty``, launches on PyTorch's current stream,
raises on a nonzero ``cudaGetLastError`` and adds one to its
``launches`` count.  Given CPU tensors it runs :func:`seg_interact_plain`.

:func:`fold_events` mirrors the kernel's work partition in plain Python:
the segment chunks, the live-token compaction per window, the token
tiles, the fold classes and the term tiles, so that the tests check here
which (term, token) pairs each cell sums, and in what order.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, ptr,
                     stream_handle)

SEG_CHUNK = 64       # segments a block owns (csrc kMaxSeg): any n_seg
TOKEN_TILE = 64      # live tokens per tile
SLICE = 16           # live tokens one fold thread walks per tile
N_CLASSES = TOKEN_TILE // SLICE
WINDOW = 512         # positions compacted at a time
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"seg_interact_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _P]}


def term_tile_for(n_u: int) -> int:
    """The kernel's terms per block for a launch of ``n_u`` term slots: 8
    when they fit (a No-Index query), else 16."""
    return 8 if n_u <= 8 else 16


def n_chunks(n_seg: int) -> int:
    """Blocks per (doc, term tile): one per SEG_CHUNK segments."""
    return -(-int(n_seg) // SEG_CHUNK)


def live_windows(seg_row, n_seg: int, chunk: int = 0) -> List[np.ndarray]:
    """One doc's live positions for segment chunk ``chunk`` (seg in
    ``[SEG_CHUNK * chunk, SEG_CHUNK * (chunk + 1))`` and in ``[0,
    n_seg)``) in token order, as the kernel compacts them: one array per
    window of WINDOW positions, empty windows left out."""
    seg_row = np.asarray(seg_row)
    lo = SEG_CHUNK * chunk
    hi = min(lo + SEG_CHUNK, n_seg)
    out = []
    for w0 in range(0, seg_row.shape[0], WINDOW):
        s = seg_row[w0:w0 + WINDOW]
        pos = w0 + np.flatnonzero((s >= lo) & (s < hi))
        if pos.size:
            out.append(pos)
    return out


def fold_events(seg, term_ids, n_seg: int
                ) -> List[Tuple[int, int, int, int, int]]:
    """The kernel's work partition for one launch, in the order its loops
    run: blocks (doc b, a tile of :func:`term_tile_for` terms, a chunk of
    SEG_CHUNK segments), then each window's token tiles of TOKEN_TILE
    live tokens of the chunk, then fold thread (term u, class c) walking
    the tile's live tokens ``SLICE c .. SLICE (c + 1) - 1``.  Returns
    ``(b, u, position, segment, class)`` per (term, token) pair folded.

    A cell (b, u, s) sums its events of each class in list order, then
    adds the classes in order (gauss: their max).  A tile of pad terms
    folds nothing (it writes zeros), nor does a pad term in a live tile
    (its rows are zeroed) or a token outside ``[0, n_seg)``."""
    seg = np.asarray(seg.cpu() if torch.is_tensor(seg) else seg)
    ids = np.asarray(term_ids.cpu() if torch.is_tensor(term_ids)
                     else term_ids)
    n_b, n_u = ids.shape
    tu = term_tile_for(n_u)
    events = []
    for b in range(n_b):
        chunks = [live_windows(seg[b], n_seg, ch)
                  for ch in range(n_chunks(n_seg))]
        for u0 in range(0, n_u, tu):
            terms = [u for u in range(u0, min(u0 + tu, n_u)) if ids[b, u] >= 0]
            for windows in chunks:
                for pos in windows:
                    for t0 in range(0, pos.size, TOKEN_TILE):
                        tile = pos[t0:t0 + TOKEN_TILE]
                        for c in range(N_CLASSES):
                            for u in terms:
                                for p in tile[c * SLICE:(c + 1) * SLICE]:
                                    events.append((b, u, int(p),
                                                   int(seg[b, p]), c))
    return events


def _inv_norm(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-9)


def seg_interact_plain(e_term: torch.Tensor, e_tok: torch.Tensor,
                       seg: torch.Tensor, term_ids: torch.Tensor,
                       n_seg: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one ``bmm`` of the scores,
    then a scatter-add (dot, cosine) and a ``scatter_reduce("amax")``
    (gauss) by segment into ``n_seg + 1`` bins, the last one collecting
    the excluded tokens and sliced off."""
    n_b, n_u, _ = e_term.shape
    n_l = e_tok.shape[1]
    scores = torch.bmm(e_term, e_tok.transpose(1, 2))          # (B, U, L)
    seg = seg.long()
    keep = (seg >= 0) & (seg < n_seg)
    idx = torch.where(keep, seg, n_seg)[:, None, :].expand(n_b, n_u, n_l)
    bins = (n_b, n_u, n_seg + 1)
    dot = scores.new_zeros(bins).scatter_add_(2, idx, scores)
    cos = scores.new_zeros(bins).scatter_add_(
        2, idx, scores * _inv_norm(e_tok)[:, None, :])
    cos = cos * _inv_norm(e_term)[..., None]
    v2 = (e_term * e_term).sum(-1)
    t2 = (e_tok * e_tok).sum(-1)
    neg = -((v2[..., None] + t2[:, None, :]) - 2.0 * scores)
    mx = scores.new_full(bins, float("-inf")).scatter_reduce_(
        2, idx, neg, "amax", include_self=False)
    gauss = torch.where(torch.isfinite(mx), torch.exp(mx),
                        torch.zeros((), dtype=mx.dtype))
    out = torch.stack([dot, cos, gauss], dim=-1)[:, :, :n_seg]
    return out * (term_ids >= 0)[..., None, None]


def seg_interact_kernel(e_term: torch.Tensor, e_tok: torch.Tensor,
                        seg: torch.Tensor, term_ids: torch.Tensor,
                        n_seg: int) -> torch.Tensor:
    """e_term (B, U, De) f32, e_tok (B, L, De) f32, seg (B, L) int32,
    term_ids (B, U) int32 -> (B, U, n_seg, 3) f32, at any n_seg: one
    launch whose blocks each own SEG_CHUNK segments."""
    if e_term.device.type != "cuda":
        return seg_interact_plain(e_term, e_tok, seg, term_ids, n_seg)
    dev = e_term.device
    check_cuda_tensor("e_term", e_term, torch.float32, dev, 3)
    check_cuda_tensor("e_tok", e_tok, torch.float32, dev, 3)
    check_cuda_tensor("seg", seg, torch.int32, dev, 2)
    check_cuda_tensor("term_ids", term_ids, torch.int32, dev, 2)
    n_b, n_u, de = e_term.shape
    n_l = e_tok.shape[1]
    if e_tok.shape != (n_b, n_l, de) or seg.shape != (n_b, n_l) \
            or term_ids.shape != (n_b, n_u):
        raise ValueError(
            f"shapes disagree: e_term {tuple(e_term.shape)}, e_tok "
            f"{tuple(e_tok.shape)}, seg {tuple(seg.shape)}, term_ids "
            f"{tuple(term_ids.shape)}")
    if int(n_seg) < 1:
        raise ValueError(f"n_seg must be at least 1, got {n_seg}")
    if de < 1:
        raise ValueError("the embedding width must be at least 1")
    out = torch.empty((n_b, n_u, int(n_seg), 3), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = load_library("seg_interact", _SIGNATURES)
    rc = lib.seg_interact_launch(ptr(e_term), ptr(e_tok), ptr(seg),
                                 ptr(term_ids), ptr(out), n_b, n_u, n_l, de,
                                 int(n_seg), stream_handle())
    check_launch(lib, rc, "seg_interact_kernel")
    seg_interact_kernel.launches += 1
    return out


seg_interact_kernel.launches = 0
