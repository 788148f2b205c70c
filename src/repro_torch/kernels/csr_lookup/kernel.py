"""Wrappers of the CUDA kernels in ``csrc/csr_lookup.cu``.

``csr_lookup_kernel`` replaces ``repro/kernels/csr_lookup/kernel.py::
csr_lookup_pallas`` and ``retrieve_windows_kernel`` replaces
``retrieve_windows_pallas`` fused with the window merge;
``csr_lookup_packed_kernel`` and ``retrieve_windows_packed_kernel`` are
the same two over tile-packed doc ids (``csr_lookup_packed_pallas``,
``retrieve_windows_packed_pallas``).  A first-stage scan first builds its
lane-bounds table once (``lane_bounds_kernel`` /
``lane_bounds_packed_kernel``: each lane's first posting at every
doc), and each block launch reads it.  The source file says what bounds
each kernel on the H100 and what the design does about it.

A wrapper given CUDA tensors validates them, allocates its output with
``torch.empty``, launches on PyTorch's current stream, raises on a
nonzero ``cudaGetLastError`` and adds one to its ``launches`` count.
Given CPU tensors it runs its plain PyTorch version instead, which
repeats the kernel's algorithm so the CPU tests check the tile-edge,
decode and table logic: :func:`csr_lookup_plain` (the raw kernel's
warp searches through :func:`warp_search`: the whole-range cut, the
fence rounds, the ``jt`` clamp, the id rounds, the fence-edge case),
:func:`csr_lookup_packed_plain` (the packed kernel's rounds: the fence
search, the chosen tile's metadata, the id rounds over decoded probes,
the fence-edge case, the dequant), ``ref.lane_bounds_ref`` /
``ref.lane_bounds_packed_ref`` (the table) and ``ref.assemble_block_ref``
(M from the table).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from typing import Optional

import torch

from ...core.codec import decode_word
from ...core.index import INT32_MAX, fence_count
from ..utils import (SOURCES, check_cuda_tensor, check_launch,
                     load_library, ptr, stream_handle)
from .ref import (assemble_block_ref, bisect_steps, lane_bounds_packed_ref,
                  lane_bounds_ref, scan_edges)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "csr_lookup_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P,
                          _I, _I, _I, _I, _P],
    "lane_bounds_launch": [_P, _P, _P, _L, _I, _L, _I, _P, _P],
    "retrieve_block_launch": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                              _P],
    "csr_lookup_packed_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                                 _I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I,
                                 _P],
    "lane_bounds_packed_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _L, _I, _P, _P],
    "retrieve_block_packed_launch": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I,
                                     _I, _P],
}


def _lib() -> ctypes.CDLL:
    return load_library("csr_lookup", _SIGNATURES)


def _search_widths() -> dict:
    """The lookup kernels' search widths, read from the constants that
    ``csr_lookup.cu`` defines them by, so that the plain versions search
    in the kernels' rounds."""
    text = SOURCES["csr_lookup"].read_text()
    names = ("kFenceProbes", "kFenceMinStep", "kIdProbes", "kIdMinStep",
             "kWholeRange")
    found = {n: re.findall(rf"\b{n} = (\d+)[,;]", text) for n in names}
    if any(len(v) != 1 for v in found.values()):
        raise RuntimeError(f"csr_lookup.cu must define each of {names} "
                           f"once, found {found}")
    return {n: int(v[0]) for n, v in found.items()}


_W = _search_widths()
# (probes per lane, least chunk) of the fence search and of the id search,
# and the longest range searched whole, without the fences
FENCE_SEARCH = (_W["kFenceProbes"], _W["kFenceMinStep"])
ID_SEARCH = (_W["kIdProbes"], _W["kIdMinStep"])
WHOLE_RANGE = _W["kWholeRange"]


def warp_search(a, b, d, at, v_at, probes: int, min_step: int):
    """The kernel's ``warp_search`` over every cell at once: the first
    index in [a, b) whose value ``at(index)`` is >= d (``b`` if none), in
    rounds of at most ``32 * probes`` chunks, each chunk's last element
    probed (every element once the range fits one round, chunks of at
    least ``min_step`` before that).  Returns it and the value at it as
    the kernel tracks it (``v_at`` where no round found one)."""
    chunks_max = 32 * probes
    chunk = torch.arange(chunks_max, device=a.device)
    while bool((a < b).any()):
        n = (b - a).clamp(min=0)
        step = torch.where(n <= chunks_max, 1, torch.clamp(
            (n + chunks_max - 1) // chunks_max, min=min_step))
        chunks = (n + step - 1) // step
        last = torch.minimum(a[..., None] + (chunk + 1) * step[..., None],
                             b[..., None]) - 1
        f = at(last)
        ge = (chunk < chunks[..., None]) & (f >= d[..., None])
        hit = ge.any(-1)
        m = torch.where(hit, (ge.cumsum(-1) == 0).sum(-1), chunks)
        v_at = torch.where(hit, f.gather(-1, m.clamp(max=chunks_max - 1)
                                         [..., None])[..., 0], v_at)
        a_new = a + m * step
        b = torch.where(hit, torch.minimum(a + (m + 1) * step, b) - 1, b)
        a = torch.where(hit, a_new, b)
    return a, v_at


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _fence_round(shard, lo, hi, doc_targets, fences, tile: int, skip=None):
    """The lookup kernels' routing and fence search over every (b, q) cell
    at once (int64): routing (Q,) per term or (Q, B) per pair, then
    :func:`warp_search` over each cell's own fences (j_lo, j_hi], none
    where ``skip``; returns the cell's shard, range and doc, the tile jt
    before the first fence >= d (j_hi where none is, clamped into the
    row), its window less [lo, hi), and the tracked fence jt + 1 (0 where
    no fence was found)."""
    n_k, n_fence = fences.shape
    shape = (doc_targets.shape[0], shard.shape[0])          # (B, Q)
    if shard.ndim == 2:                         # per-pair routing (Q, B)
        k, lo0, hi0 = shard.T, lo.T, hi.T
    else:
        k, lo0, hi0 = (shard[None].expand(shape), lo[None].expand(shape),
                       hi[None].expand(shape))
    k = k.long().clamp(0, n_k - 1)
    lo0, hi0 = lo0.long(), hi0.long()
    d = doc_targets[:, None].expand(shape).long()
    kf = k * n_fence

    def fence(j):                   # (cell, probe)
        return fences.reshape(-1)[kf[..., None] + j.clamp(0, n_fence - 1)
                                  ].long()

    j_lo = _floordiv(lo0, tile)
    j_hi = torch.maximum(_floordiv(hi0 - 1, tile), j_lo)
    j_end = j_hi + 1 if skip is None else torch.where(skip, j_lo + 1,
                                                       j_hi + 1)
    jf, v_edge = warp_search(j_lo + 1, j_end, d, fence, torch.zeros_like(d),
                             *FENCE_SEARCH)
    jt = (jf - 1).clamp(0, n_fence - 1)
    base = jt * tile
    return (k, lo0, hi0, d, jt, base, torch.maximum(base, lo0),
            torch.minimum(base + tile, hi0), v_edge)


def csr_lookup_plain(shard, lo, hi, doc_targets, doc_ids, fences, values,
                     *, tile: int) -> torch.Tensor:
    """The kernel's per-cell search over all (b, q) cells at once, in
    plain PyTorch (int64 positions), through :func:`warp_search` with the
    kernel's widths: a range of at most WHOLE_RANGE postings searched
    whole, a longer one first narrowed by the fence search to one tile;
    the same clamps.  Same inputs and output as :func:`csr_lookup_kernel`."""
    n_max = doc_ids.shape[1]
    dflat = doc_ids.reshape(-1)
    # the window: a range of at most WHOLE_RANGE postings whole; a longer
    # one narrowed to the tile jt whose fence is the last below d, less
    # [lo, hi), with fence jt + 1 standing in for the id at its end
    whole = hi - lo <= WHOLE_RANGE
    if shard.ndim == 1:
        whole = whole[None].expand(doc_targets.shape[0], -1)
    else:
        whole = whole.T
    k, lo0, hi0, d, _, _, w_lo, w_hi, v_edge = _fence_round(
        shard, lo, hi, doc_targets, fences, tile, whole)
    w_lo = torch.where(whole, lo0, w_lo)
    w_hi = torch.where(whole, hi0, w_hi)
    dbase = k * n_max

    def doc_at(p):                  # int32 max past the row: the tile pad
        p = p.clamp(min=0)
        return torch.where(p < n_max, dflat[dbase[..., None] + p.clamp(
            max=n_max - 1)].long(), INT32_MAX)

    # the first id >= d in the window, or its end (its start when empty)
    pos, v_at = warp_search(w_lo, torch.maximum(w_lo, w_hi), d, doc_at,
                            v_edge, *ID_SEARCH)
    found = (pos < hi0) & (v_at == d)
    rows = values.reshape((-1,) + tuple(values.shape[2:]))
    vals = rows[dbase + pos.clamp(0, n_max - 1)]
    return torch.where(found[..., None, None], vals, 0.0)


def csr_lookup_kernel(shard, lo, hi, doc_targets, doc_ids, fences, values,
                      *, tile: int) -> torch.Tensor:
    """shard/lo/hi (Q,) int32 routed per term, or (Q, B) routed per pair;
    doc_targets (B,) int32; doc_ids (K, Nmax) int32 (unpadded: the kernel
    reads int32 max past the row end); fences (K, ceil(Nmax/tile)) int32;
    values (K, Nmax, n_b, n_f) f32 -> M (B, Q, n_b, n_f) f32."""
    if doc_ids.device.type != "cuda":
        return csr_lookup_plain(shard, lo, hi, doc_targets, doc_ids, fences,
                                values, tile=tile)
    dev = doc_ids.device
    n_q, n_cand = shard.shape[0], doc_targets.shape[0]
    route_ndim = shard.ndim
    if route_ndim not in (1, 2) or (route_ndim == 2
                                    and shard.shape[1] != n_cand):
        raise ValueError(f"routing must be (Q,) or (Q, B={n_cand}), got "
                         f"{tuple(shard.shape)}")
    for name, t in (("shard", shard), ("lo", lo), ("hi", hi)):
        check_cuda_tensor(name, t, torch.int32, dev, route_ndim)
        if t.shape != shard.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != shard "
                             f"shape {tuple(shard.shape)}")
    check_cuda_tensor("doc_targets", doc_targets, torch.int32, dev, 1)
    check_cuda_tensor("doc_ids", doc_ids, torch.int32, dev, 2)
    check_cuda_tensor("fences", fences, torch.int32, dev, 2)
    check_cuda_tensor("values", values, torch.float32, dev, 4)
    n_k, n_max = doc_ids.shape
    if fences.shape[0] != n_k or values.shape[:2] != doc_ids.shape:
        raise ValueError("doc_ids, fences and values disagree on (K, Nmax)")
    if fences.shape[1] * tile < n_max:
        raise ValueError(f"{fences.shape[1]} fences at tile {tile} do not "
                         f"cover {n_max} postings")
    out = torch.empty((n_cand, n_q) + tuple(values.shape[2:]),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.csr_lookup_launch(
        ptr(shard), ptr(lo), ptr(hi), int(route_ndim == 2),
        ptr(doc_targets), ptr(doc_ids), n_max, ptr(fences),
        fences.shape[1], ptr(values), values.shape[2] * values.shape[3],
        ptr(out), n_q, n_cand, n_k, int(tile), stream_handle())
    check_launch(lib, rc, "csr_lookup_kernel")
    csr_lookup_kernel.launches += 1
    return out


csr_lookup_kernel.launches = 0


@dataclasses.dataclass(frozen=True)
class LaneBounds:
    """A first-stage scan's lane-bounds table, built once per scan by
    :func:`lane_bounds_kernel` / :func:`lane_bounds_packed_kernel` and
    read by every block launch: ``table[q, k, i]`` is the first flat
    posting position of lane (q, k) whose doc id is >= doc ``origin +
    i``, for every doc of the ``n_blocks`` blocks of ``block`` docs from
    ``origin`` and the end: (Q, K, n_blocks * block + 1) int32, 4 bytes
    per lane and doc."""
    table: torch.Tensor
    origin: int
    block: int
    n_blocks: int

    def edge0(self, blo: int, block: int) -> int:
        """The table column of block ``[blo, blo + block)``'s first doc;
        raises for a block the table was not built for."""
        b, r = divmod(int(blo) - self.origin, self.block)
        if block != self.block or r or not 0 <= b < self.n_blocks:
            raise ValueError(
                f"block [{blo}, {blo} + {block}) is not one of the table's "
                f"{self.n_blocks} blocks of {self.block} docs from "
                f"{self.origin}")
        return b * self.block


def _check_lanes(lane_lo, lane_hi, n_k: int, dev):
    check_cuda_tensor("lane_lo", lane_lo, torch.int32, dev, 2)
    check_cuda_tensor("lane_hi", lane_hi, torch.int32, dev, 2)
    n_q = lane_lo.shape[0]
    if lane_lo.shape != (n_q, n_k) or lane_hi.shape != (n_q, n_k):
        raise ValueError(f"lanes must be (Q, K={n_k}), got "
                         f"{tuple(lane_lo.shape)} / {tuple(lane_hi.shape)}")
    if n_q * n_k > 65535:
        raise ValueError(f"{n_q * n_k} lanes exceed the table launch's "
                         "65,535 grid rows")
    return n_q


def _scan_args(origin: int, block: int, n_blocks: int):
    if block <= 0 or n_blocks <= 0:
        raise ValueError(f"block ({block}) and n_blocks ({n_blocks}) must "
                         "be > 0")
    return int(origin), int(block), int(n_blocks)


def lane_bounds_kernel(doc_ids, lane_lo, lane_hi, origin: int, block: int,
                       n_blocks: int = 1) -> LaneBounds:
    """The lane-bounds table of a scan over raw ids: doc_ids (K, Nmax)
    int32, lane_lo / lane_hi (Q, K) int32 flat posting ranges
    (``ref.retrieve_lanes``).  One thread per (lane, doc) runs the scan's
    bisect over its lane (``ref.lane_bounds_ref`` on CPU tensors)."""
    origin, block, n_blocks = _scan_args(origin, block, n_blocks)
    n_edges = n_blocks * block + 1
    if doc_ids.device.type != "cuda":
        return LaneBounds(lane_bounds_ref(
            doc_ids, lane_lo, lane_hi, scan_edges(origin, n_edges - 1)),
            origin, block, n_blocks)
    dev = doc_ids.device
    check_cuda_tensor("doc_ids", doc_ids, torch.int32, dev, 2)
    n_k, n_max = doc_ids.shape
    n_q = _check_lanes(lane_lo, lane_hi, n_k, dev)
    table = torch.empty((n_q, n_k, n_edges), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.lane_bounds_launch(
        ptr(lane_lo), ptr(lane_hi), ptr(doc_ids), n_k * n_max, n_q * n_k,
        origin, n_edges, ptr(table), stream_handle())
    check_launch(lib, rc, "lane_bounds_kernel")
    lane_bounds_kernel.launches += 1
    return LaneBounds(table, origin, block, n_blocks)


lane_bounds_kernel.launches = 0


def _launch_block(name: str, values, lane_scale, n_q: int, n_k: int,
                  blo: int, block: int, bounds: LaneBounds) -> torch.Tensor:
    """One block launch of the scan: M (block, Q, n_b, n_f) from the
    table and the values (f32, or int8 with ``lane_scale`` (Q, K))."""
    dev = values.device
    check_cuda_tensor("bounds", bounds.table, torch.int32, dev, 3)
    if bounds.table.shape[:2] != (n_q, n_k):
        raise ValueError(f"bounds table {tuple(bounds.table.shape)} does "
                         f"not match the lanes (Q={n_q}, K={n_k})")
    e0 = bounds.edge0(blo, block)
    out = torch.empty((block, n_q) + tuple(values.shape[2:]),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    rc = getattr(lib, name)(
        ptr(bounds.table), bounds.table.shape[2], e0, ptr(values),
        int(values.dtype == torch.int8),
        None if lane_scale is None else ptr(lane_scale),
        values.shape[2] * values.shape[3], ptr(out), n_q, n_k, int(block),
        stream_handle())
    check_launch(lib, rc, name)
    return out


def retrieve_windows_kernel(doc_ids, values, lane_lo, lane_hi, blo: int,
                            block: int, *, tile: int = 0,
                            bounds: Optional[LaneBounds] = None
                            ) -> torch.Tensor:
    """First-stage scan of one doc block: doc_ids (K, Nmax) int32, values
    (K, Nmax, n_b, n_f) f32, lane_lo/lane_hi (Q, K) int32 flat posting
    ranges (``ref.retrieve_lanes``) -> M (block, Q, n_b, n_f) f32 for
    docs ``[blo, blo + block)``.  ``bounds`` is the scan's lane-bounds
    table (:func:`lane_bounds_kernel`, built once for all its blocks);
    without it this call builds one for its own block (a second launch).
    The block launch reads the table and the value rows only, one CTA per
    4 docs.  ``tile`` is not used (the kernel has no windows); it stays
    for the callers that pass it."""
    del tile
    if bounds is None:
        bounds = lane_bounds_kernel(doc_ids, lane_lo, lane_hi, blo, block)
    if doc_ids.device.type != "cuda":
        return assemble_block_ref(values, None, bounds.table,
                                  bounds.edge0(blo, block), block)
    dev = doc_ids.device
    check_cuda_tensor("values", values, torch.float32, dev, 4)
    n_k = values.shape[0]
    out = _launch_block("retrieve_block_launch", values, None,
                        lane_lo.shape[0], n_k, blo, block, bounds)
    retrieve_windows_kernel.launches += 1
    return out


retrieve_windows_kernel.launches = 0


def _check_packed(packed, fences, values, dev, tile: int):
    """Validate the packed layout a packed kernel reads; -> (K, W, F)."""
    words, bits, base, woff = packed
    check_cuda_tensor("packed_words", words, torch.int32, dev, 2)
    for name, a in (("tile_bits", bits), ("tile_base", base),
                    ("tile_word_off", woff), ("fences", fences)):
        check_cuda_tensor(name, a, torch.int32, dev, 2)
    if values.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"values have dtype {values.dtype}, expected "
                        "float32 or int8")
    check_cuda_tensor("values", values, values.dtype, dev, 4)
    n_k, n_fence = fences.shape
    if (words.shape[0] != n_k or values.shape[0] != n_k
            or bits.shape != (n_k, n_fence) or base.shape != bits.shape
            or woff.shape != (n_k, n_fence + 1)):
        raise ValueError("packed words, tile metadata, fences and values "
                         "disagree on (K, F)")
    if n_fence != fence_count(values.shape[1], tile):
        raise ValueError(f"{n_fence} packed tiles do not match "
                         f"{values.shape[1]} postings at tile {tile}")
    return n_k, words.shape[1], n_fence


def _check_scale(scale, values, dev, shape):
    if values.dtype != torch.int8:
        return None
    if scale is None:
        raise ValueError("int8 values need their dequant scales")
    check_cuda_tensor("scale", scale, torch.float32, dev, len(shape))
    if tuple(scale.shape) != tuple(shape):
        raise ValueError(f"scale shape {tuple(scale.shape)} != "
                         f"{tuple(shape)}")
    return scale


def csr_lookup_packed_plain(shard, lo, hi, doc_targets, packed, fences,
                            values, scale, *, tile: int) -> torch.Tensor:
    """The packed kernel's rounds over all (b, q) cells at once, in plain
    PyTorch (int64 positions): routing as ``csr_lookup_plain`` takes it;
    the fence search (:func:`warp_search` with the kernel's widths) over
    the term's own fences; the chosen tile's (c, base, word offset): tile
    ``jf - 1``, or ``j_hi`` where no fence is >= d, clamped as the kernel
    clamps it; the search over the window's decoded ids, with fence ``jt
    + 1`` for the window's end; the row, dequantised under q8 by one f32
    multiply.  Same inputs and output as
    :func:`csr_lookup_packed_kernel`."""
    words, bits, tbase, woff = packed
    n_fence, n_words, n_max = fences.shape[1], words.shape[1], values.shape[1]
    k, _, hi0, d, jt, base, w_lo, w_hi, v_edge = _fence_round(
        shard, lo, hi, doc_targets, fences, tile)
    # the chosen tile's metadata
    kf = k * n_fence + jt
    c, tb = bits.reshape(-1)[kf].long(), tbase.reshape(-1)[kf]
    w0 = k * n_words + woff.reshape(-1)[kf + k].long()
    wflat = words.reshape(-1)

    def decode(p):                  # positions (cell, probe) of tile jt
        bp = (p - base[..., None]) * c[..., None]
        w = wflat[(w0[..., None] + _floordiv(bp, 32)).clamp(
            0, wflat.shape[0] - 1)]
        return decode_word(w, bp, c[..., None], tb[..., None]).long()

    # the first id >= d in the window, or its end (its start when empty)
    pos, v_at = warp_search(w_lo, torch.maximum(w_lo, w_hi), d, decode,
                            v_edge, *ID_SEARCH)
    found = (pos < hi0) & (v_at == d)
    rows = values.reshape((-1,) + tuple(values.shape[2:]))
    vals = rows[k * n_max + pos.clamp(0, n_max - 1)]
    if values.dtype == torch.int8:              # the pair's scale, (B, Q)
        sc = scale.T if scale.ndim == 2 else scale[None]
        vals = vals.to(torch.float32) * sc[..., None, None]
    return torch.where(found[..., None, None], vals, 0.0)


def csr_lookup_packed_kernel(shard, lo, hi, doc_targets, packed, fences,
                             values, scale=None, *, tile: int
                             ) -> torch.Tensor:
    """shard/lo/hi (Q,) or (Q, B) int32 routing as in
    :func:`csr_lookup_kernel`; ``packed = (packed_words (K, W), tile_bits
    (K, F), tile_base (K, F), tile_word_off (K, F+1))`` int32 at codec
    tile ``tile``; fences (K, F) int32 raw; values (K, Nmax, n_b, n_f)
    f32, or int8 with ``scale`` f32 shaped like the routing (the pair's
    per-term dequant scale) -> M (B, Q, n_b, n_f) f32."""
    if values.device.type != "cuda":
        return csr_lookup_packed_plain(shard, lo, hi, doc_targets, packed,
                                       fences, values, scale, tile=tile)
    dev = values.device
    n_q, n_cand = shard.shape[0], doc_targets.shape[0]
    route_ndim = shard.ndim
    if route_ndim not in (1, 2) or (route_ndim == 2
                                    and shard.shape[1] != n_cand):
        raise ValueError(f"routing must be (Q,) or (Q, B={n_cand}), got "
                         f"{tuple(shard.shape)}")
    for name, t in (("shard", shard), ("lo", lo), ("hi", hi)):
        check_cuda_tensor(name, t, torch.int32, dev, route_ndim)
        if t.shape != shard.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != shard "
                             f"shape {tuple(shard.shape)}")
    check_cuda_tensor("doc_targets", doc_targets, torch.int32, dev, 1)
    n_k, n_words, n_fence = _check_packed(packed, fences, values, dev, tile)
    scale = _check_scale(scale, values, dev, shard.shape)
    words, bits, base, woff = packed
    out = torch.empty((n_cand, n_q) + tuple(values.shape[2:]),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.csr_lookup_packed_launch(
        ptr(shard), ptr(lo), ptr(hi), int(route_ndim == 2),
        ptr(doc_targets), ptr(words), n_words, ptr(bits), ptr(base),
        ptr(woff), ptr(fences), n_fence, ptr(values),
        int(values.dtype == torch.int8), values.shape[1],
        None if scale is None else ptr(scale),
        values.shape[2] * values.shape[3], ptr(out), n_q, n_cand, n_k,
        int(tile), stream_handle())
    check_launch(lib, rc, "csr_lookup_packed_kernel")
    csr_lookup_packed_kernel.launches += 1
    return out


csr_lookup_packed_kernel.launches = 0


def lane_bounds_packed_kernel(packed, fences, values, lane_lo, lane_hi,
                              origin: int, block: int, n_blocks: int = 1, *,
                              tile: int) -> LaneBounds:
    """:func:`lane_bounds_kernel` over packed ids: ``packed``, fences and
    values as in :func:`csr_lookup_packed_kernel` (values give Nmax);
    each (lane, doc) thread runs the two-level packed bisect
    (``ref.lane_bounds_packed_ref`` on CPU tensors)."""
    origin, block, n_blocks = _scan_args(origin, block, n_blocks)
    n_edges = n_blocks * block + 1
    if values.device.type != "cuda":
        return LaneBounds(lane_bounds_packed_ref(
            packed, fences, values.shape[1], lane_lo, lane_hi,
            scan_edges(origin, n_edges - 1), tile=tile), origin, block,
            n_blocks)
    dev = values.device
    n_k, n_words, n_fence = _check_packed(packed, fences, values, dev, tile)
    n_q = _check_lanes(lane_lo, lane_hi, n_k, dev)
    words, bits, base, woff = packed
    table = torch.empty((n_q, n_k, n_edges), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.lane_bounds_packed_launch(
        ptr(lane_lo), ptr(lane_hi), ptr(words), n_words, ptr(bits),
        ptr(base), ptr(woff), ptr(fences), n_fence, values.shape[1], n_q,
        n_k, int(tile), bisect_steps(n_fence), bisect_steps(tile), origin,
        n_edges, ptr(table), stream_handle())
    check_launch(lib, rc, "lane_bounds_packed_kernel")
    lane_bounds_packed_kernel.launches += 1
    return LaneBounds(table, origin, block, n_blocks)


lane_bounds_packed_kernel.launches = 0


def retrieve_windows_packed_kernel(packed, fences, values, lane_scale,
                                   lane_lo, lane_hi, blo: int, block: int,
                                   *, tile: int,
                                   bounds: Optional[LaneBounds] = None
                                   ) -> torch.Tensor:
    """First-stage scan of one doc block over packed ids: ``packed``,
    fences and values as in :func:`csr_lookup_packed_kernel`;
    ``lane_scale`` (Q, K) f32 for int8 values (else None); lane_lo /
    lane_hi (Q, K) int32 flat posting ranges -> M (block, Q, n_b, n_f)
    f32 for docs ``[blo, blo + block)``.  ``bounds`` as in
    :func:`retrieve_windows_kernel` (:func:`lane_bounds_packed_kernel`):
    the table holds every id the block needs, so the block launch
    decodes nothing."""
    if bounds is None:
        bounds = lane_bounds_packed_kernel(packed, fences, values, lane_lo,
                                           lane_hi, blo, block, tile=tile)
    int8 = values.dtype == torch.int8
    if values.device.type != "cuda":
        return assemble_block_ref(values, lane_scale if int8 else None,
                                  bounds.table, bounds.edge0(blo, block),
                                  block)
    dev = values.device
    if values.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"values have dtype {values.dtype}, expected "
                        "float32 or int8")
    check_cuda_tensor("values", values, values.dtype, dev, 4)
    n_q, n_k = lane_lo.shape[0], values.shape[0]
    lane_scale = _check_scale(lane_scale, values, dev, (n_q, n_k))
    out = _launch_block("retrieve_block_packed_launch", values, lane_scale,
                        n_q, n_k, blo, block, bounds)
    retrieve_windows_packed_kernel.launches += 1
    return out


retrieve_windows_packed_kernel.launches = 0
