"""Tile-compressed posting codec: FOR/bit-packed doc ids + int8 values.

Port of ``repro.core.codec``.  The packers are numpy and run on the host,
as in the reference; the random-access decoders (:func:`unpack_at`,
:func:`unpack_flat`) and a device twin of :func:`quantize_values`
(:func:`quantize_values_torch`, bitwise equal to the numpy copy) are torch.

Doc ids: per posting tile, frame-of-reference coding

  base   = min(tile)                      (int32, the frame)
  bits   c in {0, 4, 8, 16, 32}           per-tile width class
  words  tile * c / 32 packed int32       (c=0: none; c=32: raw ids)

Width classes divide 32, so no value straddles a word and one element
decodes with one word load, a logical shift and a mask.  Tiles lie one
after another in a shard's word row, located by a per-tile word offset;
every row is padded by ``max_tile_words`` zero words, so a probe one
position past a tile stays inside its row.  Lossless for every int32 row.

Values (codec ``"packed-q8"``): symmetric int8 with one scale per (shard,
local term) row, ``max |v| / 127`` min-clamped at ``1e-12 / 127``, so the
dequantisation error of an entry is at most its term's ``scale / 2``.

Codec names: ``"none"`` (raw), ``"packed"`` (FOR ids, f32 values),
``"packed-q8"`` (FOR ids, int8 values + per-term scales).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .index import INT32_MAX, fence_count

CODECS = ("none", "packed", "packed-q8")
WIDTH_CLASSES = (0, 4, 8, 16, 32)
# postings per chunk of the device quantiser (bounds its temporaries)
_Q8_CHUNK = 1 << 20


def validate_codec(codec: Optional[str]) -> str:
    """Normalize ``codec`` (None -> "none") and reject unknown names."""
    c = codec or "none"
    if c not in CODECS:
        raise ValueError(f"unknown codec {c!r}; supported: {CODECS}")
    return c


class PackedIds(NamedTuple):
    """Bit-packed doc ids for K stacked shard rows: ``packed_words (K,
    W)``, ``tile_bits``/``tile_base`` ``(K, F)`` and ``tile_word_off (K,
    F+1)`` int32 with ``F = fence_count(Nmax, tile)``; ``max_tile_words``
    is the widest tile's word count (at least 8), the trailing zero pad
    of every row."""
    packed_words: np.ndarray
    tile_bits: np.ndarray
    tile_base: np.ndarray
    tile_word_off: np.ndarray
    max_tile_words: int
    tile: int
    n: int                      # unpacked row length (Nmax)

    @property
    def nbytes(self) -> int:
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in (self.packed_words, self.tile_bits,
                             self.tile_base, self.tile_word_off))


def _width_classes(span: np.ndarray) -> np.ndarray:
    """Smallest width class in {0,4,8,16,32} holding ``span`` (max-min)."""
    bits = np.full(span.shape, 32, np.int32)
    for c in (16, 8, 4):
        bits[span < (1 << c)] = c
    bits[span == 0] = 0
    return bits


def pack_row(row: np.ndarray, tile: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack one (n,) int32 row -> (words, bits, base, word_off).

    Positions [0, n) round-trip exactly; the tile-pad tail [n, F*tile) is
    filled with the row's last value before packing, so a short tail
    never forces a 32-bit tile.
    """
    if tile % 8:
        raise ValueError(f"codec tile must be a multiple of 8 (so every "
                         f"width class tiles a 32-bit word), got {tile}")
    row = np.ascontiguousarray(np.asarray(row, np.int32))
    n = row.shape[0]
    f = fence_count(n, tile)
    padded = np.empty(f * tile, np.int32)
    padded[:n] = row
    padded[n:] = row[-1] if n else 0
    tiles = padded.reshape(f, tile)
    base = tiles.min(axis=1)
    span = tiles.max(axis=1).astype(np.int64) - base.astype(np.int64)
    bits = _width_classes(span)
    wpt = (bits.astype(np.int64) * tile) // 32
    word_off = np.zeros(f + 1, np.int64)
    np.cumsum(wpt, out=word_off[1:])
    words = np.zeros(int(word_off[-1]), np.uint32)
    for c in (4, 8, 16):
        sel = np.flatnonzero(bits == c)
        if sel.size:
            rel = (tiles[sel].astype(np.int64)
                   - base[sel, None]).astype(np.uint32)
            vpw = 32 // c
            grouped = rel.reshape(sel.size, tile // vpw, vpw)
            shifts = (np.arange(vpw, dtype=np.uint32) * c)[None, None, :]
            packed = np.bitwise_or.reduce(grouped << shifts, axis=-1)
            idx = word_off[sel, None] + np.arange(tile // vpw)[None, :]
            words[idx.reshape(-1)] = packed.reshape(-1)
    sel = np.flatnonzero(bits == 32)
    if sel.size:
        idx = word_off[sel, None] + np.arange(tile)[None, :]
        words[idx.reshape(-1)] = tiles[sel].reshape(-1).view(np.uint32)
    return (words.view(np.int32), bits, base.astype(np.int32),
            word_off.astype(np.int32))


def pack_doc_ids(doc_ids: np.ndarray, tile: int) -> PackedIds:
    """Pack stacked shard rows (K, Nmax) int32 into one PackedIds; rows
    pack independently and their word buffers pad to a common width plus
    ``max_tile_words`` zero words."""
    doc_ids = np.asarray(doc_ids, np.int32)
    if doc_ids.ndim != 2:
        raise ValueError(f"expected stacked (K, Nmax) doc ids, got shape "
                         f"{doc_ids.shape}")
    k, n = doc_ids.shape
    rows = [pack_row(doc_ids[i], tile) for i in range(k)]
    mw = max(8, max(int(np.diff(wo).max(initial=0))
                    for _, _, _, wo in rows))
    w = max(int(r[0].shape[0]) for r in rows) + mw
    words = np.zeros((k, w), np.int32)
    f = fence_count(n, tile)
    bits = np.zeros((k, f), np.int32)
    base = np.zeros((k, f), np.int32)
    woff = np.zeros((k, f + 1), np.int32)
    for i, (rw, rb, rbase, rwo) in enumerate(rows):
        words[i, :rw.shape[0]] = rw
        bits[i] = rb
        base[i] = rbase
        woff[i] = rwo
    return PackedIds(words, bits, base, woff, mw, int(tile), int(n))


def unpack_row(words: np.ndarray, bits: np.ndarray, base: np.ndarray,
               word_off: np.ndarray, *, tile: int, n: int) -> np.ndarray:
    """Exact inverse of :func:`pack_row` over positions [0, n)."""
    f = bits.shape[0]
    words = np.asarray(words).view(np.uint32)
    out = np.empty((f, tile), np.int32)
    for c in WIDTH_CLASSES:
        sel = np.flatnonzero(bits == c)
        if not sel.size:
            continue
        if c == 0:
            out[sel] = base[sel, None]
        elif c == 32:
            idx = word_off[sel, None].astype(np.int64) + np.arange(tile)
            out[sel] = words[idx.reshape(-1)].reshape(
                sel.size, tile).view(np.int32)
        else:
            vpw = 32 // c
            idx = (word_off[sel, None].astype(np.int64)
                   + np.arange(tile // vpw)[None, :])
            w = words[idx.reshape(-1)].reshape(sel.size, tile // vpw, 1)
            shifts = (np.arange(vpw, dtype=np.uint32) * c)[None, None, :]
            rel = (w >> shifts) & np.uint32((1 << c) - 1)
            out[sel] = (base[sel, None]
                        + rel.reshape(sel.size, tile).astype(np.int64)
                        ).astype(np.int32)
    return out.reshape(-1)[:n]


def unpack_doc_ids(p: PackedIds) -> np.ndarray:
    """(K, Nmax) int32 — bitwise inverse of :func:`pack_doc_ids`."""
    return np.stack([
        unpack_row(p.packed_words[i], p.tile_bits[i], p.tile_base[i],
                   p.tile_word_off[i], tile=p.tile, n=p.n)
        for i in range(p.packed_words.shape[0])])


def fences_from_packed(tile_bits: np.ndarray, tile_base: np.ndarray,
                       tile_word_off: np.ndarray, packed_words: np.ndarray,
                       *, tile: int, n: int) -> np.ndarray:
    """The (K, F) fence rows from packed metadata alone: fence j is the
    decoded id at position ``j * tile`` (shift 0 of word
    ``tile_word_off[j]``), or int32 max once ``j * tile`` passes ``n`` —
    what ``core.index.build_fences`` gives on the raw ids, so a packed
    checkpoint stores no fences."""
    k, f = tile_bits.shape
    wo = np.minimum(tile_word_off[:, :f], packed_words.shape[1] - 1)
    w0 = np.take_along_axis(packed_words, wo, axis=1).view(np.uint32)
    mask = np.uint32(1) << np.minimum(tile_bits, 16).astype(np.uint32)
    rel = (w0 & (mask - np.uint32(1))).astype(np.int64)
    dec = np.where(tile_bits == 32, w0.view(np.int32),
                   (tile_base.astype(np.int64) + rel).astype(np.int32))
    live = (np.arange(f) * tile)[None, :] < n
    return np.where(live, dec, INT32_MAX).astype(np.int32)


# ---------------------------------------------------------------------------
# value quantisation (per-term int8 scales)
# ---------------------------------------------------------------------------

def quantize_values(values: np.ndarray, term_offsets: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(K, Nmax, n_b, n_f) f32 + (K, Vmax+1) offsets -> (values_q int8,
    value_scale (K, Vmax) f32): one symmetric scale per (shard, local
    term), ``max |v| / 127`` min-clamped.  Padding postings hold zeros and
    quantise to zero; empty terms keep the clamp floor."""
    values = np.asarray(values, np.float32)
    offs = np.asarray(term_offsets, np.int64)
    k, nmax = values.shape[:2]
    vmax = offs.shape[1] - 1
    amax = np.abs(values).max(axis=(2, 3))                   # (K, Nmax)
    peak = np.zeros((k, vmax), np.float32)
    pos_scale = np.empty((k, nmax), np.float32)
    for i in range(k):
        counts = np.diff(np.clip(offs[i], 0, nmax))
        term_of = np.repeat(np.arange(vmax), counts)         # (nnz_i,)
        np.maximum.at(peak[i], term_of, amax[i, :term_of.shape[0]])
        scale_i = np.maximum(peak[i], 1e-12) / 127.0
        pos_scale[i] = 1.0                                   # pad rows
        pos_scale[i, :term_of.shape[0]] = scale_i[term_of]
    q = np.clip(np.round(values / pos_scale[..., None, None]),
                -127, 127).astype(np.int8)
    return q, (np.maximum(peak, 1e-12) / 127.0).astype(np.float32)


def _term_of(offsets: torch.Tensor, nmax: int) -> torch.Tensor:
    """Local term of every stored posting of one shard, (nnz,) int64."""
    counts = torch.diff(offsets.long().clamp(0, nmax))
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=offsets.device), counts)


def position_scales(value_scale: torch.Tensor, term_offsets: torch.Tensor,
                    nmax: int) -> torch.Tensor:
    """(K, Nmax) f32: each posting's term scale, 1.0 on padding rows."""
    k = value_scale.shape[0]
    out = torch.ones((k, nmax), dtype=torch.float32,
                     device=value_scale.device)
    for i in range(k):
        term_of = _term_of(term_offsets[i], nmax)
        out[i, :term_of.shape[0]] = value_scale[i][term_of]
    return out


def quantize_values_torch(values: torch.Tensor, term_offsets: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_values` on the tensors' device, bitwise equal to
    the numpy copy (IEEE f32 max, tensor-by-tensor division and
    round-half-to-even on both sides).  Works through the postings in
    chunks, so its temporaries stay small beside a values payload of
    many GB."""
    k, nmax = values.shape[:2]
    vmax = term_offsets.shape[1] - 1
    dev = values.device
    peak = torch.zeros((k, vmax), dtype=torch.float32, device=dev)
    for i in range(k):
        term_of = _term_of(term_offsets[i], nmax)
        for a in range(0, term_of.shape[0], _Q8_CHUNK):
            b = min(a + _Q8_CHUNK, term_of.shape[0])
            amax = values[i, a:b].abs().amax(dim=(1, 2))
            peak[i].scatter_reduce_(0, term_of[a:b], amax, "amax")
    # a tensor divisor: by a Python scalar, CUDA torch multiplies by its
    # reciprocal, which rounds differently from numpy's division
    scale = torch.clamp(peak, min=1e-12) / torch.full_like(peak, 127.0)
    pos_scale = position_scales(scale, term_offsets, nmax)
    q = torch.empty(values.shape, dtype=torch.int8, device=dev)
    for i in range(k):
        for a in range(0, nmax, _Q8_CHUNK):
            b = min(a + _Q8_CHUNK, nmax)
            q[i, a:b] = torch.clamp(torch.round(
                values[i, a:b] / pos_scale[i, a:b, None, None]),
                -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# torch random-access decode
# ---------------------------------------------------------------------------

def gather_clip2(a: torch.Tensor, i: torch.Tensor, j: torch.Tensor
                 ) -> torch.Tensor:
    """``a[i, j]`` with jnp ``.at[i, j].get(mode="clip")`` semantics on
    each axis (see ``core.index.gather_clip``)."""
    n0, n1 = a.shape[:2]
    i, j = i.long(), j.long()
    i = torch.where(i < 0, i + n0, i).clamp(0, n0 - 1)
    j = torch.where(j < 0, j + n1, j).clamp(0, n1 - 1)
    return a[i, j]


def decode_word(w: torch.Tensor, bitpos: torch.Tensor, c: torch.Tensor,
                tb: torch.Tensor) -> torch.Tensor:
    """Element at bit ``bitpos`` of the packed word ``w`` in a tile of
    width ``c`` and base ``tb``: the raw word at c=32, else ``tb + ((w
    >>> (bitpos & 31)) & (2^min(c,16) - 1))`` with a LOGICAL shift of the
    32-bit word (torch's ``>>`` is arithmetic, so the word is widened to
    its unsigned value first).  int32 result; the add wraps like the
    reference's int32 add."""
    u = w.long() & 0xFFFFFFFF
    mask = (1 << torch.clamp(c.long(), max=16)) - 1
    rel = (u >> (bitpos.long() & 31)) & mask
    return torch.where(c == 32, w.long(), tb.long() + rel).to(torch.int32)


def unpack_at(packed_words: torch.Tensor, tile_bits: torch.Tensor,
              tile_base: torch.Tensor, tile_word_off: torch.Tensor,
              k: torch.Tensor, pos: torch.Tensor, *, tile: int
              ) -> torch.Tensor:
    """Decode shard-local positions ``ids[k, pos]`` without unpacking the
    rows; ``k``/``pos`` broadcastable, positions clipped into the packed
    tile range (callers mask out-of-range reads)."""
    f = tile_bits.shape[1]
    k, pos = torch.broadcast_tensors(k.long(), pos.long())
    j = torch.div(pos, tile, rounding_mode="floor").clamp(0, f - 1)
    r = (pos - j * tile).clamp(0, tile - 1)
    c = gather_clip2(tile_bits, k, j)
    tb = gather_clip2(tile_base, k, j)
    wo = gather_clip2(tile_word_off, k, j)
    bitpos = r * c
    w = gather_clip2(packed_words, k, wo + torch.div(bitpos, 32,
                                                     rounding_mode="floor"))
    return decode_word(w, bitpos, c, tb)


def unpack_flat(packed_words: torch.Tensor, tile_bits: torch.Tensor,
                tile_base: torch.Tensor, tile_word_off: torch.Tensor,
                flat_pos: torch.Tensor, *, tile: int, nmax: int
                ) -> torch.Tensor:
    """Decode positions of the flat ``(K * Nmax,)`` view."""
    n_flat = packed_words.shape[0] * nmax
    p = flat_pos.long().clamp(0, max(n_flat - 1, 0))
    k = torch.div(p, nmax, rounding_mode="floor")
    return unpack_at(packed_words, tile_bits, tile_base, tile_word_off,
                     k, p - k * nmax, tile=tile)


__all__ = ["CODECS", "WIDTH_CLASSES", "INT32_MAX", "PackedIds",
           "validate_codec", "pack_row", "pack_doc_ids", "unpack_row",
           "unpack_doc_ids", "fences_from_packed", "quantize_values",
           "quantize_values_torch", "position_scales", "gather_clip2",
           "decode_word", "unpack_at", "unpack_flat"]
