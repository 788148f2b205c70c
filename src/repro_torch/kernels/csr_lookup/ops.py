"""Public entry points of the serving lookup and the first-stage scan.

Port of ``repro.kernels.csr_lookup.ops``.  The JAX op dispatches by
backend (the Pallas kernel on TPU, the jnp ref elsewhere); this one
dispatches by the tensors' device:

* a CUDA tensor goes to the hand-written CUDA kernel (``kernel.py``);
* a CPU tensor goes to the routed torch ref lowering (``ref.py``).

``impl`` overrides that choice: ``"ref"`` forces the ref lowering on
either device (the reference a run on the card is checked against), and
``"kernel"`` forces the kernel's dataflow — routing, fences, kernel
wrapper — which on the CPU runs the kernel's plain version (the parity
tests).  A CUDA tensor never falls back to the ref on its own.

``codec="packed"``/``"packed-q8"`` serves tile-compressed postings
(``core.codec``): ``doc_ids`` is None and ``packed`` carries
``(packed_words, tile_bits, tile_base, tile_word_off)``; under q8
``values`` is int8 with ``value_scale (K, Vmax)`` per-term scales.  A
packed layout serves only at its build-time codec ``tile``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.codec import validate_codec
from ...core.index import POSTING_TILE, build_fences, fence_count
from .kernel import (csr_lookup_kernel, csr_lookup_packed_kernel,
                     lane_bounds_kernel, lane_bounds_packed_kernel,
                     retrieve_windows_kernel, retrieve_windows_packed_kernel)
from .ref import (_alive_at, _lane_scale, _route, csr_lookup_packed_ref,
                  csr_lookup_ref, lane_scales, lookup_pairs_packed_ref,
                  lookup_pairs_ref, retrieve_lanes, route_pairs,
                  route_terms, scan_block_packed_ref, scan_block_ref)

IMPLS = (None, "ref", "kernel")


def _use_kernel(impl: Optional[str], like: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; supported: {IMPLS}")
    if impl is None:
        return like.device.type == "cuda"
    return impl == "kernel"


def _check_packed_args(codec, packed, fences, values, tile, t):
    """The codec's tile width is baked into the packed layout (word
    offsets, fence spacing), so a mismatched ``tile`` cannot be re-tiled
    on the fly the way raw fences are rebuilt: refuse it."""
    if packed is None:
        raise ValueError(f"codec {codec!r} needs the packed posting "
                         "arrays (packed_words, tile_bits, tile_base, "
                         "tile_word_off)")
    if fences is None:
        raise ValueError(f"codec {codec!r} needs the build-time fence "
                         "rows (the codec keeps them uncompressed as "
                         "tile anchors; they cannot be rebuilt from "
                         "packed tiles at lookup time)")
    n_fence = fence_count(values.shape[1], t)
    if packed[1].shape[1] != n_fence or fences.shape[1] != n_fence:
        raise ValueError(
            f"tile={tile} does not match the packed tile layout "
            f"({packed[1].shape[1]} packed tiles / {fences.shape[1]} "
            f"fences vs {n_fence} expected); packed indexes serve only "
            "at their build-time codec tile")
    if codec == "packed-q8" and values.dtype != torch.int8:
        raise ValueError("codec 'packed-q8' expects int8 values")


def _route_cells(query_terms, doc_targets, term_offsets, term_to_shard,
                 range_lo, split_term, split_doc, held=None):
    """The kernels' routing: ``(k, lo, hi)`` per term (Q,), or per pair
    (Q, B) when hot terms are split by doc range; plus the term ids of
    the same shape (for the q8 scales).  ``held = (s0, s1)``: only the
    global shards ``[s0, s1)`` are in ``term_offsets`` (``ref._window``)."""
    if split_term is None:
        return route_terms(query_terms, term_offsets, term_to_shard,
                           range_lo, held) + (query_terms,)
    shape = (query_terms.shape[0], doc_targets.shape[0])     # (Q, B)
    w = query_terms[:, None].expand(shape)
    return route_pairs(w, doc_targets[None].expand(shape), term_offsets,
                       term_to_shard, range_lo, split_term,
                       split_doc, held) + (w,)


def _as_i32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int32).contiguous()


def _mask_dead_rows(out: torch.Tensor, alive, doc_targets: torch.Tensor
                    ) -> torch.Tensor:
    """Zero the rows of dead candidate docs in a kernel's output — equal
    to folding ``alive`` into the found mask, since the mask is per doc
    and not-found rows are +0.0 already."""
    if alive is None:
        return out
    keep = _alive_at(alive, doc_targets)[:, None, None, None]
    return torch.where(keep, out, 0.0)


def csr_lookup(term_offsets: torch.Tensor, doc_ids: Optional[torch.Tensor],
               values: torch.Tensor, term_to_shard, range_lo,
               query_terms: torch.Tensor, doc_targets: torch.Tensor, *,
               fences: Optional[torch.Tensor] = None,
               split_term: Optional[torch.Tensor] = None,
               split_doc: Optional[torch.Tensor] = None,
               tile: Optional[int] = None, impl: Optional[str] = None,
               codec: str = "none", packed=None,
               value_scale: Optional[torch.Tensor] = None,
               codec_spans: tuple = (0, 0),
               alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused lookup–merge: query_terms (Q,) x doc_targets (B,) over a
    K-stacked shard CSR -> M_{q,d} (B, Q, n_b, n_f); +0.0 for absent
    pairs, OOV / past-vocab terms and out-of-range doc ids.

    ``term_offsets (K, Vmax+1)`` / ``doc_ids (K, Nmax)`` / ``values (K,
    Nmax, n_b, n_f)`` are the PartitionedIndex layout; the single CSR is
    ``K == 1`` with ``term_to_shard=None``.  ``split_term``/``split_doc``
    are the doc-range sub-shard tables (routing is then per pair);
    ``fences``/``tile`` configure the kernel's two-level bisect; ``alive``
    (n_docs,) bool zeroes the pairs of deleted docs.  Packed codecs as in
    the module doc; ``codec_spans`` is the pack-time loop-bound hint of
    the ref's bisects (``(0, 0)``: worst case).
    """
    codec = validate_codec(codec)
    t = int(tile or POSTING_TILE)
    use_kernel = _use_kernel(impl, values)
    if codec != "none":
        _check_packed_args(codec, packed, fences, values, tile, t)
        if not use_kernel:
            return csr_lookup_packed_ref(
                term_offsets, packed, fences, values, value_scale,
                term_to_shard, range_lo, query_terms, doc_targets,
                split_term, split_doc, tile=t, spans=tuple(codec_spans),
                alive=alive)
        k, lo, hi, w = _route_cells(query_terms, doc_targets, term_offsets,
                                    term_to_shard, range_lo, split_term,
                                    split_doc)
        scale = (None if value_scale is None else
                 _lane_scale(value_scale, range_lo, k, w).contiguous())
        out = csr_lookup_packed_kernel(
            _as_i32(k), _as_i32(lo), _as_i32(hi), _as_i32(doc_targets),
            packed, fences, values, scale, tile=t)
        return _mask_dead_rows(out, alive, doc_targets)
    if not use_kernel:
        return csr_lookup_ref(term_offsets, doc_ids, values, term_to_shard,
                              range_lo, query_terms, doc_targets,
                              split_term, split_doc, alive=alive)
    k, lo, hi, _ = _route_cells(query_terms, doc_targets, term_offsets,
                                term_to_shard, range_lo, split_term,
                                split_doc)
    # stored fences are spaced at the build-time POSTING_TILE: rebuild
    # them whenever the requested tile disagrees
    if (fences is None or t != POSTING_TILE
            or fences.shape[1] != fence_count(doc_ids.shape[1], t)):
        fences = build_fences(doc_ids, t)
    out = csr_lookup_kernel(_as_i32(k), _as_i32(lo), _as_i32(hi),
                            _as_i32(doc_targets), doc_ids, fences,
                            values.to(torch.float32), tile=t)
    return _mask_dead_rows(out, alive, doc_targets)


def csr_lookup_held(term_offsets: torch.Tensor, doc_ids: torch.Tensor,
                    values: torch.Tensor, term_to_shard, range_lo,
                    query_terms: torch.Tensor, doc_targets: torch.Tensor, *,
                    held=None, rows=None,
                    fences: Optional[torch.Tensor] = None,
                    split_term: Optional[torch.Tensor] = None,
                    split_doc: Optional[torch.Tensor] = None,
                    tile: Optional[int] = None) -> torch.Tensor:
    """One rank's part of :func:`csr_lookup` under a mesh, through the
    lookup kernel (its plain version on the CPU): M (B, Q, n_b, n_f)
    with the rows of the postings this rank holds and exact zeros for
    every other cell, so the ranks' parts sum to the whole M.

    ``held = (s0, s1)``: a PartitionedIndex's shards ``[s0, s1)``, whose
    local stack ``term_offsets`` / ``doc_ids`` / ``values`` / ``fences``
    are; a cell routed to another shard gets an empty posting window.
    ``rows = (r0, r1)``: a single CSR (K == 1) whose skeleton is whole
    and whose ``values`` hold the posting rows ``[r0, r1)``; each cell's
    window is cut to those rows, searched in the rows' own ``fences``."""
    t = int(tile or POSTING_TILE)
    k, lo, hi, _ = _route_cells(query_terms, doc_targets, term_offsets,
                                term_to_shard, range_lo, split_term,
                                split_doc, held)
    if rows is not None:
        r0, r1 = rows
        lo, hi = lo.clamp(r0, r1) - r0, hi.clamp(r0, r1) - r0
        doc_ids = doc_ids[:, r0:r1]
    if (fences is None or t != POSTING_TILE
            or fences.shape[1] != fence_count(doc_ids.shape[1], t)):
        fences = build_fences(doc_ids, t)
    return csr_lookup_kernel(_as_i32(k), _as_i32(lo), _as_i32(hi),
                             _as_i32(doc_targets), doc_ids.contiguous(),
                             fences, values.to(torch.float32), tile=t)


def csr_lookup_pairs(term_offsets: torch.Tensor,
                     doc_ids: Optional[torch.Tensor], values: torch.Tensor,
                     term_to_shard, range_lo, terms: torch.Tensor,
                     docs: torch.Tensor, *,
                     fences: Optional[torch.Tensor] = None,
                     split_term: Optional[torch.Tensor] = None,
                     split_doc: Optional[torch.Tensor] = None,
                     tile: Optional[int] = None, codec: str = "none",
                     packed=None, value_scale: Optional[torch.Tensor] = None,
                     codec_spans: tuple = (0, 0)) -> torch.Tensor:
    """Distinct pairs ``terms (P,)`` x ``docs (P,)`` -> value rows (P,
    n_b, n_f), over the layout of :func:`csr_lookup` (the coalescer's
    lookup).  On CUDA every pair is routed on its own and the lookup
    kernel runs with that per-pair routing as a (1, P) grid, so a pair's
    row is bitwise the one ``csr_lookup`` gives its (term, doc) cell; on
    the CPU the routed ref ``lookup_pairs_ref`` (packed:
    ``lookup_pairs_packed_ref``)."""
    codec = validate_codec(codec)
    t = int(tile or POSTING_TILE)
    if not _use_kernel(None, values):
        if codec != "none":
            return lookup_pairs_packed_ref(
                term_offsets, packed, fences, values, value_scale,
                term_to_shard, range_lo, terms[:, None], docs, split_term,
                split_doc, tile=t, spans=tuple(codec_spans))[:, 0]
        return lookup_pairs_ref(term_offsets, doc_ids, values,
                                term_to_shard, range_lo, terms[:, None],
                                docs, split_term, split_doc)[:, 0]
    k, lo, hi = _route(terms[None], docs[None], term_offsets, term_to_shard,
                       range_lo, split_term, split_doc)       # (1, P)
    if codec != "none":
        _check_packed_args(codec, packed, fences, values, tile, t)
        scale = (None if value_scale is None else
                 _lane_scale(value_scale, range_lo, k, terms[None])
                 .contiguous())
        out = csr_lookup_packed_kernel(
            _as_i32(k), _as_i32(lo), _as_i32(hi), _as_i32(docs), packed,
            fences, values, scale, tile=t)
        return out[:, 0]
    if (fences is None or t != POSTING_TILE
            or fences.shape[1] != fence_count(doc_ids.shape[1], t)):
        fences = build_fences(doc_ids, t)
    out = csr_lookup_kernel(_as_i32(k), _as_i32(lo), _as_i32(hi),
                            _as_i32(docs), doc_ids, fences,
                            values.to(torch.float32), tile=t)
    return out[:, 0]


def _block_scanner(term_offsets, doc_ids, values, term_to_shard, range_lo,
                   range_hi, query_terms, block, tile, impl, alive, codec,
                   packed, value_scale, codec_spans, fences, origin,
                   n_blocks):
    """``blo -> M (block, Q, n_b, n_f)`` for the ``n_blocks`` doc blocks
    from doc ``origin``, with the lanes (and, under q8, their scales)
    computed once for every block of the scan; on the kernel path also
    the lane-bounds table, one launch that every block launch reads."""
    codec = validate_codec(codec)
    t = int(tile or POSTING_TILE)
    use_kernel = _use_kernel(impl, values)
    lo_f, hi_f = retrieve_lanes(query_terms, term_offsets, term_to_shard,
                                range_lo, range_hi, values.shape[1])
    arange = torch.arange(block, dtype=torch.int32, device=values.device)
    if codec != "none":
        _check_packed_args(codec, packed, fences, values, tile, t)
        scale = (None if value_scale is None
                 else lane_scales(value_scale, range_lo, query_terms))
        if not use_kernel:
            return lambda blo: scan_block_packed_ref(
                packed, fences, values, scale, lo_f, hi_f, blo, block,
                tile=t, spans=tuple(codec_spans), alive=alive)
        lo_f, hi_f = _as_i32(lo_f), _as_i32(hi_f)
        scale = None if scale is None else scale.contiguous()
        bounds = lane_bounds_packed_kernel(packed, fences, values, lo_f,
                                           hi_f, origin, block, n_blocks,
                                           tile=t)

        def packed_block(blo):
            m = retrieve_windows_packed_kernel(packed, fences, values, scale,
                                               lo_f, hi_f, blo, block,
                                               tile=t, bounds=bounds)
            return _mask_dead_rows(m, alive, blo + arange)
        return packed_block
    if not use_kernel:
        return lambda blo: scan_block_ref(doc_ids, values, lo_f, hi_f, blo,
                                          block, alive=alive)
    lo_f, hi_f = lo_f.contiguous(), hi_f.contiguous()
    vals = values.to(torch.float32)
    bounds = lane_bounds_kernel(doc_ids, lo_f, hi_f, origin, block,
                                n_blocks)

    def block_m(blo):
        m = retrieve_windows_kernel(doc_ids, vals, lo_f, hi_f, blo, block,
                                    bounds=bounds)
        return _mask_dead_rows(m, alive, blo + arange)
    return block_m


def csr_retrieve_block(term_offsets: torch.Tensor,
                       doc_ids: Optional[torch.Tensor],
                       values: torch.Tensor, term_to_shard, range_lo,
                       range_hi, query_terms: torch.Tensor, blo: int, *,
                       block: int, tile: Optional[int] = None,
                       impl: Optional[str] = None, codec: str = "none",
                       packed=None,
                       value_scale: Optional[torch.Tensor] = None,
                       codec_spans: tuple = (0, 0),
                       fences: Optional[torch.Tensor] = None,
                       alive: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """M rows for docs ``[blo, blo + block)`` x query_terms (Q,) over a
    K-stacked shard CSR -> (block, Q, n_b, n_f), built by walking the
    query's posting lists.  Exact vs the per-pair lookup: exclusive
    shard ownership writes each cell at most once, zeros elsewhere.
    Packed codecs as in :func:`csr_lookup`."""
    return _block_scanner(term_offsets, doc_ids, values, term_to_shard,
                          range_lo, range_hi, query_terms, int(block), tile,
                          impl, alive, codec, packed, value_scale,
                          codec_spans, fences, int(blo), 1)(int(blo))


def csr_retrieve_topk(term_offsets: torch.Tensor,
                      doc_ids: Optional[torch.Tensor],
                      values: torch.Tensor, term_to_shard, range_lo,
                      range_hi, query_terms: torch.Tensor, *, n_docs: int,
                      k: int, score_block_fn,
                      doc_block: Optional[int] = None,
                      tile: Optional[int] = None, impl: Optional[str] = None,
                      codec: str = "none", packed=None,
                      value_scale: Optional[torch.Tensor] = None,
                      codec_spans: tuple = (0, 0),
                      fences: Optional[torch.Tensor] = None,
                      alive: Optional[torch.Tensor] = None,
                      extra_m_fn=None):
    """First-stage top-k: scan the corpus in doc blocks, score each with
    ``score_block_fn(M_block, doc_ids_block) -> (block,)`` and keep a
    running top-k on the device.

    The merge sorts ``cat([running, block_scores])`` descending with a
    STABLE sort — the running entries come first and blocks arrive in
    ascending doc order, so ties break toward the lower doc id, as
    ``lax.top_k`` does in the reference (``torch.topk`` promises no order
    among equal values).  Returns ``(scores (k,), doc_ids (k,))``; when k
    exceeds the corpus the tail carries ``-inf`` and doc id ``-1``.
    ``doc_block`` defaults to the whole corpus up to 1024 docs.  Deleted
    docs (``alive`` False) score ``-inf`` and never enter the top-k.

    ``extra_m_fn(blo) -> (block, Q, n_b, n_f)``, when given, is added onto
    each block's M before scoring.  The live index composes its delta
    this way: a (term, doc) pair lives in the base or in the delta, never
    both, so the sum is an exclusive write per cell (x + 0 = x exactly)
    and the ranking equals a rebuild's.  ``n_docs`` may exceed the
    postings' own doc count (the live total): the base's lanes find
    empty windows past its docs.
    """
    n_docs, k = int(n_docs), int(k)
    block = int(doc_block or min(max(n_docs, 1), 1024))
    n_blocks = -(-max(n_docs, 1) // block)
    block_m = _block_scanner(term_offsets, doc_ids, values, term_to_shard,
                             range_lo, range_hi, query_terms, block, tile,
                             impl, alive, codec, packed, value_scale,
                             codec_spans, fences, 0, n_blocks)
    dev = values.device
    run_v = torch.full((k,), -torch.inf, dtype=torch.float32, device=dev)
    run_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    arange = torch.arange(block, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        blo = b * block
        docs = blo + arange
        m = block_m(blo)
        if extra_m_fn is not None:
            m = m + extra_m_fn(blo)
        s = score_block_fn(m, docs).to(torch.float32)
        s = torch.where(docs < n_docs, s, -torch.inf)
        if alive is not None:
            s = torch.where(_alive_at(alive, docs), s, -torch.inf)
        v = torch.cat([run_v, s])
        top = torch.sort(v, descending=True, stable=True).indices[:k]
        run_v, run_i = v[top], torch.cat([run_i, docs])[top]
    return run_v, run_i


__all__ = ["csr_lookup", "csr_lookup_packed_ref", "csr_lookup_ref",
           "csr_retrieve_block", "csr_retrieve_topk"]


# ---------------------------------------------------------------------------
# posting-tile cache fetch and fill (serving.tile_cache.PostingTileCache);
# plain torch, as the reference's are jnp
# ---------------------------------------------------------------------------

def gather_tiles(doc_ids: torch.Tensor, values: torch.Tensor,
                 rows: torch.Tensor, starts: torch.Tensor, *, tile: int):
    """Fetch raw posting tiles: ``rows`` (M,) shard indices x ``starts``
    (M,) tile-aligned shard-local positions -> ``((M, tile) doc ids, (M,
    tile, n_b, n_f) values)``.  Positions past the row tail clip to the
    row's last (pad) element, so a fetched tile stays sorted."""
    n = doc_ids.shape[1]
    pos = (starts.long()[:, None] + torch.arange(
        tile, device=starts.device)[None, :]).clamp(0, n - 1)
    r = rows.long()[:, None]
    return doc_ids[r, pos], values[r, pos]


def gather_tiles_packed(packed, values: torch.Tensor, rows: torch.Tensor,
                        starts: torch.Tensor, *, tile: int):
    """Packed-codec :func:`gather_tiles`: the tile's doc ids decode
    through ``core.codec.unpack_at`` (positions past a short tail decode
    the pack-time pad, keeping the tile sorted), values gather at their
    storage dtype (f32, or int8 under packed-q8)."""
    from ...core.codec import unpack_at
    n = values.shape[1]
    pos = starts.long()[:, None] + torch.arange(
        tile, device=starts.device)[None, :]
    ids = unpack_at(*packed, rows[:, None], pos, tile=tile)
    r = rows.long()[:, None]
    return ids.to(torch.int32), values[r, pos.clamp(0, n - 1)]


def fill_tile_cache(cache_ids: torch.Tensor, cache_vals: torch.Tensor,
                    new_ids: torch.Tensor, new_vals: torch.Tensor,
                    slots: torch.Tensor):
    """Write fetched tiles into cache slots, in place (the reference
    returns updated copies; the port updates the cache's own buffers to
    keep one copy resident).  Slot ``C`` (the capacity) or beyond is
    dropped, as the reference's ``mode="drop"``."""
    keep = slots < cache_ids.shape[0]
    s = slots[keep].long()
    cache_ids[s] = new_ids[keep].to(cache_ids.dtype)
    cache_vals[s] = new_vals[keep].to(cache_vals.dtype)
    return cache_ids, cache_vals
