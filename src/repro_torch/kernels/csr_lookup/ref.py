"""Routed CSR lookup–merge in plain PyTorch — the CPU lowering of the ops.

Port of ``repro.kernels.csr_lookup.ref``: one vectorised pass over the
stacked shard CSR ``(K, ...)`` with no K-axis loop, over raw doc ids or
over tile-packed ones (``core.codec``; the ``packed_*`` functions below).

  route    k  = term_to_shard[w]            each query term to its owner
  gather   lo = term_offsets[k, w - range_lo[k]], hi likewise
  bisect   pos over doc_ids[k, lo:hi)        the branchless bisect of
                                             ``core.index._bisect``
  select   values[k, pos] where found        +0.0 for absent / OOV pairs

The shard axis folds into the position space (``doc_ids (K, N)`` viewed
as ``(K*N,)`` with per-term base ``k*N``), so the result is bitwise equal
to ``csr_lookup_positions`` on the single CSR.  Envelope: ``K * Nmax <
2^31`` (int32 positions), the same as the reference.

Doc-range sub-sharding (a hot term split across shards by doc range)
makes the owner a function of the pair: ``owner = first_owner + #{k :
split_term[k] == w and split_doc[k] <= d}`` (:func:`route_pairs`).
"""
from __future__ import annotations

import torch

from ...core.codec import decode_word, gather_clip2, unpack_at
from ...core.index import _bisect, gather_clip


def bisect_steps(n: int) -> int:
    """Iterations for the branchless bisect to converge over a span of
    width <= n: ``n.bit_length()`` (extra steps are no-ops)."""
    return max(int(n).bit_length(), 1)


def _alive_at(alive: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Tombstone gather, ``alive (n_docs,) bool`` -> mask shaped like
    ``d``; out-of-range ids clamp to the edge (callers AND the result
    with a found mask that is already False there)."""
    return gather_clip(alive, d)


def _window(term_ids, term_offsets, k, row, held):
    """``(k, lo, hi)`` of the routed cells: the posting window of term row
    ``row`` in shard ``k``, empty (``lo == hi``, never found) for
    negative terms.  ``held = (s0, s1)``: ``term_offsets`` holds only the
    global shards ``[s0, s1)`` (a rank's shards under a mesh), ``k``
    comes back local to them, and the cells of any other shard get an
    empty window."""
    live = term_ids >= 0
    if held is not None:
        s0, s1 = held
        live = live & (k >= s0) & (k < s1)
        k = (k - s0).clamp(0, s1 - s0 - 1)
    vmax = term_offsets.shape[1] - 1
    lo = term_offsets[k.long(), row.long()]
    hi = term_offsets[k.long(), (row + 1).clamp(0, vmax).long()]
    return k, lo, torch.where(live, hi, lo)


def route_terms(term_ids: torch.Tensor, term_offsets: torch.Tensor,
                term_to_shard, range_lo, held=None):
    """Route global term ids to ``(k, lo, hi)`` shaped like ``term_ids``;
    ``lo == hi`` (never found) for negative and past-vocab terms.
    ``term_to_shard=None`` is the single-CSR case (K == 1); ``held`` as
    in :func:`_window`."""
    vmax = term_offsets.shape[1] - 1
    w = term_ids.clamp(min=0)
    if term_to_shard is None:
        k = torch.zeros_like(w)
        row = w
    else:
        k = gather_clip(term_to_shard, w).to(torch.int32)
        row = w - gather_clip(range_lo, k)
    return _window(term_ids, term_offsets, k, row.clamp(0, vmax), held)


def route_pairs(term_ids: torch.Tensor, doc_targets: torch.Tensor,
                term_offsets: torch.Tensor, term_to_shard, range_lo,
                split_term: torch.Tensor, split_doc: torch.Tensor,
                held=None):
    """Per-pair routing for doc-range sub-sharded indexes; ``term_ids``
    and ``doc_targets`` share one shape, so does ``(k, lo, hi)``."""
    vmax = term_offsets.shape[1] - 1
    w = term_ids.clamp(min=0)
    k0 = gather_clip(term_to_shard, w).to(torch.int32)
    hop = ((split_term == w[..., None])
           & (split_doc <= doc_targets[..., None])).sum(-1)
    k = k0 + hop.to(torch.int32)
    row = (w - gather_clip(range_lo, k)).clamp(0, vmax)
    return _window(term_ids, term_offsets, k, row, held)


def _route(term_ids, doc_targets, term_offsets, term_to_shard, range_lo,
           split_term, split_doc, held=None):
    """Per-term routing broadcast over the pairs when no sub-shards
    exist, per-pair routing when they do.  Outputs are pair-shaped."""
    shape = torch.broadcast_shapes(term_ids.shape, doc_targets.shape)
    if split_term is None:
        k, lo, hi = route_terms(term_ids, term_offsets, term_to_shard,
                                range_lo, held)
        return k.expand(shape), lo.expand(shape), hi.expand(shape)
    return route_pairs(term_ids.expand(shape), doc_targets.expand(shape),
                       term_offsets, term_to_shard, range_lo, split_term,
                       split_doc, held)


def _flat_rows(values: torch.Tensor) -> torch.Tensor:
    """``(K, N, n_b, n_f)`` -> ``(K*N, n_b, n_f)`` view."""
    return values.reshape((-1,) + tuple(values.shape[2:]))


def lookup_pairs_ref(term_offsets, doc_ids, values, term_to_shard,
                     range_lo, term_ids, doc_targets, split_term=None,
                     split_doc=None, alive=None, held=None) -> torch.Tensor:
    """Generic-batch routed lookup: term_ids (..., Q) x doc_targets
    broadcastable (...,) -> (..., Q, n_b, n_f), zeros for absent pairs
    and for docs that ``alive`` marks dead (``held`` as in
    :func:`_window`: zeros for pairs of shards held elsewhere)."""
    K, N = doc_ids.shape
    d = doc_targets[..., None].expand(term_ids.shape)
    k, lo, hi = _route(term_ids, d, term_offsets, term_to_shard, range_lo,
                       split_term, split_doc, held)
    base = k * N
    flat = doc_ids.reshape(K * N)
    pos = _bisect(flat, base + lo, base + hi, d, n_iter=bisect_steps(N))
    in_list = (pos < base + hi) & (gather_clip(flat, pos) == d)
    if alive is not None:
        in_list = in_list & _alive_at(alive, d)
    vals = gather_clip(_flat_rows(values), pos)
    return torch.where(in_list[..., None, None], vals, 0.0)


def csr_lookup_ref(term_offsets, doc_ids, values, term_to_shard, range_lo,
                   query_terms, doc_targets, split_term=None,
                   split_doc=None, alive=None) -> torch.Tensor:
    """The serving cartesian: query_terms (Q,) x doc_targets (B,) ->
    M_{q,d} (B, Q, n_b, n_f)."""
    K, N = doc_ids.shape
    shape = (doc_targets.shape[0], query_terms.shape[0])     # (B, Q)
    d = doc_targets[:, None].expand(shape)
    k, lo, hi = _route(query_terms[None], d, term_offsets, term_to_shard,
                       range_lo, split_term, split_doc)
    lo_f = k * N + lo
    hi_f = k * N + hi
    flat = doc_ids.reshape(K * N)
    pos = _bisect(flat, lo_f, hi_f, d, n_iter=bisect_steps(N))
    in_list = (pos < hi_f) & (gather_clip(flat, pos) == d)
    if alive is not None:
        in_list = in_list & _alive_at(alive, d)
    vals = gather_clip(_flat_rows(values), pos)
    return torch.where(in_list[..., None, None], vals, 0.0)


def retrieve_lanes(query_terms: torch.Tensor, term_offsets: torch.Tensor,
                   term_to_shard, range_lo, range_hi, n_max: int):
    """Per-(query-slot, shard) posting ranges in the FLAT position space:
    ``(lo, hi)``, each (Q, K) int32 positions into ``doc_ids.reshape(K *
    n_max)``; ``lo == hi`` where a lane owns nothing.  Ownership is
    term-range based when ``range_hi`` is known (every sub-shard of a
    split hot term owns its doc slice), table equality otherwise, and
    unconditional for the single CSR."""
    k_count, vmax1 = term_offsets.shape
    vmax = vmax1 - 1
    dev = query_terms.device
    w = query_terms.clamp(min=0)[:, None]                     # (Q, 1)
    ks = torch.arange(k_count, dtype=torch.int32, device=dev)[None, :]
    valid = (query_terms >= 0)[:, None]
    if term_to_shard is None:
        owned = valid.expand(query_terms.shape[0], k_count)
        lo_k = torch.zeros((1, k_count), dtype=torch.int32, device=dev)
    else:
        lo_k = range_lo[None, :]
        if range_hi is None:
            owned = (gather_clip(term_to_shard,
                                 query_terms.clamp(min=0))[:, None] == ks
                     ) & valid
        else:
            owned = (w >= lo_k) & (w <= range_hi[None, :]) & valid
    row = (w - lo_k).clamp(0, vmax)
    lo = term_offsets[ks.long(), row.long()]
    hi = term_offsets[ks.long(), (row + 1).clamp(0, vmax).long()]
    hi = torch.where(owned, hi, lo)
    lo = torch.where(owned, lo, hi)
    base = ks * n_max
    return base + lo, base + hi


def merge_windows(doc_win: torch.Tensor, val_win: torch.Tensor,
                  n_valid: torch.Tensor, blo: int, block: int,
                  alive=None) -> torch.Tensor:
    """Scatter gathered posting windows into one dense doc block of M.

    ``doc_win`` (Q, K, W) / ``val_win`` (Q, K, W, n_b, n_f), of which the
    first ``n_valid`` (Q, K) entries per lane are real postings with doc
    ids in ``[blo, blo + block)``.  Lanes of a query slot are disjoint in
    doc space, so the segment sum writes each (doc, term) cell at most
    once (``0.0 + v``, as ``jax.ops.segment_sum`` does) and leaves zeros
    elsewhere; everything else lands in an overflow bin that is dropped.
    Returns M (block, Q, n_b, n_f).
    """
    q_n, k_n, w_n = doc_win.shape
    idx = torch.arange(w_n, device=doc_win.device)[None, None, :]
    in_win = idx < n_valid[..., None]
    if alive is not None:
        in_win = in_win & _alive_at(alive, doc_win)
    seg = torch.where(in_win, doc_win - blo, block)           # overflow bin
    q_of = torch.arange(q_n, device=doc_win.device)[:, None, None]
    cell = (seg.long() * q_n + q_of).reshape(-1)
    row = val_win.shape[3:]
    out = torch.zeros(((block + 1) * q_n,) + tuple(row),
                      dtype=val_win.dtype, device=val_win.device)
    out.index_add_(0, cell, val_win.reshape((-1,) + tuple(row)))
    return out.view((block + 1, q_n) + tuple(row))[:block]


def scan_block_ref(doc_ids: torch.Tensor, values: torch.Tensor,
                   lane_lo: torch.Tensor, lane_hi: torch.Tensor, blo: int,
                   block: int, alive=None) -> torch.Tensor:
    """M rows of docs ``[blo, blo + block)`` from the lanes' flat posting
    ranges ``lane_lo``/``lane_hi`` (Q, K): two range bisects per lane
    locate the postings inside the block (a term stores at most one
    posting per doc, so they are one contiguous slice of length <=
    ``block``), one window gather, then :func:`merge_windows`."""
    k_n, n = doc_ids.shape
    flat = doc_ids.reshape(k_n * n)
    steps = bisect_steps(n)
    s_lo = _bisect(flat, lane_lo, lane_hi,
                   torch.full_like(lane_lo, blo), n_iter=steps)
    s_hi = _bisect(flat, lane_lo, lane_hi,
                   torch.full_like(lane_lo, blo + block), n_iter=steps)
    p = s_lo[..., None] + torch.arange(block, dtype=s_lo.dtype,
                                       device=s_lo.device)
    doc_win = gather_clip(flat, p)
    val_win = gather_clip(_flat_rows(values), p)
    return merge_windows(doc_win, val_win, s_hi - s_lo, blo, block,
                         alive=alive)


def scan_edges(origin: int, n_docs: int, device=None) -> torch.Tensor:
    """The edges of a lane-bounds table over docs ``[origin, origin +
    n_docs)``: every doc and the end, ``origin + i`` for ``i`` in ``[0,
    n_docs]``, int64."""
    return origin + torch.arange(n_docs + 1, dtype=torch.int64,
                                 device=device)


def lane_bounds_ref(doc_ids: torch.Tensor, lane_lo: torch.Tensor,
                    lane_hi: torch.Tensor, edges: torch.Tensor
                    ) -> torch.Tensor:
    """The scan's lane-bounds table: for every lane (Q, K) and edge (E,)
    the first flat position in ``[lane_lo, lane_hi)`` whose doc id is >=
    the edge, by the bisect :func:`scan_block_ref` runs per block ->
    (Q, K, E) int32."""
    flat = doc_ids.reshape(-1)
    pos = _bisect(flat, lane_lo.long()[..., None], lane_hi.long()[..., None],
                  edges, n_iter=bisect_steps(doc_ids.shape[1]))
    return pos.expand(lane_lo.shape + edges.shape).to(torch.int32)


def lane_bounds_packed_ref(packed, fences, n_max: int, lane_lo, lane_hi,
                           edges, *, tile: int) -> torch.Tensor:
    """Packed-codec :func:`lane_bounds_ref`: the two-level
    :func:`packed_bisect` of each lane (shard-local) at every edge,
    returned as flat positions (Q, K, E) int32."""
    k_n = fences.shape[0]
    base = torch.arange(k_n, dtype=torch.int64,
                        device=lane_lo.device) * n_max          # (K,)
    lo = (lane_lo.long() - base)[..., None]
    hi = (lane_hi.long() - base)[..., None]
    pos = packed_bisect(packed, fences, torch.arange(
        k_n, device=lane_lo.device)[:, None], lo, hi, edges, tile=tile)
    return (base[:, None] + pos).to(torch.int32)


def block_cells_ref(table: torch.Tensor, e0: int, block: int):
    """The postings of a block as the scan kernels read them from a
    lane-bounds table whose edges are every doc: doc ``d`` of the block
    has a posting in lane ``l`` iff ``table[l, e0 + d] < table[l, e0 + d
    + 1]`` (a term posts once per doc), at that first position.  Returns
    ``(cell, pos, lane)``, each (P,) int64: the cell ``d * Q + q`` of M
    viewed as (block * Q, n_b, n_f), the flat posting and its lane ``q *
    K + k``."""
    q_n, k_n, _ = table.shape
    a = table[..., e0:e0 + block].long()                     # (Q, K, D)
    live = table[..., e0 + 1:e0 + block + 1].long() > a
    d = torch.arange(block, device=a.device)
    q = torch.arange(q_n, device=a.device)[:, None, None]
    lane = torch.arange(q_n * k_n, device=a.device).view(q_n, k_n, 1)
    return ((d * q_n + q).expand(a.shape)[live], a[live],
            lane.expand(a.shape)[live])


def assemble_block_ref(values: torch.Tensor, lane_scale, table: torch.Tensor,
                       e0: int, block: int) -> torch.Tensor:
    """M (block, Q, n_b, n_f) of the block whose first edge is column
    ``e0`` of a lane-bounds table, as the scan kernels build it
    (:func:`block_cells_ref`): each found cell gets ``0.0 + v`` (``v``
    the posting's row, dequantised by its lane's ``lane_scale`` (Q, K)
    for int8 values), every other cell +0.0."""
    q_n = table.shape[0]
    cell, pos, lane = block_cells_ref(table, e0, block)
    rows = _flat_rows(values)[pos]
    if lane_scale is not None:
        rows = (rows.to(torch.float32)
                * lane_scale.reshape(-1)[lane][:, None, None])
    row = values.shape[2:]
    out = torch.zeros((block * q_n,) + tuple(row), dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, cell, rows)
    return out.view((block, q_n) + tuple(row))


def retrieve_block_ref(term_offsets, doc_ids, values, term_to_shard,
                       range_lo, range_hi, query_terms, blo: int,
                       block: int, alive=None) -> torch.Tensor:
    """One doc block of the first-stage posting scan: M (block, Q, n_b,
    n_f) built by walking the query's posting ranges instead of
    bisecting per (term, doc) pair."""
    lo_f, hi_f = retrieve_lanes(query_terms, term_offsets, term_to_shard,
                                range_lo, range_hi, doc_ids.shape[1])
    return scan_block_ref(doc_ids, values, lo_f, hi_f, blo, block,
                          alive=alive)


# ---------------------------------------------------------------------------
# packed-codec lowerings (core.codec tile-compressed postings)
# ---------------------------------------------------------------------------

def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def packed_bisect(packed, fences, k, lo, hi, target, *, tile: int,
                  spans=(0, 0), with_value: bool = False):
    """First shard-local position p in [lo, hi) with decode(k, p) >=
    target, in two levels, as the kernels run it: a bisect over the RAW
    fence row (the codec keeps fences uncompressed as tile anchors), one
    gather of the winning tile's (bits, base, word offset), then a bisect
    inside that tile whose probes each decode one packed word.  Every
    tile left of the winning fence is wholly < target, so positions equal
    ``core.index._bisect`` over the unpacked row.

    ``packed`` is ``(packed_words (K, W), tile_bits (K, F), tile_base (K,
    F), tile_word_off (K, F+1))``; k/lo/hi/target broadcastable, in
    shard-LOCAL positions.  ``spans = (max_span, max_len)`` bounds the
    iterations (no routed range spans more tiles or postings; ``(0, 0)``
    means the worst case; extra iterations are no-ops).

    ``with_value=True`` also returns the decoded id at ``pos``: one word
    probe inside the tile, or, on the tile's right boundary, the next raw
    fence, which is that element verbatim.  Past ``hi`` it may be
    garbage; callers mask on ``pos < hi``.  Positions are int64.
    """
    words, bits, base_t, woff = packed
    k_n, f = fences.shape
    k, lo, hi, target = torch.broadcast_tensors(
        torch.as_tensor(k).long(), lo.long(), hi.long(),
        torch.as_tensor(target, device=lo.device).long())
    fflat = fences.reshape(-1)
    k = k.clamp(0, k_n - 1)
    kf = k * f
    j_lo = _floordiv(lo, tile)
    j_hi = torch.maximum(_floordiv(hi - 1, tile), j_lo)
    max_span, max_len = spans
    f_steps = bisect_steps(min(max_span - 1, f) if max_span else f)
    t_steps = bisect_steps(min(max_len, tile) if max_len else tile)
    flo, fhi = j_lo + 1, j_hi + 1
    for _ in range(f_steps):
        mid = _floordiv(flo + fhi, 2)
        v = gather_clip(fflat, kf + mid.clamp(0, f - 1))
        go = (v < target) & (flo < fhi)
        flo, fhi = torch.where(go, mid + 1, flo), torch.where(go, fhi, mid)
    jt = (flo - 1).clamp(0, f - 1)
    base = jt * tile
    c = bits.reshape(-1)[kf + jt]
    tb = base_t.reshape(-1)[kf + jt]
    # flat offset of the tile's first word; a probe at r == tile reads the
    # row's trailing max_tile_words pad and is never consulted
    kwo = k * words.shape[1] + woff.reshape(-1)[k * (f + 1) + jt]
    wflat = words.reshape(-1)

    def decode(r):
        bp = r * c
        return decode_word(gather_clip(wflat, kwo + _floordiv(bp, 32)), bp,
                           c, tb)

    plo = torch.maximum(base, lo)
    phi = torch.minimum(base + tile, hi)
    for _ in range(t_steps):
        mid = _floordiv(plo + phi, 2)
        go = (decode(mid - base) < target) & (plo < phi)
        plo, phi = torch.where(go, mid + 1, plo), torch.where(go, phi, mid)
    pos = plo
    if not with_value:
        return pos
    v_next = gather_clip(fflat, kf + (jt + 1).clamp(0, f - 1))
    in_tile = pos - base < tile
    v_at = torch.where(in_tile, decode(torch.where(in_tile, pos - base, 0)),
                       v_next)
    return pos, v_at


def _lane_scale(value_scale, range_lo, k, term_ids):
    """Per-pair (or per-lane) dequant scale: the owning shard's row for
    the term.  Only applied where a pair is found or a lane owns
    postings, so clipped rows elsewhere never matter."""
    vmax = value_scale.shape[1]
    w = term_ids.clamp(min=0)
    if range_lo is None:
        row = w.clamp(0, vmax - 1)
    else:
        row = (w - gather_clip(range_lo, k)).clamp(0, vmax - 1)
    return gather_clip2(value_scale, k, row)


def lane_scales(value_scale, range_lo, query_terms):
    """The first-stage scan's per-(query slot, shard) scales, (Q, K)."""
    ks = torch.arange(value_scale.shape[0], dtype=torch.int32,
                      device=query_terms.device)[None, :]
    return _lane_scale(value_scale, range_lo, ks, query_terms[:, None])


def packed_rows(packed, fences, values, k, lo, hi, d, scale, *, tile: int,
                spans=(0, 0), alive=None) -> torch.Tensor:
    """M rows of routed pairs ``(k, lo, hi)`` x doc ``d`` (one shape)
    over packed ids: the two-level packed bisect, the found check against
    the decoded id, the values gather and, for int8 ``values``, the
    dequant by ``scale`` (one f32 multiply); +0.0 by select where a pair
    is absent or its doc is dead."""
    pos, v_at = packed_bisect(packed, fences, k, lo, hi, d, tile=tile,
                              spans=spans, with_value=True)
    found = (pos < hi) & (v_at == d)
    if alive is not None:
        found = found & _alive_at(alive, d)
    vals = gather_clip(_flat_rows(values), k.long() * values.shape[1] + pos)
    if scale is not None:
        vals = vals.to(torch.float32) * scale[..., None, None]
    return torch.where(found[..., None, None], vals, 0.0)


def _lookup_packed(term_offsets, packed, fences, values, value_scale,
                   term_to_shard, range_lo, split_term, split_doc,
                   term_ids, d, *, tile: int, spans=(0, 0), alive=None):
    """Route, then :func:`packed_rows`; ``term_ids``/``d`` already share
    the pair shape."""
    k, lo, hi = _route(term_ids, d, term_offsets, term_to_shard, range_lo,
                       split_term, split_doc)
    scale = (None if value_scale is None
             else _lane_scale(value_scale, range_lo, k, term_ids))
    return packed_rows(packed, fences, values, k, lo, hi, d, scale,
                       tile=tile, spans=spans, alive=alive)


def lookup_pairs_packed_ref(term_offsets, packed, fences, values,
                            value_scale, term_to_shard, range_lo,
                            term_ids, doc_targets, split_term=None,
                            split_doc=None, *, tile: int, spans=(0, 0),
                            alive=None) -> torch.Tensor:
    """Packed-codec :func:`lookup_pairs_ref`: term_ids (..., Q) x
    doc_targets broadcastable (...,) -> (..., Q, n_b, n_f)."""
    d = doc_targets[..., None].expand(term_ids.shape)
    return _lookup_packed(term_offsets, packed, fences, values,
                          value_scale, term_to_shard, range_lo, split_term,
                          split_doc, term_ids, d, tile=tile, spans=spans,
                          alive=alive)


def csr_lookup_packed_ref(term_offsets, packed, fences, values,
                          value_scale, term_to_shard, range_lo,
                          query_terms, doc_targets, split_term=None,
                          split_doc=None, *, tile: int, spans=(0, 0),
                          alive=None) -> torch.Tensor:
    """Packed-codec :func:`csr_lookup_ref`: query_terms (Q,) x
    doc_targets (B,) -> M (B, Q, n_b, n_f)."""
    shape = (doc_targets.shape[0], query_terms.shape[0])    # (B, Q)
    return _lookup_packed(term_offsets, packed, fences, values,
                          value_scale, term_to_shard, range_lo, split_term,
                          split_doc, query_terms[None].expand(shape),
                          doc_targets[:, None].expand(shape), tile=tile,
                          spans=spans, alive=alive)


def scan_block_packed_ref(packed, fences, values, lane_scale, lane_lo,
                          lane_hi, blo: int, block: int, *, tile: int,
                          spans=(0, 0), alive=None) -> torch.Tensor:
    """Packed-codec :func:`scan_block_ref`: from the lanes' flat posting
    ranges (Q, K), two packed bisects per lane locate the block's
    postings, the id window decodes through ``core.codec.unpack_at``,
    int8 values dequantise by ``lane_scale`` (Q, K), and
    :func:`merge_windows` scatters the live entries into M (block, Q,
    n_b, n_f)."""
    k_n, nmax = values.shape[:2]
    ks = torch.arange(k_n, dtype=torch.int64,
                      device=lane_lo.device)[None, :].expand(lane_lo.shape)
    base = ks * nmax
    lo_l, hi_l = lane_lo.long() - base, lane_hi.long() - base
    s_lo = packed_bisect(packed, fences, ks, lo_l, hi_l, blo, tile=tile,
                         spans=spans)
    s_hi = packed_bisect(packed, fences, ks, lo_l, hi_l, blo + block,
                         tile=tile, spans=spans)
    p = s_lo[..., None] + torch.arange(block, device=s_lo.device)
    doc_win = unpack_at(*packed, ks[..., None], p, tile=tile)
    flat_p = (base[..., None] + p).clamp(0, k_n * nmax - 1)
    val_win = _flat_rows(values)[flat_p]
    if lane_scale is not None:
        val_win = (val_win.to(torch.float32)
                   * lane_scale[..., None, None, None])
    return merge_windows(doc_win, val_win, s_hi - s_lo, blo, block,
                         alive=alive)


def retrieve_block_packed_ref(term_offsets, packed, fences, values,
                              value_scale, term_to_shard, range_lo,
                              range_hi, query_terms, blo: int, block: int,
                              *, tile: int, spans=(0, 0),
                              alive=None) -> torch.Tensor:
    """Packed-codec :func:`retrieve_block_ref`: the same lanes, scanned
    by :func:`scan_block_packed_ref`."""
    lo_f, hi_f = retrieve_lanes(query_terms, term_offsets, term_to_shard,
                                range_lo, range_hi, values.shape[1])
    scale = (None if value_scale is None
             else lane_scales(value_scale, range_lo, query_terms))
    return scan_block_packed_ref(packed, fences, values, scale, lo_f, hi_f,
                                 blo, block, tile=tile, spans=spans,
                                 alive=alive)


# ---------------------------------------------------------------------------
# posting-tile cache (serving.tile_cache.PostingTileCache)
# ---------------------------------------------------------------------------

def cached_tile_lookup(cache_ids, cache_vals, slots, win_lo, win_hi,
                       doc_targets, scale=None) -> torch.Tensor:
    """Resolve (term, doc) pairs against cached posting tiles.

    The tile cache routes each pair on the host to the one cached tile
    that can hold its doc, so here every pair is an in-tile bisect:

    * ``cache_ids`` (C, T) int32 and ``cache_vals`` (C, T, n_b, n_f) —
      the resident tiles' decoded doc ids and value rows (f32, or int8
      under packed-q8);
    * ``slots`` / ``win_lo`` / ``win_hi`` (...,) int32 — the pair's slot
      and its routed range clipped to the tile; a pair with no postings
      passes ``win_lo == win_hi`` and gets the exact-zero row;
    * ``scale`` (...,) f32 — per-pair dequant scale (packed-q8 only).

    The bisect is ``core.index._bisect`` over the flattened cache from
    base ``slot * T``, the probe sequence of the uncompressed ref
    restricted to one tile, so found masks and values are bitwise those
    of the uncoalesced lookup.
    """
    c, t = cache_ids.shape
    flat = cache_ids.reshape(-1)
    base = slots.long() * t
    lo = base + win_lo
    hi = base + win_hi
    d = doc_targets.long()
    pos = _bisect(flat, lo, hi, d, n_iter=bisect_steps(t))
    found = (pos < hi) & (gather_clip(flat, pos) == d)
    vals = gather_clip(cache_vals.reshape((c * t,)
                                          + tuple(cache_vals.shape[2:])), pos)
    if scale is not None:
        vals = vals.to(torch.float32) * scale[..., None, None]
    return torch.where(found[..., None, None], vals, 0.0)
