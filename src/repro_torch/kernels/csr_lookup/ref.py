"""Routed CSR lookup–merge in plain PyTorch — the CPU lowering of the ops.

Port of the uncompressed half of ``repro.kernels.csr_lookup.ref``: one
vectorised pass over the stacked shard CSR ``(K, ...)`` with no K-axis
loop.

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


def route_terms(term_ids: torch.Tensor, term_offsets: torch.Tensor,
                term_to_shard, range_lo):
    """Route global term ids to ``(k, lo, hi)`` shaped like ``term_ids``;
    ``lo == hi`` (never found) for negative and past-vocab terms.
    ``term_to_shard=None`` is the single-CSR case (K == 1)."""
    vmax = term_offsets.shape[1] - 1
    w = term_ids.clamp(min=0)
    if term_to_shard is None:
        k = torch.zeros_like(w)
        row = w
    else:
        k = gather_clip(term_to_shard, w).to(torch.int32)
        row = w - gather_clip(range_lo, k)
    row = row.clamp(0, vmax)
    lo = term_offsets[k.long(), row.long()]
    hi = term_offsets[k.long(), (row + 1).clamp(0, vmax).long()]
    hi = torch.where(term_ids >= 0, hi, lo)     # negatives: empty range
    return k, lo, hi


def route_pairs(term_ids: torch.Tensor, doc_targets: torch.Tensor,
                term_offsets: torch.Tensor, term_to_shard, range_lo,
                split_term: torch.Tensor, split_doc: torch.Tensor):
    """Per-pair routing for doc-range sub-sharded indexes; ``term_ids``
    and ``doc_targets`` share one shape, so does ``(k, lo, hi)``."""
    vmax = term_offsets.shape[1] - 1
    w = term_ids.clamp(min=0)
    k0 = gather_clip(term_to_shard, w).to(torch.int32)
    hop = ((split_term == w[..., None])
           & (split_doc <= doc_targets[..., None])).sum(-1)
    k = k0 + hop.to(torch.int32)
    row = (w - gather_clip(range_lo, k)).clamp(0, vmax)
    lo = term_offsets[k.long(), row.long()]
    hi = term_offsets[k.long(), (row + 1).clamp(0, vmax).long()]
    hi = torch.where(term_ids >= 0, hi, lo)     # negatives: empty range
    return k, lo, hi


def _route(term_ids, doc_targets, term_offsets, term_to_shard, range_lo,
           split_term, split_doc):
    """Per-term routing broadcast over the pairs when no sub-shards
    exist, per-pair routing when they do.  Outputs are pair-shaped."""
    shape = torch.broadcast_shapes(term_ids.shape, doc_targets.shape)
    if split_term is None:
        k, lo, hi = route_terms(term_ids, term_offsets, term_to_shard,
                                range_lo)
        return k.expand(shape), lo.expand(shape), hi.expand(shape)
    return route_pairs(term_ids.expand(shape), doc_targets.expand(shape),
                       term_offsets, term_to_shard, range_lo, split_term,
                       split_doc)


def _flat_rows(values: torch.Tensor) -> torch.Tensor:
    """``(K, N, n_b, n_f)`` -> ``(K*N, n_b, n_f)`` view."""
    return values.reshape((-1,) + tuple(values.shape[2:]))


def lookup_pairs_ref(term_offsets, doc_ids, values, term_to_shard,
                     range_lo, term_ids, doc_targets, split_term=None,
                     split_doc=None, alive=None) -> torch.Tensor:
    """Generic-batch routed lookup: term_ids (..., Q) x doc_targets
    broadcastable (...,) -> (..., Q, n_b, n_f), zeros for absent pairs
    and for docs that ``alive`` marks dead."""
    K, N = doc_ids.shape
    d = doc_targets[..., None].expand(term_ids.shape)
    k, lo, hi = _route(term_ids, d, term_offsets, term_to_shard, range_lo,
                       split_term, split_doc)
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
