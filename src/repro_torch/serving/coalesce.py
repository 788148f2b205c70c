"""Cross-query (term, doc) coalescing for the serving front end (port of
``repro.serving.coalesce``).

Zipfian query streams share terms heavily, and re-ranking batches share
candidate documents, so a formed batch of R requests usually holds far
fewer distinct (term, doc) pairs than the R * Q * B pair slots the
per-query path resolves.  :class:`CoalescingScorer` dedupes the pair set
on the host, resolves each distinct pair once on the device (the lookup
kernel, routed per pair, or the tile cache) and gathers the value rows
back into each request's (B, Q, n_b, n_f) interaction matrix: exact by
construction, since every gathered row is the row the uncoalesced lookup
produces.  Repeated terms within one query collapse the same way; the
retrievers consume one row per query-term slot, so replicating the row
per occurrence is bitwise the per-query path.

Scoring stays per request: the scorer runs on each request's own (B, Q)
M, the shapes ``engine.score`` runs, so scores are bitwise equal.

Over a :class:`~repro_torch.dist.live.LiveIndex` a batch pins one view:
its lookup, the delta tail and every request's score read that
snapshot, even if a mutation lands mid-batch.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from .engine import _as_ids, make_qmeta

_DOC_MASK = np.int64(0xFFFFFFFF)


def plan_coalesced(requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                   pair_pad: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray], int]:
    """Host-side coalescing plan over a formed batch.

    ``requests`` is a list of ``(query_terms (Q_r,), doc_ids (B_r,))``
    pairs (shapes may differ across requests).  Returns
    ``(terms (P,), docs (P,), inverses, n_distinct)``: the distinct
    (term, doc) pairs and, per request, the flat ``(B_r * Q_r,)`` int32
    gather index mapping pair slot ``(b, q)`` (row-major) to its row in
    the distinct set.

    The dedupe is TWO-LEVEL, not a flat unique over every pair slot: a
    formed batch holds ``sum(B_r * Q_r)`` slots (hundreds of thousands
    at re-ranking widths) and sorting that many packed keys on the host
    costs more than the device lookup it is trying to save.  Requests
    are outer products ``q ⊗ d``, so the slot space factors: unique the
    terms (tiny) and the docs (``sum B_r``, ~an order of magnitude
    smaller than the slot count) separately, place each slot on a
    compact (term-rank, doc-rank) grid, and mark presence with a
    vectorized scatter — no O(slots log slots) sort ever happens.  The
    distinct set and inverses fall out of one pass over the grid, in
    the same (term, doc)-sorted order the flat unique produced.  When
    the grid would be degenerate (enormous vocab x corpus footprint
    with almost no sharing) the flat packed-key unique is the safety
    net.

    ``pair_pad`` buckets the distinct count up to the next multiple
    (bounding jit compile counts under a live traffic mix); pad rows
    carry ``term = -1`` — an empty routed range on every lookup path —
    and no inverse ever references them.
    """
    if not requests:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), [], 0)
    all_t = np.concatenate([np.asarray(q).ravel() for q, _ in requests]) \
        .astype(np.int64)
    all_d = np.concatenate([np.asarray(d).ravel() for _, d in requests]) \
        .astype(np.int64)
    ut, tinv = np.unique(all_t, return_inverse=True)
    ud, dinv = np.unique(all_d, return_inverse=True)
    n_t, n_d = int(ut.shape[0]), int(ud.shape[0])
    if n_t * n_d > _GRID_CAP:
        return _plan_flat(requests, pair_pad)
    present = np.zeros(n_t * n_d, np.bool_)
    keys, ti, di = [], 0, 0
    for q, d in requests:
        nq = int(np.asarray(q).shape[0])
        nb = int(np.asarray(d).shape[0])
        # (B_r, Q_r) row-major, matching the (B, Q) reshape at score time
        k = (tinv[ti:ti + nq][None, :] * n_d
             + dinv[di:di + nb][:, None]).reshape(-1)
        keys.append(k)
        present[k] = True
        ti += nq
        di += nb
    pos = np.flatnonzero(present)
    n_distinct = int(pos.shape[0])
    # rank table: scatter each present cell's row index, then inverses
    # are one gather per request — no cumsum over the whole grid
    rank = np.empty(n_t * n_d, np.int32)
    rank[pos] = np.arange(n_distinct, dtype=np.int32)
    terms = ut[pos // n_d].astype(np.int32)
    docs = ud[pos % n_d].astype(np.int32)
    terms, docs = _pad_pairs(terms, docs, n_distinct, pair_pad)
    inverses = [rank[k] for k in keys]
    return terms, docs, inverses, n_distinct


# grid cells above which the factored plan falls back to the flat sort
# (a degenerate batch: huge term x doc footprint, near-zero sharing)
_GRID_CAP = 1 << 26


def _pad_pairs(terms, docs, n_distinct, pair_pad):
    if pair_pad > 0 and n_distinct % pair_pad:
        p = -(-n_distinct // pair_pad) * pair_pad
        terms = np.concatenate(
            [terms, np.full(p - n_distinct, -1, np.int32)])
        docs = np.concatenate([docs, np.zeros(p - n_distinct, np.int32)])
    return terms, docs


def _plan_flat(requests, pair_pad):
    """Flat packed-key unique — the original O(slots log slots) plan,
    kept as the fallback for batches whose (terms x docs) grid would
    dwarf the slot count.  Keys pack sign-preservingly into int64
    (``term << 32 | doc & 2^32-1`` — the OR never carries into the term
    bits), so padding terms (-1) and adversarial negative doc ids
    coalesce correctly."""
    keys = []
    for q, docs in requests:
        t = np.asarray(q).astype(np.int64)
        d = np.asarray(docs).astype(np.int64)
        keys.append(((t[None, :] << 32)
                     | (d[:, None] & _DOC_MASK)).reshape(-1))
    uniq, inverse = np.unique(np.concatenate(keys), return_inverse=True)
    n_distinct = int(uniq.shape[0])
    terms = (uniq >> 32).astype(np.int32)
    docs = (uniq & _DOC_MASK).astype(np.uint32).astype(np.int32)
    terms, docs = _pad_pairs(terms, docs, n_distinct, pair_pad)
    inverses, off = [], 0
    inverse = inverse.astype(np.int32)
    for k in keys:
        inverses.append(inverse[off:off + k.shape[0]])
        off += k.shape[0]
    return terms, docs, inverses, n_distinct


class CoalescingScorer:
    """Batch scorer sharing one distinct-pair lookup across requests.

    Wraps a mesh-less :class:`~repro_torch.serving.engine.SeineEngine`:
    the engine's index resolves the distinct pairs
    (``index.lookup_pair_rows``: the lookup kernel on CUDA, raw or packed
    codec alike), then each request's scores come from a gather of its
    rows and the retriever's score, bitwise-equal to ``engine.score`` on
    the same (query, candidates).  An optional
    :class:`~repro_torch.serving.tile_cache.PostingTileCache` takes over
    the distinct-pair resolution, so hot posting tiles are served from
    the device-resident cache instead of re-fetched per batch.
    """

    def __init__(self, engine, *, cache=None, pair_pad: int = 256):
        if getattr(engine, "mesh", None) is not None:
            raise ValueError("CoalescingScorer is mesh-less only (it "
                             "bypasses the SPMD partial-sum lookup)")
        if pair_pad < 0:
            raise ValueError(f"pair_pad must be >= 0, got {pair_pad}")
        self.engine = engine
        self._live = bool(getattr(engine.index, "is_live", False))
        self._batch_view = None
        self.index = engine.index
        self.spec = engine.spec
        self.cache = cache
        self.pair_pad = int(pair_pad)
        self._pairs_counter = obs.counter(
            "seine_coalesce_pair_slots_total",
            "pre-dedupe (term, doc) pair slots submitted")
        self._distinct_counter = obs.counter(
            "seine_coalesce_distinct_pairs_total",
            "distinct (term, doc) pairs looked up")
        self._dedupe_gauge = obs.gauge(
            "seine_coalesce_dedupe_ratio",
            "distinct / submitted pair slots, last batch")

    def _current_view(self):
        """The batch-pinned LiveView, or a fresh snapshot outside a batch
        (live mode only)."""
        v = self._batch_view
        return v if v is not None else self.index.view

    def lookup_distinct(self, terms: np.ndarray, docs: np.ndarray
                        ) -> torch.Tensor:
        """(P,) distinct pairs -> (P, n_b, n_f) value rows (device).

        With a tile cache under a live index, the cache serves the BASE
        generation's rows and the delta / tombstone tail is applied on
        top (exact, and still one cached-tile probe per pair).  If a
        compaction swapped the base under the batch before the front end
        rebound the cache, the cache is bypassed for this call (the plain
        lookup over the view) rather than mixing rows of two
        generations."""
        dev = self.engine.device
        if not self._live:
            if self.cache is not None:
                return self.cache.lookup(terms, docs)
            return self.index.lookup_pair_rows(_as_ids(terms, dev),
                                               _as_ids(docs, dev))
        view = self._current_view()
        t, d = _as_ids(terms, dev), _as_ids(docs, dev)
        if self.cache is None or view.base is not self.cache.index:
            return view.lookup_pair_rows(t, d)
        return view.pair_tail(t, d, self.cache.lookup(terms, docs))

    @torch.inference_mode()
    def score_batch(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]]
                    ) -> List[torch.Tensor]:
        """Score a formed batch; returns per-request (B_r,) device
        tensors (callers synchronise: the front end does, inside its
        span)."""
        terms, docs, inverses, n_distinct = plan_coalesced(
            requests, self.pair_pad)
        if obs.enabled():
            slots = sum(iv.shape[0] for iv in inverses)
            self._pairs_counter.inc(slots)
            self._distinct_counter.inc(n_distinct)
            self._dedupe_gauge.set(n_distinct / max(slots, 1))
        if self._live:
            self._batch_view = self.index.view
        try:
            vals = self.lookup_distinct(terms, docs)
            dev = vals.device
            index = self._batch_view if self._live else self.index
            spec, params = self.spec, self.engine.params
            out = []
            for (q, d), inv in zip(requests, inverses):
                q, d = _as_ids(q, dev), _as_ids(d, dev)
                m = vals[torch.from_numpy(inv).to(dev).long()].reshape(
                    (d.shape[0], q.shape[0]) + tuple(vals.shape[1:]))
                meta = make_qmeta(index, q, d)
                out.append(spec.score(params, m, meta, index.functions))
        finally:
            self._batch_view = None
        return out
