"""Hot-term posting-tile cache for the serving front end (port of
``repro.serving.tile_cache``).

Zipfian traffic touches a tiny fraction of the posting tiles most of
the time — the same skew ``plan_posting_ranges`` exploits for shard
balance — so a fixed-budget device-resident cache of recently-touched
tiles serves most distinct-pair lookups without re-fetching (or, under
a packed codec, re-decoding) the tile.

Division of labour:

* HOST (here): route each (term, doc) pair to its owning shard and
  posting range: a numpy mirror of ``kernels.csr_lookup.route_terms``
  / ``route_pairs`` over the replicated O(|v|)/O(K) tables — then find
  the one tile that can contain the doc by bisecting the FENCE row
  restricted to the routed range (fences at tiles strictly inside a
  term's range are that term's own sorted doc ids, so the rightmost
  fence <= doc identifies the unique candidate tile; none of the
  posting payload is consulted).  LRU bookkeeping keys on
  ``(shard, tile)``.
* DEVICE: misses fetch via ``kernels.csr_lookup.gather_tiles`` (or
  ``gather_tiles_packed``, which decodes ids through the codec, so
  cache hits also skip the unpack) and land in the cache arrays via
  ``fill_tile_cache``; every pair then resolves through one
  ``cached_tile_lookup`` call, an in-tile bisect over its cached tile,
  bitwise-equal to the uncoalesced lookup.  These are plain torch, as
  the reference's are jnp; pairs past the budget take the lookup
  kernel (``index.lookup_pair_rows``).

Epoch safety: :meth:`swap_index` rebinds to a new index generation,
clears the LRU map and bumps ``epoch`` — a stale tile can never be
served across a swap because every slot is unreachable until re-filled
from the new index.

Metrics (``repro.obs``): ``seine_tile_cache_{hits,misses,evictions}
_total`` counters (distinct tiles per batch),
``seine_tile_cache_overflow_pairs_total`` (pairs that took the
fallback) and a ``seine_tile_cache_size_tiles`` gauge.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..dist.partition import PartitionedIndex


class PostingTileCache:
    """Fixed-budget LRU cache of posting tiles, keyed by (shard, tile).

    ``budget_tiles`` bounds device residency: the cache holds
    ``budget_tiles`` tiles of ``tile`` doc ids + value rows at the
    index's serve dtype, on the index's device.  Works for raw and packed
    :class:`~repro_torch.dist.partition.PartitionedIndex` layouts (packed
    tiles are cached post-decode; packed-q8 values stay int8 and
    dequantise per pair at lookup, mirroring ``_lookup_packed``).
    """

    def __init__(self, index, budget_tiles: int):
        if int(budget_tiles) <= 0:
            raise ValueError(
                f"budget_tiles must be positive, got {budget_tiles}")
        if not isinstance(index, PartitionedIndex):
            raise ValueError(
                "PostingTileCache needs a PartitionedIndex (the tile "
                "cache keys on (shard, tile) of the stacked layout); "
                "serve single-CSR indexes through partition='term'")
        self.capacity = int(budget_tiles)
        self.epoch = 0
        self._hits = obs.counter("seine_tile_cache_hits_total",
                                 "posting tiles served from cache")
        self._misses = obs.counter("seine_tile_cache_misses_total",
                                   "posting tiles fetched on miss")
        self._evictions = obs.counter("seine_tile_cache_evictions_total",
                                      "posting tiles evicted (LRU)")
        self._overflow = obs.counter(
            "seine_tile_cache_overflow_pairs_total",
            "pairs resolved via the uncached fallback (batch working "
            "set over budget)")
        self._size_gauge = obs.gauge("seine_tile_cache_size_tiles",
                                     "resident posting tiles")
        self._bind(index)

    # -- index binding / epoch swap -----------------------------------------

    def _bind(self, index) -> None:
        from ..core.index import POSTING_TILE
        self.index = index
        self.tile = int(index.codec_tile) if index.codec != "none" \
            else POSTING_TILE
        # replicated-table host mirrors (O(|v|) + O(K) + fence rows —
        # never the posting payload)
        host = lambda a: a.cpu().numpy().astype(np.int64)
        self._offs = host(index.term_offsets)
        self._t2s = host(index.term_to_shard)
        self._rlo = host(index.range_lo)
        self._st = None if index.split_term is None else host(
            index.split_term)
        self._sd = None if index.split_doc is None else host(
            index.split_doc)
        self._fences = host(index.fences)
        self._scale = (index.value_scale.cpu().numpy().astype(np.float32)
                       if index.codec == "packed-q8" else None)
        vals = index._serve_values
        t = self.tile
        self._cache_ids = torch.full(
            (self.capacity, t), np.iinfo(np.int32).max, dtype=torch.int32,
            device=index.device)
        self._cache_vals = torch.zeros(
            (self.capacity, t) + tuple(vals.shape[2:]), dtype=vals.dtype,
            device=index.device)
        # LRU state is flat numpy, not a dict: ``_table`` maps the flat
        # (shard, tile) key to its slot (-1 = absent), ``_stamp`` holds
        # each slot's last-touch tick and ``_slot_key`` the reverse map
        # for eviction.  The all-hits path is then one table gather and
        # one vectorised stamp scatter, with no per-tile Python loop.
        self._table = np.full(
            self._offs.shape[0] * self._fences.shape[1], -1, np.int32)
        self._stamp = np.zeros(self.capacity, np.int64)
        self._slot_key = np.full(self.capacity, -1, np.int64)
        self._tick = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self._size_gauge.set(0)

    def swap_index(self, index) -> None:
        """Atomically move the cache to a new index generation (the
        epoch swap of a rebuilt / compacted index): every cached tile is
        invalidated before the first lookup against the new index, so a
        stale tile is never served."""
        self.epoch += 1
        self._bind(index)

    # -- host routing mirror -------------------------------------------------

    def _route_host(self, t: np.ndarray, d: np.ndarray):
        """numpy mirror of the device ``_route`` dispatch: (k, lo, hi)
        per pair, with ``lo == hi`` for invalid terms — identical clip
        semantics to the ``mode="clip"`` gathers it mirrors."""
        vmax = self._offs.shape[1] - 1
        k_n = self._offs.shape[0]
        w = np.clip(t, 0, None).astype(np.int64)
        k = self._t2s[np.minimum(w, self._t2s.shape[0] - 1)]
        if self._st is not None:
            k = k + ((self._st[None, :] == w[:, None])
                     & (self._sd[None, :] <= d[:, None]
                        .astype(np.int64))).sum(-1)
        k = np.clip(k, 0, k_n - 1)
        row = np.clip(w - self._rlo[k], 0, vmax)
        lo = self._offs[k, row]
        hi = self._offs[k, np.clip(row + 1, 0, vmax)]
        hi = np.where(np.asarray(t) >= 0, hi, lo)
        return k, lo, hi

    def _tile_of(self, k: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 d: np.ndarray) -> np.ndarray:
        """The single tile that can contain ``d`` within the routed
        range [lo, hi): rightmost fence <= d among the fences strictly
        inside the range (those are the term's own sorted ids), else the
        range's first tile.  Vectorised host binary search; empty ranges
        return their ``lo // tile`` (the caller's window is empty there
        anyway)."""
        t = self.tile
        f_n = self._fences.shape[1]
        jt0 = (lo // t).astype(np.int64)
        jt1 = np.maximum((np.maximum(hi, lo + 1) - 1) // t, jt0)
        lo_j, hi_j = jt0.copy(), jt1.copy()
        # fixed-trip rightmost-true search over (jt0, jt1]; trips sized
        # to the WIDEST routed range in the batch, not the whole fence
        # row — most terms span a handful of tiles, so this is usually
        # a fraction of log2(f_n) passes over the batch
        width = int((jt1 - jt0).max()) if jt0.shape[0] else 0
        for _ in range(width.bit_length() + 1):
            cont = lo_j < hi_j
            mid = (lo_j + hi_j + 1) // 2
            pred = self._fences[k, np.clip(mid, 0, f_n - 1)] <= d
            lo_j = np.where(cont & pred, mid, lo_j)
            hi_j = np.where(cont & ~pred, mid - 1, hi_j)
        return lo_j

    # -- the lookup ----------------------------------------------------------

    @torch.inference_mode()
    def lookup(self, terms: np.ndarray, docs: np.ndarray) -> torch.Tensor:
        """(P,) distinct (term, doc) pairs -> (P, n_b, n_f) value rows
        (on the index's device, f32): exact zeros for absent or invalid
        pairs, bitwise-equal to ``index.lookup_pairs`` on the same
        pairs."""
        from ..kernels.csr_lookup import (cached_tile_lookup,
                                          fill_tile_cache, gather_tiles,
                                          gather_tiles_packed)
        dev = self.index.device
        as_dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(dev)
        terms = np.asarray(terms, np.int64)
        docs = np.asarray(docs, np.int64)
        k, lo, hi = self._route_host(terms, docs)
        live = lo < hi
        jt = self._tile_of(k, lo, hi, docs)
        # distinct (shard, tile) working set for this batch
        key = k * self._fences.shape[1] + jt
        uniq, inv = np.unique(np.where(live, key, -1),
                              return_inverse=True)
        slot_of = np.empty(uniq.shape[0], np.int32)
        live_u = uniq >= 0
        slot_of[~live_u] = 0    # the dead-pair bucket: any slot works,
        #                         its window is empty
        slot_of[live_u] = self._table[uniq[live_u]]
        hits = int((slot_of[live_u] >= 0).sum())
        # hit slots are pinned: the batch references them, so eviction
        # for this batch's own misses must never reclaim them
        pinned = np.zeros(self.capacity, np.bool_)
        pinned[slot_of[live_u][slot_of[live_u] >= 0]] = True
        miss_rows, miss_starts, miss_slots = [], [], []
        misses = overflow = evictions = 0
        miss_ix = np.flatnonzero(live_u & (slot_of < 0))
        for i in miss_ix:       # steady state: this loop is empty
            u = int(uniq[i])
            if self._free:
                slot = self._free.pop()
            else:
                # LRU victim: the stalest slot not pinned by this batch
                cand = np.where(pinned, np.iinfo(np.int64).max,
                                self._stamp)
                slot = int(cand.argmin())
                if pinned[slot]:
                    # the batch's working set exceeds the cache budget:
                    # evicting now would clobber a tile an earlier pair
                    # of this same batch still references.  These pairs
                    # take the uncached routed lookup instead.
                    overflow += 1
                    continue
                self._table[self._slot_key[slot]] = -1
                evictions += 1
            self._table[u] = slot
            self._slot_key[slot] = u
            pinned[slot] = True
            misses += 1
            miss_rows.append(u // self._fences.shape[1])
            miss_starts.append((u % self._fences.shape[1]) * self.tile)
            miss_slots.append(slot)
            slot_of[i] = slot
        # one batch = one tick: every touched slot becomes equally
        # recent (batch-granular LRU)
        self._tick += 1
        touched = slot_of[live_u]
        self._stamp[touched[touched >= 0]] = self._tick
        if miss_slots:
            rows, starts = as_dev(miss_rows), as_dev(miss_starts)
            if self.index.codec != "none":
                ids, vals = gather_tiles_packed(
                    self.index._packed(), self.index._serve_values,
                    rows, starts, tile=self.tile)
            else:
                ids, vals = gather_tiles(
                    self.index.doc_ids, self.index._serve_values,
                    rows, starts, tile=self.tile)
            fill_tile_cache(self._cache_ids, self._cache_vals, ids, vals,
                            as_dev(miss_slots))
        slots = slot_of[inv]
        spilled = slots < 0
        if obs.enabled():
            # hits/misses/evictions count distinct TILES per batch (the
            # unit the budget is in); overflow counts the PAIRS that
            # took the fallback (the unit the spill cost is in)
            if hits:
                self._hits.inc(hits)
            if misses:
                self._misses.inc(misses)
            if evictions:
                self._evictions.inc(evictions)
            if overflow:
                self._overflow.inc(int(spilled.sum()))
            self._size_gauge.set(self.capacity - len(self._free))
        base = jt * self.tile
        win_lo = np.where(live & ~spilled, np.maximum(lo - base, 0), 0)
        win_hi = np.where(live & ~spilled,
                          np.minimum(hi - base, self.tile), 0)
        scale = (torch.from_numpy(self._pair_scale(k, terms)).to(dev)
                 if self._scale is not None else None)
        out = cached_tile_lookup(
            self._cache_ids, self._cache_vals, as_dev(np.maximum(slots, 0)),
            as_dev(win_lo), as_dev(win_hi), as_dev(docs), scale)
        if spilled.any():
            # over-budget tiles: resolve their pairs with the routed
            # lookup kernel (still one bisect per distinct pair) and
            # scatter the rows in
            ix = np.flatnonzero(spilled)
            rows = self.index.lookup_pair_rows(as_dev(terms[ix]),
                                               as_dev(docs[ix]))
            out[torch.from_numpy(ix).to(dev)] = rows
        return out

    def _pair_scale(self, k: np.ndarray, terms: np.ndarray) -> np.ndarray:
        """Host mirror of ``kernels.csr_lookup.ref._lane_scale``: the
        owning shard's per-local-term dequant scale (packed-q8)."""
        vmax = self._scale.shape[1]
        w = np.clip(terms, 0, None)
        row = np.clip(w - self._rlo[k], 0, vmax - 1)
        return np.ascontiguousarray(
            self._scale[np.clip(k, 0, self._scale.shape[0] - 1), row],
            np.float32)
