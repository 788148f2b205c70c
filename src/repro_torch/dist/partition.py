"""Term-range partitioned SEINE index, and the merger that builds it.

Port of ``repro.dist.partition``, without a mesh.
K contiguous term-range shards, each with its own local ``term_offsets``
/ ``doc_ids`` / ``values``, padded to common widths and stacked on a
leading K axis; two small tables route a global term to its shard:

  term_to_shard (|v|,)   global term -> (first) owning shard
  range_lo      (K,)     first global term of each shard

Doc-range sub-shards split a hot term's posting list across consecutive
shards by doc id; ``split_term``/``split_doc`` then make the owner a
function of the (term, doc) pair.  Every pair is resolved against its
owning shard only, so the cross-shard merge is an exclusive write and M
equals the single-CSR lookup bit for bit.  Padding rows are empty
posting lists and are never found.

A codec (``core.codec``) replaces the raw ``doc_ids`` by the packed
quadruple ``packed_words`` / ``tile_bits`` / ``tile_base`` /
``tile_word_off`` (``doc_ids`` is None) and, under ``"packed-q8"``, the
f32 ``values`` by int8 ``values_q`` + per-(shard, local term)
``value_scale``.  Ids decode losslessly, so every lookup and scan stays
bitwise equal to the raw index; only q8 values are approximate.

:func:`partitioned_from_runs` is the stage-4 merger (term-sorted posting
runs -> K shards), planned and merged on the host in numpy as in the
reference; ``dist.sharding.partition_index`` feeds it one run holding a
built index.  Both record the reference's ``obs`` gauges: the shard
balance (``seine_shard_*``) and the codec's bit widths and bytes saved
(``seine_codec_*``).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.index import merge_run_parts
from ..kernels.utils import resolve_device


def _host(a) -> np.ndarray:
    """A host numpy view (tensors are copied off their device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class PartitionedIndex:
    """K term-range shards of a SegmentInvertedIndex, stacked on axis 0."""
    term_offsets: torch.Tensor  # (K, Vmax+1) int32 shard-local CSR offsets
    doc_ids: Optional[torch.Tensor]  # (K, Nmax) int32 padded with n_docs;
    #                                  None under a packed codec
    values: Optional[torch.Tensor]   # (K, Nmax, n_b, n_f) f32 zero-padded;
    #                                  None under codec "packed-q8"
    term_to_shard: torch.Tensor  # (|v|,) int32 routing table
    range_lo: torch.Tensor      # (K,) int32 first global term of each shard
    idf: torch.Tensor           # (|v|,)
    doc_len: torch.Tensor       # (n_docs,) float32
    seg_len: torch.Tensor       # (n_docs, n_b) float32
    n_docs: int = 0
    vocab_size: int = 0
    n_b: int = 1
    n_shards: int = 1
    functions: Tuple[str, ...] = ()
    # (K, ceil(Nmax/tile)) int32 per-shard fence rows, raw under every
    # codec (at the codec tile when packed: they anchor the packed tiles)
    fences: Optional[torch.Tensor] = None
    # (K,) int32 last global term (inclusive) with postings in shard k;
    # None (legacy checkpoints) falls back to table-based ownership
    range_hi: Optional[torch.Tensor] = None
    # (K,) int32 doc-range sub-shard tables: split_term[k] is the term
    # continuing into shard k from k-1 (-1 if none), split_doc[k] the
    # first doc id shard k owns of it; None when no term was split
    split_term: Optional[torch.Tensor] = None
    split_doc: Optional[torch.Tensor] = None
    # -- codec axis (core.codec tile-compressed postings) -------------------
    codec: str = "none"
    codec_tile: int = 0
    max_tile_words: int = 0
    # pack-time loop bounds of the ref's bisects: (max tiles any term's
    # range spans, max posting-list length); (0, 0) = unknown
    codec_spans: Tuple[int, int] = (0, 0)
    packed_words: Optional[torch.Tensor] = None   # (K, W) int32
    tile_bits: Optional[torch.Tensor] = None      # (K, F) int32
    tile_base: Optional[torch.Tensor] = None      # (K, F) int32
    tile_word_off: Optional[torch.Tensor] = None  # (K, F+1) int32
    values_q: Optional[torch.Tensor] = None       # (K, Nmax, n_b, n_f) int8
    value_scale: Optional[torch.Tensor] = None    # (K, Vmax) f32

    @property
    def device(self) -> torch.device:
        return self.term_offsets.device

    @property
    def nnz(self) -> int:
        """True stored pairs (padding excluded)."""
        return int(self.term_offsets[:, -1].sum())

    @property
    def nmax(self) -> int:
        """Padded postings per shard row."""
        return int(self._serve_values.shape[1])

    def _packed(self):
        """The codec quadruple in the order the kernels take it."""
        return (self.packed_words, self.tile_bits, self.tile_base,
                self.tile_word_off)

    @property
    def _serve_values(self) -> torch.Tensor:
        """The values lookups read: f32, or int8 under q8."""
        return self.values_q if self.codec == "packed-q8" else self.values

    @property
    def posting_nbytes(self) -> int:
        """Bytes of the per-posting payload only: ids (raw or packed,
        with the codec's tile tables) + values (+ scales).  Fences and the
        replicated tables are common to every codec and left out."""
        return sum(a.numel() * a.element_size()
                   for a in (self.doc_ids, self.values, self.packed_words,
                             self.tile_bits, self.tile_base,
                             self.tile_word_off, self.values_q,
                             self.value_scale)
                   if a is not None)

    @property
    def nbytes(self) -> int:
        """Total bytes across all shards (padding included)."""
        return self.posting_nbytes + sum(
            a.numel() * a.element_size()
            for a in (self.term_offsets, self.fences, self.term_to_shard,
                      self.range_lo, self.range_hi, self.split_term,
                      self.split_doc, self.idf, self.doc_len, self.seg_len)
            if a is not None)

    @property
    def avg_doc_len(self) -> torch.Tensor:
        return self.doc_len.mean()

    def fn_index(self, name: str) -> int:
        return self.functions.index(name)

    def _codec_kwargs(self) -> dict:
        """The ops' codec arguments for this index."""
        if self.codec == "none":
            return {}
        return dict(codec=self.codec, packed=self._packed(),
                    value_scale=self.value_scale,
                    codec_spans=self.codec_spans)

    def _check_codec_tile(self, tile):
        """A packed layout bakes its tile width into the word offsets and
        fence spacing, so an overriding ``tile`` is refused up front."""
        if (self.codec != "none" and tile is not None
                and int(tile) != self.codec_tile):
            raise ValueError(
                f"lookup tile {tile} does not match this index's packed "
                f"codec tile {self.codec_tile}; packed indexes serve only "
                "at their build-time tile (rebuild with codec='none' to "
                "sweep tile widths)")

    def _tile(self, tile):
        self._check_codec_tile(tile)
        return self.codec_tile if self.codec != "none" else tile

    # -- lookups (Eq. 4, term-partitioned) ----------------------------------

    def lookup_pairs(self, term_ids: torch.Tensor, doc_ids: torch.Tensor,
                     *, alive=None) -> torch.Tensor:
        """(..., Q) term ids x (...,) doc ids -> (..., Q, n_b, n_f): one
        routed bisect per (term, doc) pair against its owning shard,
        zeros for absent pairs, non-owned terms and dead docs."""
        if self.codec != "none":
            from ..kernels.csr_lookup import lookup_pairs_packed_ref
            return lookup_pairs_packed_ref(
                self.term_offsets, self._packed(), self.fences,
                self._serve_values, self.value_scale, self.term_to_shard,
                self.range_lo, term_ids, doc_ids, self.split_term,
                self.split_doc, tile=self.codec_tile,
                spans=self.codec_spans, alive=alive)
        from ..kernels.csr_lookup import lookup_pairs_ref
        return lookup_pairs_ref(
            self.term_offsets, self.doc_ids, self.values,
            self.term_to_shard, self.range_lo, term_ids, doc_ids,
            self.split_term, self.split_doc, alive=alive)

    def lookup_pair_rows(self, terms: torch.Tensor, docs: torch.Tensor
                         ) -> torch.Tensor:
        """Distinct pairs ``terms (P,)`` x ``docs (P,)`` -> (P, n_b, n_f)
        through ``kernels.csr_lookup.csr_lookup_pairs`` (the lookup
        kernel on CUDA, routed per pair)."""
        from ..kernels.csr_lookup import csr_lookup_pairs
        return csr_lookup_pairs(
            self.term_offsets, self.doc_ids, self._serve_values,
            self.term_to_shard, self.range_lo, terms, docs,
            fences=self.fences, split_term=self.split_term,
            split_doc=self.split_doc, tile=self._tile(None),
            **self._codec_kwargs())

    def qd_matrix(self, query_terms: torch.Tensor, doc_ids: torch.Tensor,
                  *, impl: Optional[str] = None, tile: Optional[int] = None,
                  alive=None) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> M_{q,d} (B, Q, n_b, n_f)
        through ``kernels.csr_lookup.csr_lookup`` (``impl`` and ``tile``
        as there; a packed index takes only its codec tile)."""
        from ..kernels.csr_lookup import csr_lookup
        return csr_lookup(
            self.term_offsets, self.doc_ids, self._serve_values,
            self.term_to_shard, self.range_lo, query_terms, doc_ids,
            fences=self.fences, split_term=self.split_term,
            split_doc=self.split_doc, tile=self._tile(tile), impl=impl,
            alive=alive, **self._codec_kwargs())

    def retrieve_topk(self, query_terms: torch.Tensor, k: int,
                      score_block_fn, *, doc_block: Optional[int] = None,
                      impl: Optional[str] = None, tile: Optional[int] = None,
                      alive=None, n_docs: Optional[int] = None,
                      extra_m_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-stage top-k over the K-stacked layout; the (query,
        shard) lane grid walks each shard's slice of each query term, and
        range-based ownership counts a sub-sharded hot term's docs once.
        ``n_docs`` (default: this index's) and ``extra_m_fn`` as in
        ``kernels.csr_lookup.csr_retrieve_topk``: the live index scans
        its whole doc space and adds its delta's M through them."""
        from ..kernels.csr_lookup import csr_retrieve_topk
        return csr_retrieve_topk(
            self.term_offsets, self.doc_ids, self._serve_values,
            self.term_to_shard, self.range_lo, self.range_hi, query_terms,
            n_docs=self.n_docs if n_docs is None else n_docs, k=k,
            score_block_fn=score_block_fn, doc_block=doc_block,
            tile=self._tile(tile), impl=impl, fences=self.fences,
            alive=alive, extra_m_fn=extra_m_fn, **self._codec_kwargs())

    def block_scanner(self, query_terms: torch.Tensor, block: int,
                      n_blocks: int, *, impl: Optional[str] = None,
                      tile: Optional[int] = None, alive=None):
        """``blo -> M (block, Q, n_b, n_f)`` for the ``n_blocks`` doc blocks
        from doc 0, over this index's postings (the first-stage scan's
        block function: one lane-bounds table for all the blocks on the
        kernel path)."""
        from ..kernels.csr_lookup.ops import _block_scanner
        c = self._codec_kwargs()
        return _block_scanner(
            self.term_offsets, self.doc_ids, self._serve_values,
            self.term_to_shard, self.range_lo, self.range_hi, query_terms,
            int(block), self._tile(tile), impl, alive,
            c.get("codec", "none"), c.get("packed"), c.get("value_scale"),
            c.get("codec_spans", (0, 0)), self.fences, 0, int(n_blocks))


# ---------------------------------------------------------------------------
# codec application (core.codec tile-compressed postings)
# ---------------------------------------------------------------------------

def _codec_arrays(codec: str, tile: int, doc_ids: np.ndarray,
                  values: torch.Tensor, term_offsets: torch.Tensor) -> dict:
    """Pack host doc ids (and, under q8, quantise ``values`` on their own
    device) for ``codec``; the dict of constructor overrides, on the
    device of ``values``."""
    from ..core.codec import pack_doc_ids, quantize_values_torch

    dev = values.device
    p = pack_doc_ids(doc_ids, tile)
    offs = _host(term_offsets).astype(np.int64)
    lo, hi = offs[:, :-1], offs[:, 1:]
    live = hi > lo
    # loop-bound hint: the widest routed range, in tiles and in postings
    span = int(np.where(live, (hi - 1) // tile - lo // tile + 1, 1)
               .max(initial=1))
    max_len = int((hi - lo).max(initial=1))
    to_dev = lambda a: torch.from_numpy(a).to(dev)
    out = dict(
        codec=codec, codec_tile=int(tile),
        max_tile_words=int(p.max_tile_words), codec_spans=(span, max_len),
        doc_ids=None, packed_words=to_dev(p.packed_words),
        tile_bits=to_dev(p.tile_bits), tile_base=to_dev(p.tile_base),
        tile_word_off=to_dev(p.tile_word_off))
    raw_bytes = int(np.prod(doc_ids.shape)) * 4
    packed_bytes = p.nbytes
    if codec == "packed-q8":
        q, scale = quantize_values_torch(values, term_offsets.to(dev))
        out.update(values=None, values_q=q, value_scale=scale)
        raw_bytes += values.numel() * 4
        packed_bytes += (q.numel() * q.element_size()
                         + scale.numel() * scale.element_size())
    bits_hist = obs.gauge("seine_codec_tile_bits_total",
                          "posting tiles per packed bit width")
    bits_hist.clear()
    widths, counts = np.unique(p.tile_bits, return_counts=True)
    for w, c in zip(widths, counts):
        bits_hist.set(int(c), bits=str(int(w)))
    obs.gauge("seine_codec_bytes_saved",
              "posting bytes removed by the codec").set(
        max(raw_bytes - packed_bytes, 0))
    obs.gauge("seine_codec_shrink",
              "raw / packed posting payload bytes").set(
        raw_bytes / max(packed_bytes, 1))
    return out


def pack_index(pidx: PartitionedIndex, codec: str,
               tile: Optional[int] = None) -> PartitionedIndex:
    """Re-encode an uncompressed PartitionedIndex under ``codec`` at
    ``tile`` (default ``POSTING_TILE``; the fences are rebuilt at it).
    Ids are packed on the host; q8 values quantise on the index's
    device, bitwise as the reference's numpy quantiser."""
    from ..core.codec import validate_codec
    from ..core.index import POSTING_TILE, build_fences

    codec = validate_codec(codec)
    if pidx.codec != "none":
        raise ValueError(f"index is already packed ({pidx.codec!r}); "
                         "unpack_index first to re-encode")
    if codec == "none":
        return pidx
    t = int(tile or POSTING_TILE)
    over = _codec_arrays(codec, t, _host(pidx.doc_ids), pidx.values,
                         pidx.term_offsets)
    over["fences"] = build_fences(pidx.doc_ids, t)
    return dataclasses.replace(pidx, **over)


def unpack_index(pidx: PartitionedIndex) -> PartitionedIndex:
    """The raw layout back from a packed index: ids decode bitwise; q8
    values dequantise (approximate by design)."""
    from ..core.codec import PackedIds, position_scales, unpack_doc_ids

    if pidx.codec == "none":
        return pidx
    p = PackedIds(*(_host(a) for a in pidx._packed()), pidx.max_tile_words,
                  pidx.codec_tile, pidx.nmax)
    doc_ids = torch.from_numpy(unpack_doc_ids(p)).to(pidx.device)
    values = pidx.values
    if pidx.codec == "packed-q8":
        pos_scale = position_scales(pidx.value_scale, pidx.term_offsets,
                                    pidx.nmax)
        values = (pidx.values_q.to(torch.float32)
                  * pos_scale[..., None, None])
    return dataclasses.replace(
        pidx, codec="none", codec_tile=0, max_tile_words=0,
        codec_spans=(0, 0), doc_ids=doc_ids, values=values,
        packed_words=None, tile_bits=None, tile_base=None,
        tile_word_off=None, values_q=None, value_scale=None)


# ---------------------------------------------------------------------------
# shard-native assembly from term-sorted posting runs (the stage-4 merger)
# ---------------------------------------------------------------------------

def merged_term_counts(runs: Sequence, vocab_size: int) -> np.ndarray:
    """Global postings per term, (|v|,) int64, accumulated run by run."""
    counts = np.zeros(vocab_size, np.int64)
    for run in runs:
        counts += run.term_counts(vocab_size)
    return counts


def partitioned_from_runs(runs: Sequence, k: int, *, idf, doc_len,
                          seg_len, n_docs: int, vocab_size: int, n_b: int,
                          functions: Tuple[str, ...], mesh=None,
                          split_hot: bool = True, codec: str = "none",
                          codec_tile: Optional[int] = None,
                          device=None) -> PartitionedIndex:
    """Assemble a K-shard PartitionedIndex from term-sorted runs
    (``core.build_pipeline.PostingRun``), on ``device`` (default CUDA).

    Per-term counts give the global CSR boundary array; the planners of
    ``dist.sharding`` cut it into K nnz-balanced ranges, sub-sharding a
    hot term by doc range when its list exceeds the even split
    (``split_hot=False``: term-aligned cuts only, with the skew warning);
    each shard's local CSR is merged from the runs' slices.  Offsets past
    a shard's span pin at its nnz, doc ids pad with ``n_docs``, values
    with zeros.  ``k`` beyond the populated terms is clamped with a
    warning.  Under a codec the ids are packed at ``codec_tile`` (default
    ``POSTING_TILE``) and the fences anchor at that tile.  A ``mesh``
    is not ported yet and raises.
    """
    from ..core.codec import validate_codec
    from ..core.index import POSTING_TILE, build_fences
    from .sharding import plan_posting_ranges, plan_term_ranges

    codec = validate_codec(codec)
    if mesh is not None:
        raise NotImplementedError("mesh placement is not ported yet")
    dev = resolve_device(device)
    counts = merged_term_counts(runs, vocab_size)
    n_pop = int(np.count_nonzero(counts))
    if k > max(n_pop, 1):
        warnings.warn(
            f"partitioned_from_runs: k={k} exceeds the {n_pop} populated "
            f"term range(s); clamping to {max(n_pop, 1)} to avoid "
            f"zero-nnz shards", stacklevel=2)
        k = max(n_pop, 1)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    ranks = np.zeros(k + 1, np.int64)
    if split_hot:
        bounds, ranks = plan_posting_ranges(offs, k)
    else:
        bounds = plan_term_ranges(offs, k)
    if not ranks.any():
        # term-aligned plan: give every range at least one populated term
        # (left clamp), leaving k - i populated terms for the ranges after
        # cut i (right clamp); no-ops for plans that are already valid
        pop = np.flatnonzero(counts)
        if k > 1 and pop.size >= k:
            for i in range(1, k):
                nxt = int(np.searchsorted(pop, bounds[i - 1]))
                lo_min = int(pop[nxt]) + 1
                hi_max = int(pop[pop.size - (k - i)])
                bounds[i] = min(max(int(bounds[i]), lo_min), hi_max)

    # shard i's term range is [t_first[i], t_last[i]] INCLUSIVE: cut i
    # with ranks[i] > 0 puts term bounds[i] in both shard i-1 and shard i
    t_first = bounds[:-1].copy()
    t_last = np.empty(k, np.int64)
    for i in range(k):
        t_last[i] = bounds[i + 1] - 1 if ranks[i + 1] == 0 \
            else bounds[i + 1]
    t_last = np.maximum(t_last, t_first)          # empty-range guard
    spans = t_last - t_first + 1
    pos_bounds = offs[bounds] + ranks             # global posting cuts
    local_nnz = np.diff(pos_bounds)
    vmax = max(int(spans.max()), 1)
    nmax = max(int(local_nnz.max()), 1)
    ideal = -(-int(offs[-1]) // k)          # ceil(nnz / k)
    # shard-balance telemetry: the quantities the padded-storage and
    # per-device byte claims ride on
    shard_nnz = obs.gauge("seine_shard_nnz", "postings per shard")
    shard_nnz.clear()               # drop stale shards from a previous plan
    for i in range(k):
        shard_nnz.set(int(local_nnz[i]), shard=str(i))
    obs.gauge("seine_shard_count", "shards in the last partition plan"
              ).set(k)
    obs.gauge("seine_shard_skew_max_ratio",
              "widest shard vs even split").set(nmax / max(ideal, 1))
    obs.gauge("seine_shard_skew_mean_ratio",
              "mean shard vs even split").set(
        float(local_nnz.mean()) / max(ideal, 1))
    obs.gauge("seine_shard_hot_splits",
              "doc-range sub-shard cuts in the plan").set(
        int((ranks[1:k] > 0).sum()) if k > 1 else 0)
    if k > 1 and nmax > 2 * ideal:
        warnings.warn(
            f"partitioned_from_runs: skewed posting lists — widest shard "
            f"holds {nmax} postings vs an even split of {ideal}; padded "
            f"storage is ~{k * nmax / max(int(offs[-1]), 1):.1f}x nnz and "
            f"per-device bytes will not shrink ~1/K (hot term dominates; "
            f"doc-range sub-sharding is disabled or was defeated)",
            stacklevel=2)

    # split tables: the doc id where each mid-list cut lands, from the hot
    # terms' doc ids merged across runs (ids only)
    split_term = np.full(k, -1, np.int32)
    split_doc = np.zeros(k, np.int32)
    hot = sorted({int(bounds[i]) for i in range(1, k) if ranks[i] > 0})
    if hot:
        hot_docs = {w: [] for w in hot}
        for run in runs:
            t, d = run.ids()
            for w in hot:
                sl = int(np.searchsorted(t, w, side="left"))
                sr = int(np.searchsorted(t, w, side="right"))
                if sr > sl:
                    hot_docs[w].append(np.asarray(d[sl:sr]).copy())
        merged = {w: np.sort(np.concatenate(ps))
                  for w, ps in hot_docs.items()}
        for i in range(1, k):
            if ranks[i] > 0:
                w = int(bounds[i])
                split_term[i] = w
                split_doc[i] = int(merged[w][int(ranks[i])])

    # one pass over the runs: slice every shard's range out of each run
    # (views); a mid-list cut lands inside its term's slice at the doc
    # boundary: rows of term w with doc < split_doc go left
    n_f = len(functions)
    parts: list = [[] for _ in range(k)]
    for run in runs:
        t, d, v = run.load()
        cuts = np.empty(k + 1, np.int64)
        cuts[0], cuts[k] = 0, t.shape[0]
        for i in range(1, k):
            c = int(np.searchsorted(t, bounds[i], side="left"))
            if ranks[i] > 0:
                sr = int(np.searchsorted(t, bounds[i], side="right"))
                c += int(np.searchsorted(d[c:sr], split_doc[i],
                                         side="left"))
            cuts[i] = c
        cuts = np.maximum.accumulate(cuts)
        for i in range(k):
            lo, hi = int(cuts[i]), int(cuts[i + 1])
            if hi > lo:
                parts[i].append((t[lo:hi], d[lo:hi], v[lo:hi]))
    term_offsets = np.empty((k, vmax + 1), np.int32)
    doc_ids = np.full((k, nmax), int(n_docs), np.int32)
    values = np.zeros((k, nmax, n_b, n_f), np.float32)
    for i in range(k):
        t_lo, t_hi = int(t_first[i]), int(t_last[i]) + 1
        span = t_hi - t_lo
        loc_offs, loc_docs, loc_vals = merge_run_parts(
            parts[i], t_lo, t_hi, n_b=n_b, n_f=n_f)
        parts[i] = None                 # free as each shard lands
        n = int(loc_docs.shape[0])
        term_offsets[i, :span + 1] = loc_offs[:span + 1]
        term_offsets[i, span + 1:] = n
        doc_ids[i, :n] = loc_docs
        values[i, :n] = loc_vals
    # routing: term -> FIRST owning shard; later sub-shards of a split
    # term are reached by counting split boundaries <= the candidate doc
    table_bnd = np.empty(k + 1, np.int64)
    table_bnd[0], table_bnd[k] = 0, vocab_size
    for i in range(1, k):
        table_bnd[i] = bounds[i] + (1 if ranks[i] > 0 else 0)
    table_bnd = np.maximum.accumulate(table_bnd)
    term_to_shard = np.repeat(np.arange(k, dtype=np.int32),
                              np.diff(table_bnd))
    any_split = bool((split_term >= 0).any())

    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    f32 = lambda a: to_dev(_host(a).astype(np.float32))
    ids_t, offs_t = to_dev(doc_ids), to_dev(term_offsets)
    over = dict(doc_ids=ids_t, values=to_dev(values))
    del values
    t = int(codec_tile or POSTING_TILE)
    over["fences"] = build_fences(ids_t, t if codec != "none"
                                  else POSTING_TILE)
    if codec != "none":
        over.update(_codec_arrays(codec, t, doc_ids, over["values"],
                                  offs_t))
    return PartitionedIndex(
        term_to_shard=to_dev(term_to_shard),
        range_lo=to_dev(t_first.astype(np.int32)),
        idf=f32(idf), doc_len=f32(doc_len), seg_len=f32(seg_len),
        n_docs=int(n_docs), vocab_size=int(vocab_size), n_b=int(n_b),
        n_shards=int(k), functions=tuple(functions),
        term_offsets=offs_t, range_hi=to_dev(t_last.astype(np.int32)),
        split_term=to_dev(split_term) if any_split else None,
        split_doc=to_dev(split_doc) if any_split else None,
        **over)
