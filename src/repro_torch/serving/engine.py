"""Query-time retrieval engine (the paper's retrieval phase, Fig. 1).

Port of ``repro.serving.engine`` without a mesh (``mesh=`` raises), live
index included.  The engine and the serving loops record the
reference's ``obs`` counters, gauges and spans.
``SeineEngine`` looks M_{q,d} up from the segment inverted index (raw or
with packed postings) and scores it with a registered retriever; on CUDA
tensors the lookup, the first-stage scan and KNRM's kernel bank run the
hand-written kernels.  ``NoIndexEngine`` recomputes M at query time
from the docs' tokens (the paper's "No Index" row), through the
``seg_interact`` kernel on CUDA.
``serve_batches`` / ``serve_retrieval`` are the serving loops.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.index import gather_clip
from ..dist.partition import PartitionedIndex
from ..retrievers import QMeta, get_retriever


def _sample_every() -> int:
    """Sampled lookup stats (found-mask hit rate, shard routing) cost a
    real device lookup and a host sync, so they run on every N-th
    ``score`` call only: N from ``REPRO_OBS_SAMPLE``, default 16 (call 1
    always samples, so short runs still export the gauges)."""
    try:
        return max(int(os.environ.get("REPRO_OBS_SAMPLE", "16")), 1)
    except ValueError:
        return 16


def make_qmeta(index, query_terms: torch.Tensor, doc_ids: torch.Tensor
               ) -> QMeta:
    """Per-(query, candidate) scoring metadata: query mask/idf plus the
    candidates' doc/segment lengths and the corpus ``avg_dl``.  Pad
    query slots (term id < 0) get zero mask/idf; ids clamp to the tables'
    edges, as the reference's clip gathers do."""
    valid = query_terms >= 0
    return QMeta(
        q_mask=valid.to(torch.float32),
        q_idf=gather_clip(index.idf, query_terms.clamp(min=0)) * valid,
        doc_len=gather_clip(index.doc_len, doc_ids),
        seg_len=gather_clip(index.seg_len, doc_ids),
        avg_dl=index.avg_doc_len,
    )


def _as_ids(x, device: torch.device) -> torch.Tensor:
    """Ids from numpy, a list or a tensor as int32 on ``device``."""
    if isinstance(x, np.ndarray):       # torch refuses negative strides
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (block_until_ready)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class SeineEngine:
    """Indexed scorer over a :class:`~repro_torch.core.index.
    SegmentInvertedIndex` or a :class:`~repro_torch.dist.partition.
    PartitionedIndex`, on the index's device.

    ``partition="term"`` splits a single-CSR index into ``n_shards``
    (default 1) term-range shards with ``dist.sharding.partition_index``;
    a pre-built PartitionedIndex is served as it is.  ``codec="packed"``
    (FOR-packed doc ids, lossless: results equal the raw index bit for
    bit) or ``"packed-q8"`` (plus int8 values with per-term scales) needs
    ``partition="term"`` or a pre-built index of that codec, and packs at
    ``codec_tile`` (default ``POSTING_TILE``).  ``lookup_tile`` overrides
    the lookup kernel's posting-tile width (every width gives the same
    M); a packed index serves only at its codec tile.  ``mesh=`` is not
    ported yet and raises ``NotImplementedError``.

    A :class:`~repro_torch.dist.live.LiveIndex` mutates underneath the
    engine: every ``score`` / ``retrieve`` reads its current view once
    and serves that snapshot (no ``partition=``, and no codec other than
    its base's).
    """

    def __init__(self, index, retriever: str, params: Any, *,
                 mesh: Optional[Any] = None,
                 partition: Optional[str] = None,
                 n_shards: Optional[int] = None,
                 lookup_tile: Optional[int] = None,
                 codec: str = "none",
                 codec_tile: Optional[int] = None):
        from ..core.codec import validate_codec
        codec = validate_codec(codec)
        if partition not in (None, "term"):
            raise ValueError(f"unknown partition scheme {partition!r}; "
                             "supported: 'term'")
        if (codec != "none" and partition != "term"
                and not isinstance(index, PartitionedIndex)
                and not getattr(index, "is_live", False)):
            raise ValueError(
                f"codec {codec!r} requires partition='term': the packed "
                "posting layout is the stacked-shard PartitionedIndex")
        if n_shards is not None and int(n_shards) <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}; "
                             "pass None for one shard")
        if lookup_tile is not None and int(lookup_tile) <= 0:
            raise ValueError(
                f"lookup_tile must be positive, got {lookup_tile}; "
                "pass None for the default POSTING_TILE")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        self._live = bool(getattr(index, "is_live", False))
        if self._live:
            if partition is not None:
                raise ValueError(
                    "a LiveIndex is already partitioned (its base); "
                    "pass partition=None")
            if codec != "none" and codec != index.codec:
                raise ValueError(
                    f"engine codec {codec!r} conflicts with the live "
                    f"index's base codec {index.codec!r}")
        elif isinstance(index, PartitionedIndex):
            if codec != "none" and codec != index.codec:
                raise ValueError(
                    f"engine codec {codec!r} conflicts with the pre-built "
                    f"index's codec {index.codec!r}; pack it with "
                    "pack_index or pass codec='none'")
        elif partition == "term":
            from ..dist.sharding import partition_index
            index = partition_index(index, int(n_shards or 1), codec=codec,
                                    codec_tile=codec_tile)
        if (getattr(index, "codec", "none") != "none"
                and lookup_tile is not None
                and int(lookup_tile) != int(index.codec_tile)):
            raise ValueError(
                f"lookup_tile {lookup_tile} does not match the packed "
                f"index's codec tile {index.codec_tile}; packed layouts "
                "serve only at their build-time tile")
        self.index = index
        self.device = index.device
        self.spec = get_retriever(retriever)
        self.params = params.to(self.device)
        self._lookup_tile = lookup_tile
        # sampled lookup stats: the serve loops set defer_lookup_stats so
        # a sampled call only stages its arguments, and flush them after
        # the request's timer stops
        self._n_calls = 0
        self._sample_every = _sample_every()
        self.defer_lookup_stats = False
        self._pending_stats = None
        self._t2s_host = (index.term_to_shard.cpu().numpy()
                          if isinstance(index, PartitionedIndex)
                          or self._live else None)
        self._t2s_gen = getattr(index, "generation", -1)
        self._scores_counter = obs.counter("seine_engine_scores_total",
                                           "engine.score calls")
        self._retrieves_counter = obs.counter(
            "seine_engine_retrieves_total", "engine.retrieve calls")
        if obs.enabled():
            from ..core.index import POSTING_TILE
            obs.gauge("seine_index_nnz", "nnz of the served index").set(
                index.nnz)
            obs.gauge("seine_index_nbytes", "bytes of the served index"
                      ).set(index.nbytes)
            if getattr(index, "codec", "none") != "none":
                tile, nmax = int(index.codec_tile), index.nmax
            else:
                tile = int(lookup_tile or POSTING_TILE)
                nmax = int(index.doc_ids.shape[-1])
            obs.gauge("seine_lookup_tiles_per_shard",
                      "posting tiles per shard (ceil(Nmax / tile))").set(
                -(-nmax // tile))

    def _ids(self, x) -> torch.Tensor:
        return _as_ids(x, self.device)

    def _serving_index(self):
        """What one call serves: a live index's current view, read once,
        or the index itself."""
        return self.index.view if self._live else self.index

    @torch.inference_mode()
    def score(self, query_terms, doc_ids) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> scores (B,) on the device."""
        query_terms, doc_ids = self._ids(query_terms), self._ids(doc_ids)
        if obs.enabled():
            self._scores_counter.inc()
            self._n_calls += 1
            if self._n_calls == 1 or self._n_calls % self._sample_every == 0:
                if self.defer_lookup_stats:
                    self._pending_stats = (query_terms, doc_ids)
                else:
                    self._sample_lookup_stats(query_terms, doc_ids)
        index = self._serving_index()
        m = index.qd_matrix(query_terms, doc_ids, tile=self._lookup_tile)
        meta = make_qmeta(index, query_terms, doc_ids)
        return self.spec.score(self.params, m, meta, index.functions)

    def flush_lookup_stats(self) -> None:
        """Run a deferred sampled-stats lookup, if one is staged (the
        serve loops call this after they record the request's latency,
        so its device lookup and host syncs stay out of the timing)."""
        pending, self._pending_stats = self._pending_stats, None
        if pending is not None:
            self._sample_lookup_stats(*pending)

    @torch.inference_mode()
    def _found_counts(self, query_terms: torch.Tensor,
                      doc_ids: torch.Tensor) -> Tuple[int, int]:
        """(found pairs, valid pairs) of query_terms x doc_ids: the
        lookup's found mask alone, through its plain routed bisect (a
        live index's through ``dist.live.found_counts`` over its view)."""
        from ..dist.live import _index_found, found_counts
        index = self.index
        if self._live:
            return found_counts(index.view, query_terms, doc_ids)
        shape = (doc_ids.shape[0], query_terms.shape[0])
        q = query_terms[None].expand(shape)
        valid = q >= 0
        if not isinstance(index, PartitionedIndex):
            _, found = index.lookup_positions(q, doc_ids)
        else:
            found = _index_found(index, q, doc_ids[:, None].expand(shape))
        return int((found & valid).sum()), int(valid.sum())

    def _sample_lookup_stats(self, query_terms, doc_ids) -> None:
        if self._live and self.index.generation != self._t2s_gen:
            # compaction plans the term routing table again: refresh the
            # host copy once per generation
            self._t2s_host = self.index.term_to_shard.cpu().numpy()
            self._t2s_gen = self.index.generation
        found, total = self._found_counts(query_terms, doc_ids)
        obs.counter("seine_lookup_found_total",
                    "found pairs (sampled)").inc(found)
        obs.counter("seine_lookup_pairs_sampled_total",
                    "looked-up pairs (sampled)").inc(total)
        obs.gauge("seine_lookup_found_ratio",
                  "found-mask hit rate (sampled)").set(
            found / max(total, 1))
        # one winning posting tile per valid (term, doc) cell
        obs.gauge("seine_lookup_tile_dmas_per_query",
                  "posting-tile DMAs per request (sampled)").set(total)
        qt = query_terms.cpu().numpy()
        valid = qt[qt >= 0]
        n_cand = int(doc_ids.shape[0])
        pairs = obs.counter("seine_lookup_pairs_total",
                            "routed pairs per shard (sampled)")
        if self._t2s_host is not None and valid.size:
            # past-vocab terms have no routing-table row
            in_vocab = valid[valid < self._t2s_host.shape[0]]
            per = np.bincount(self._t2s_host[in_vocab],
                              minlength=self.index.n_shards)
            for k, c in enumerate(per):
                if c:
                    pairs.inc(int(c) * n_cand, shard=str(k))
        elif valid.size:
            pairs.inc(int(valid.size) * n_cand, shard="0")

    @torch.inference_mode()
    def retrieve(self, query_terms, k: int, *,
                 doc_block: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-stage retrieval: walk the index from the query's posting
        lists and return the corpus-wide top-k as ``(scores, doc_ids)``,
        each ``(min(k, n_docs),)``, scores descending, ties toward the
        lower doc id.  ``doc_block`` sets the scan's doc-block width
        (default: the whole corpus up to 1024)."""
        if int(k) <= 0:
            raise ValueError(f"k must be positive, got {k}")
        query_terms = self._ids(query_terms)
        index = self._serving_index()
        n_docs = index.n_docs
        if obs.enabled():
            self._retrieves_counter.inc()
            obs.counter("seine_retrieve_docs_scanned_total",
                        "docs covered by retrieve scans").inc(n_docs)
            obs.gauge("seine_retrieve_last_k",
                      "k of the most recent retrieve").set(
                min(int(k), n_docs))

        def score_block(m, docs):
            # blocks overrun the corpus tail; clamp the gather targets
            # (the top-k scan masks those scores to -inf afterwards)
            meta = make_qmeta(index, query_terms, docs.clamp(0, n_docs - 1))
            return self.spec.score(self.params, m, meta, index.functions)

        return index.retrieve_topk(query_terms, min(int(k), n_docs),
                                   score_block, doc_block=doc_block,
                                   tile=self._lookup_tile)


class NoIndexEngine:
    """Recomputes the q-d interaction matrix at query time (the No-Index
    baseline) with ``builder.make_qd_fn()``, tf > sigma mask included.
    ``index`` is used only for doc statistics and idf (the same
    ``make_qmeta``), never for interaction values.  ``tokens`` / ``segs``
    (n_docs, Lp) live on the builder's device; a candidate id gathers its
    doc's row as the reference's clipping gather does (negative ids wrap,
    then clamp)."""

    def __init__(self, builder, index, tokens: np.ndarray, segs: np.ndarray,
                 retriever: str, params: Any):
        self.builder = builder
        self.index = index
        self.device = builder.device
        as_dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(self.device)
        self.tokens, self.segs = as_dev(tokens), as_dev(segs)
        self.spec = get_retriever(retriever)
        self.params = params.to(self.device)
        self._qd_fn = builder.make_qd_fn()

    def _ids(self, x) -> torch.Tensor:
        return _as_ids(x, self.device)

    @torch.inference_mode()
    def qd_matrix(self, query_terms, doc_ids) -> torch.Tensor:
        """M_{q,d} (B, Q, n_b, n_f) recomputed for query_terms (Q,) and
        doc_ids (B,)."""
        query_terms, doc_ids = self._ids(query_terms), self._ids(doc_ids)
        return self._qd_fn(query_terms, gather_clip(self.tokens, doc_ids),
                           gather_clip(self.segs, doc_ids))

    @torch.inference_mode()
    def score(self, query_terms, doc_ids) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> scores (B,) on the device."""
        query_terms, doc_ids = self._ids(query_terms), self._ids(doc_ids)
        m = self.qd_matrix(query_terms, doc_ids)
        meta = make_qmeta(self.index, query_terms, doc_ids)
        return self.spec.score(self.params, m, meta, self.index.functions)


@dataclass
class ServeStats:
    """Per-request latency record: O(1) running count/total plus a deque
    of the most recent ``window`` samples for p50/p95 (a full history
    would grow forever).

    Thread safety: the front end records from its worker thread while
    the submitting thread reads quantiles, so ``record`` /
    ``note_queue_depth`` and the sorted-snapshot cache take a lock, and
    a reader never sorts a deque mid-append.

    Queue instrumentation (continuous batching): ``record`` takes an
    optional ``queue_ms`` (admission-to-dequeue wait, also exported as
    the ``seine_serve_queue_wait_ms`` histogram) and the front end calls
    ``note_queue_depth`` per batch, so ``max_queue_depth`` is the
    high-water mark."""
    latencies_ms: Sequence[float] = field(default_factory=list)
    window: int = 1 << 16
    queue_depth: int = 0
    max_queue_depth: int = 0
    _n: int = 0
    _total_ms: float = 0.0
    _queue_n: int = 0
    _queue_total_ms: float = 0.0
    _snap: Optional[np.ndarray] = field(default=None, repr=False)
    _snap_n: int = -1

    def __post_init__(self):
        self.latencies_ms = deque(self.latencies_ms, maxlen=self.window)
        self._lock = threading.Lock()
        self._hist = obs.histogram("seine_serve_latency_ms",
                                   "per-request serve latency (ms)")
        self._qhist = obs.histogram(
            "seine_serve_queue_wait_ms",
            "admission-to-dequeue wait in the serving queue (ms)")
        self._depth_gauge = obs.gauge(
            "seine_serve_queue_depth",
            "admission queue depth at batch formation")

    def record(self, ms: float, queue_ms: Optional[float] = None) -> None:
        # the obs writes stay inside the lock: metric samples are plain
        # dict read-modify-writes, unsafe under concurrent recorders
        with self._lock:
            self._n += 1
            self._total_ms += ms
            self.latencies_ms.append(ms)
            self._hist.observe(ms)
            if queue_ms is not None:
                self._queue_n += 1
                self._queue_total_ms += queue_ms
                self._qhist.observe(queue_ms)

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)
            self.max_queue_depth = max(self.max_queue_depth, int(depth))
            self._depth_gauge.set(depth)

    @property
    def n_requests(self) -> int:
        return self._n

    @property
    def total_ms(self) -> float:
        return self._total_ms

    @property
    def ms_per_request(self) -> float:
        return self._total_ms / max(self._n, 1)

    @property
    def queue_ms_per_request(self) -> float:
        with self._lock:
            return self._queue_total_ms / max(self._queue_n, 1)

    def _sorted_ms(self) -> np.ndarray:
        with self._lock:
            if self._snap is None or self._snap_n != self._n:
                self._snap = np.sort(np.asarray(self.latencies_ms,
                                                dtype=np.float64))
                self._snap_n = self._n
            return self._snap

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(self._sorted_ms(), q))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p95_ms(self) -> float:
        return self.percentile_ms(95.0)


def serve_batches(engine, requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                  batch_pad: int = 0) -> Tuple[List[np.ndarray], ServeStats]:
    """requests: list of (query_terms (Q,), candidate_doc_ids (B,)).

    ``batch_pad > 0`` pads every candidate set up to the next multiple of
    ``batch_pad`` with copies of candidate 0 and slices the pad scores
    off, so results equal the unpadded call (the reference buckets shapes
    for its jit cache; here it fixes the launch shapes).  An empty
    candidate set short-circuits to an empty result.  Each request's
    latency is timed up to the device finishing its scores.
    """
    if batch_pad < 0:
        raise ValueError(f"batch_pad must be >= 0, got {batch_pad}")
    stats = ServeStats()
    out = []
    real_slots = pad_slots = 0
    req_counter = obs.counter("seine_serve_requests_total",
                              "serve_batches requests")
    # sampled lookup stats cost a device lookup and host syncs: defer
    # them out of the timed region, restored on exit
    defer = getattr(engine, "flush_lookup_stats", None)
    prev_defer = getattr(engine, "defer_lookup_stats", False)
    if defer is not None:
        engine.defer_lookup_stats = True
    try:
        for q, docs in requests:
            docs = np.asarray(docs)
            n = docs.shape[0]
            req_counter.inc()
            if n == 0:
                obs.counter("seine_serve_degenerate_requests_total",
                            "empty-candidate requests").inc()
                out.append(np.zeros((0,), np.float32))
                continue
            if batch_pad > 0 and n % batch_pad:
                m = -(-n // batch_pad) * batch_pad
                docs = np.concatenate(
                    [docs, np.full(m - n, docs[0], docs.dtype)])
            real_slots += n
            pad_slots += docs.shape[0] - n
            t0 = time.perf_counter()
            with obs.span("serve.request"):
                s = engine.score(q, docs)
                _sync(s)
            stats.record((time.perf_counter() - t0) * 1e3)
            if defer is not None:
                defer()
            out.append(s.cpu().numpy()[:n])
    finally:
        if defer is not None:
            engine.defer_lookup_stats = prev_defer
    if obs.enabled() and (real_slots or pad_slots):
        obs.counter("seine_serve_slots_total",
                    "real candidate slots scored").inc(real_slots)
        if pad_slots:
            obs.counter("seine_serve_pad_slots_total",
                        "padded candidate slots scored").inc(pad_slots)
        obs.gauge("seine_serve_pad_waste_ratio",
                  "pad / (pad + real) slots, most recent call").set(
            pad_slots / (real_slots + pad_slots))
    return out, stats


def serve_retrieval(engine, queries: Sequence[np.ndarray], k: int
                    ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                               ServeStats]:
    """First-stage serving loop: one corpus-wide top-k retrieval per
    query.  Returns ``([(scores, doc_ids), ...], ServeStats)``, timed as
    in :func:`serve_batches` inside the ``serve.retrieve`` span."""
    stats = ServeStats()
    out = []
    req_counter = obs.counter("seine_retrieve_requests_total",
                              "serve_retrieval requests")
    for q in queries:
        req_counter.inc()
        t0 = time.perf_counter()
        with obs.span("serve.retrieve"):
            s, d = engine.retrieve(q, k)
            _sync(s)
        stats.record((time.perf_counter() - t0) * 1e3)
        out.append((s.cpu().numpy(), d.cpu().numpy()))
    return out, stats
