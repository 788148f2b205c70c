"""Query-time retrieval engine (the paper's retrieval phase, Fig. 1).

Port of ``repro.serving.engine`` without a mesh, a live index or the
``obs`` instrumentation, each of which raises until its slice lands.
``SeineEngine`` looks M_{q,d} up from the segment inverted index (raw or
with packed postings) and scores it with a registered retriever; on CUDA
tensors the lookup, the first-stage scan and KNRM's kernel bank run the
hand-written kernels.  ``NoIndexEngine`` recomputes M at query time
from the docs' tokens (the paper's "No Index" row), through the
``seg_interact`` kernel on CUDA.
``serve_batches`` / ``serve_retrieval`` are the serving loops.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.index import gather_clip
from ..retrievers import QMeta, get_retriever


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
    M); a packed index serves only at its codec tile.  ``mesh=`` and a
    live index are not ported yet and raise ``NotImplementedError``.
    """

    def __init__(self, index, retriever: str, params: Any, *,
                 mesh: Optional[Any] = None,
                 partition: Optional[str] = None,
                 n_shards: Optional[int] = None,
                 lookup_tile: Optional[int] = None,
                 codec: str = "none",
                 codec_tile: Optional[int] = None):
        from ..core.codec import validate_codec
        from ..dist.partition import PartitionedIndex
        codec = validate_codec(codec)
        if partition not in (None, "term"):
            raise ValueError(f"unknown partition scheme {partition!r}; "
                             "supported: 'term'")
        if (codec != "none" and partition != "term"
                and not isinstance(index, PartitionedIndex)):
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
        if getattr(index, "is_live", False):
            raise NotImplementedError("a live index is not ported yet")
        if isinstance(index, PartitionedIndex):
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

    def _ids(self, x) -> torch.Tensor:
        return _as_ids(x, self.device)

    @torch.inference_mode()
    def score(self, query_terms, doc_ids) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> scores (B,) on the device."""
        query_terms, doc_ids = self._ids(query_terms), self._ids(doc_ids)
        m = self.index.qd_matrix(query_terms, doc_ids,
                                 tile=self._lookup_tile)
        meta = make_qmeta(self.index, query_terms, doc_ids)
        return self.spec.score(self.params, m, meta, self.index.functions)

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
        index = self.index
        n_docs = index.n_docs

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
    would grow forever).  ``record`` and the sorted-snapshot cache take a
    lock, so a reader never sorts a deque mid-append."""
    latencies_ms: Sequence[float] = field(default_factory=list)
    window: int = 1 << 16
    _n: int = 0
    _total_ms: float = 0.0
    _snap: Optional[np.ndarray] = field(default=None, repr=False)
    _snap_n: int = -1

    def __post_init__(self):
        self.latencies_ms = deque(self.latencies_ms, maxlen=self.window)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._n += 1
            self._total_ms += ms
            self.latencies_ms.append(ms)

    @property
    def n_requests(self) -> int:
        return self._n

    @property
    def total_ms(self) -> float:
        return self._total_ms

    @property
    def ms_per_request(self) -> float:
        return self._total_ms / max(self._n, 1)

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
    for q, docs in requests:
        docs = np.asarray(docs)
        n = docs.shape[0]
        if n == 0:
            out.append(np.zeros((0,), np.float32))
            continue
        if batch_pad > 0 and n % batch_pad:
            m = -(-n // batch_pad) * batch_pad
            docs = np.concatenate(
                [docs, np.full(m - n, docs[0], docs.dtype)])
        t0 = time.perf_counter()
        s = engine.score(q, docs)
        _sync(s)
        stats.record((time.perf_counter() - t0) * 1e3)
        out.append(s.cpu().numpy()[:n])
    return out, stats


def serve_retrieval(engine, queries: Sequence[np.ndarray], k: int
                    ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                               ServeStats]:
    """First-stage serving loop: one corpus-wide top-k retrieval per
    query.  Returns ``([(scores, doc_ids), ...], ServeStats)``, timed as
    in :func:`serve_batches`."""
    stats = ServeStats()
    out = []
    for q in queries:
        t0 = time.perf_counter()
        s, d = engine.retrieve(q, k)
        _sync(s)
        stats.record((time.perf_counter() - t0) * 1e3)
        out.append((s.cpu().numpy(), d.cpu().numpy()))
    return out, stats
