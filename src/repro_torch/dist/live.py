"""Live (mutable) SEINE index: LSM-style delta runs over a frozen base
(port of ``repro.dist.live``).

The streaming build (``core.build_pipeline``) already produces the right
primitive for incremental indexing: term-sorted posting runs.  A
:class:`LiveIndex` keeps the last full build as an immutable **base**
:class:`~repro_torch.dist.partition.PartitionedIndex` and accumulates
freshly ingested documents as runs merged into a small device-resident
**delta** index; queries serve ``base + delta`` through the same
exclusive-ownership merge the shards already use.  Deletes are a doc-id
**tombstone mask** folded into every found mask (the ops' ``alive``
argument); a background **compaction** re-runs the stage-4 merger over
base + frozen deltas into a new shard generation and swaps it in
atomically.

Exactness contracts (``tests/test_torch_live.py``):

* **Inserts** — doc ids are global and append-only: the base owns
  ``[0, n_base)``, inserted docs land at ``n_base, n_base + 1, ...``.  A
  (term, doc) pair therefore lives in exactly one of base / delta, the
  cross-structure merge is an exclusive write (``x + 0 = x`` exactly in
  float32), and the per-doc interaction pass does not depend on the
  batch's other docs, so every lookup and retrieve result equals a
  rebuild over the merged corpus bit for bit (``avg_doc_len`` included:
  the merged per-doc stats are the arrays a full build computes).
* **Deletes** — the tombstone mask makes a dead doc's pairs resolve to
  the same zeros as absent pairs, and ``retrieve_topk`` masks its scores
  to ``-inf``, so it never surfaces in results.  Corpus statistics (idf
  from the vocabulary; ``doc_len`` / ``seg_len`` keep the dead doc's
  entries) are not updated, the usual LSM staleness policy, which is
  what makes compaction below invisible.
* **Compaction** — drops the postings of docs dead at freeze time,
  merges the remaining base + frozen delta rows into a new generation
  and carries ``idf`` / ``doc_len`` / ``seg_len`` (and for q8 the
  dequantised float32 values) as they are, so the view after the swap
  serves the same bits as the view before it.  A ``packed-q8`` base
  compacts to ``"packed"``: ids stay losslessly packed and values are
  served as the float32 numbers the q8 path was already dequantising to;
  quantising again would recompute the scales and move the values.

Concurrency: mutators (``insert`` / ``delete`` / ``compact``) serialise
on a lock and publish an immutable :class:`LiveView` with a single
attribute store (atomic under the GIL).  Every read takes ``index.view``
once per call and never sees a torn state; a published view is never
mutated.  Ingest and compaction run on PyTorch's default stream, the
stream the serving thread uses, so the device runs their kernels and
copies in the order they were submitted, and no reader's kernel sees a
half-written delta.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.build_pipeline import PostingRun, compute_doc_seg_lengths
from .partition import (PartitionedIndex, _host, partitioned_from_runs,
                        unpack_index)

_log = obs.get_logger("repro.dist.live")

# compaction codec policy: ids stay packed (lossless), q8 values are
# carried as their dequantised float32, never quantised again
_COMPACT_CODEC = {"none": "none", "packed": "packed",
                  "packed-q8": "packed"}


@dataclass(frozen=True)
class LiveView:
    """One immutable serve snapshot of a :class:`LiveIndex`: the base and
    delta generations, the tombstone mask and the merged per-doc stats,
    all on the base's device.  ``delta`` / ``alive`` are None when
    nothing was inserted / deleted since the base."""
    base: PartitionedIndex
    delta: Optional[PartitionedIndex]
    alive: Optional[torch.Tensor]   # (n_docs,) bool; None = nothing dead
    doc_len: torch.Tensor           # (n_docs,) f32, merged base + delta
    seg_len: torch.Tensor           # (n_docs, n_b) f32
    n_docs: int = 0

    # -- stats / metadata passthroughs (the index surface) ------------------

    @property
    def idf(self) -> torch.Tensor:
        return self.base.idf

    @property
    def avg_doc_len(self) -> torch.Tensor:
        return self.doc_len.mean()

    @property
    def functions(self) -> Tuple[str, ...]:
        return self.base.functions

    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size

    @property
    def n_b(self) -> int:
        return self.base.n_b

    @property
    def device(self) -> torch.device:
        return self.base.device

    def fn_index(self, name: str) -> int:
        return self.base.fn_index(name)

    # -- lookups ------------------------------------------------------------

    def lookup_pairs(self, term_ids: torch.Tensor, doc_ids: torch.Tensor
                     ) -> torch.Tensor:
        """(..., Q) term ids x (...,) doc ids -> (..., Q, n_b, n_f).

        ``base.lookup_pairs + delta.lookup_pairs`` with the tombstone
        mask folded into both found masks; the exclusive doc-space
        ownership makes the sum an exclusive write per cell (exact)."""
        v = self.base.lookup_pairs(term_ids, doc_ids, alive=self.alive)
        if self.delta is not None:
            v = v + self.delta.lookup_pairs(term_ids, doc_ids,
                                            alive=self.alive)
        return v

    def lookup_pair_rows(self, terms: torch.Tensor, docs: torch.Tensor
                         ) -> torch.Tensor:
        """Distinct pairs ``terms (P,)`` x ``docs (P,)`` -> (P, n_b, n_f):
        the base's rows (the lookup kernel on CUDA, routed per pair) with
        :meth:`pair_tail` applied."""
        return self.pair_tail(terms, docs,
                              self.base.lookup_pair_rows(terms, docs))

    def pair_tail(self, terms: torch.Tensor, docs: torch.Tensor,
                  base_rows: torch.Tensor) -> torch.Tensor:
        """Rows resolved against the base alone (by the base or a tile
        cache bound to it) -> the live rows: the delta's rows added (an
        exclusive write) and the tombstoned docs' rows zeroed."""
        if self.delta is not None:
            base_rows = base_rows + self.delta.lookup_pair_rows(terms, docs)
        if self.alive is not None:
            from ..kernels.csr_lookup.ref import _alive_at
            keep = _alive_at(self.alive, docs)[:, None, None]
            base_rows = torch.where(keep, base_rows, 0.0)
        return base_rows

    def qd_matrix(self, query_terms: torch.Tensor, doc_ids: torch.Tensor,
                  *, impl: Optional[str] = None, tile: Optional[int] = None
                  ) -> torch.Tensor:
        """query_terms (Q,) x doc_ids (B,) -> M (B, Q, n_b, n_f), the
        serving cartesian over the live ``base + delta - tombstones``."""
        m = self.base.qd_matrix(query_terms, doc_ids, impl=impl, tile=tile,
                                alive=self.alive)
        if self.delta is not None:
            m = m + self.delta.qd_matrix(query_terms, doc_ids, impl=impl,
                                         tile=tile, alive=self.alive)
        return m

    def retrieve_topk(self, query_terms: torch.Tensor, k: int,
                      score_block_fn, *, doc_block: Optional[int] = None,
                      impl: Optional[str] = None, tile: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-stage top-k over the live doc space ``[0, n_docs)``.

        The base drives the block scan with the live doc total (its
        lanes find empty windows past the base corpus); the delta
        contributes per block through the scan's ``extra_m_fn`` hook, an
        exclusive-write add before scoring, with its own lane-bounds
        table for all the blocks; tombstoned docs are zeroed in M and
        masked to ``-inf`` at score time, so they never surface."""
        n = self.n_docs
        block = int(doc_block or min(max(n, 1), 1024))
        extra = None
        if self.delta is not None:
            extra = self.delta.block_scanner(
                query_terms, block, -(-max(n, 1) // block), impl=impl,
                tile=tile, alive=self.alive)
        return self.base.retrieve_topk(
            query_terms, k, score_block_fn, doc_block=block, impl=impl,
            tile=tile, alive=self.alive, n_docs=n, extra_m_fn=extra)


def _index_found(pidx: PartitionedIndex, w: torch.Tensor, d: torch.Tensor
                 ) -> torch.Tensor:
    """Found mask of pair-shaped (term, doc) batches against one
    PartitionedIndex: the positions the serving lookup lands on, through
    the plain routed bisect (ids decoded at the probe only when packed)."""
    from ..core.index import _bisect, gather_clip
    from ..kernels.csr_lookup.ref import _route, bisect_steps, packed_bisect

    k, lo, hi = _route(w, d, pidx.term_offsets, pidx.term_to_shard,
                       pidx.range_lo, pidx.split_term, pidx.split_doc)
    if pidx.codec != "none":
        pos, v = packed_bisect(pidx._packed(), pidx.fences, k, lo, hi, d,
                               tile=pidx.codec_tile, spans=pidx.codec_spans,
                               with_value=True)
        return (pos < hi) & (v == d)
    n_max = pidx.doc_ids.shape[1]
    flat = pidx.doc_ids.reshape(-1)
    base = k.long() * n_max
    pos = _bisect(flat, base + lo, base + hi, d, n_iter=bisect_steps(n_max))
    return (pos < base + hi) & (gather_clip(flat, pos) == d)


@torch.inference_mode()
def found_counts(view: LiveView, query_terms: torch.Tensor,
                 doc_ids: torch.Tensor) -> Tuple[int, int]:
    """(found pairs, valid pairs) of query_terms (Q,) x doc_ids (B,) over
    the live view: the sampled lookup-stats helper of
    :class:`~repro_torch.serving.engine.SeineEngine`."""
    from ..kernels.csr_lookup.ref import _alive_at

    shape = (doc_ids.shape[0], query_terms.shape[0])
    q = query_terms[None].expand(shape)
    d = doc_ids[:, None].expand(shape)
    valid = q >= 0
    f = _index_found(view.base, q.clamp(min=0), d)
    if view.delta is not None:
        # disjoint doc spaces: at most one structure finds any pair
        f = f | _index_found(view.delta, q.clamp(min=0), d)
    if view.alive is not None:
        f = f & _alive_at(view.alive, d)
    return int((f & valid).sum()), int(valid.sum())


def _explode_base(base: PartitionedIndex, alive: Optional[np.ndarray]
                  ) -> PostingRun:
    """Flatten a PartitionedIndex back into ONE (term, doc)-sorted posting
    run on the host, dropping tombstoned rows.

    Shards are term-ranged and each shard's rows are (term asc, doc asc
    within term); a doc-range sub-sharded term continues into the next
    shard at a strictly higher doc id, so the shards' live rows in shard
    order ARE the global order, no sort needed.  Packed bases unpack
    first (ids decode bitwise; q8 values come back as the float32 the
    serving path dequantises to)."""
    b = unpack_index(base)
    offs = _host(b.term_offsets).astype(np.int64)
    dids = _host(b.doc_ids)
    vals = _host(b.values)
    r_lo = _host(b.range_lo).astype(np.int64)
    ts, ds, vs = [], [], []
    for i in range(b.n_shards):
        nnz = int(offs[i, -1])
        counts = np.diff(offs[i])           # padding rows diff to 0
        t_loc = np.repeat(np.arange(counts.shape[0], dtype=np.int64),
                          counts)
        ts.append((t_loc + r_lo[i]).astype(np.int32))
        ds.append(dids[i, :nnz])
        vs.append(vals[i, :nnz])
    t = np.concatenate(ts) if ts else np.zeros(0, np.int32)
    d = np.concatenate(ds) if ds else np.zeros(0, np.int32)
    v = (np.concatenate(vs) if vs
         else np.zeros((0, b.n_b, len(b.functions)), np.float32))
    del vals, vs
    if alive is not None:
        keep = alive[d]                     # stored ids < n_docs always
        t, d, v = t[keep], d[keep], v[keep]
    return PostingRun.from_arrays(np.ascontiguousarray(t),
                                  np.ascontiguousarray(d),
                                  np.ascontiguousarray(v, np.float32))


def _filter_run(run: PostingRun, alive: np.ndarray) -> PostingRun:
    """Drop a run's tombstoned rows (at compaction freeze time)."""
    t, d, v = run.load()
    keep = alive[d]
    if keep.all():
        return run
    return PostingRun.from_arrays(np.ascontiguousarray(t[keep]),
                                  np.ascontiguousarray(d[keep]),
                                  np.ascontiguousarray(v[keep]))


class LiveIndex:
    """Mutable serving index: inserts, deletes and background compaction
    over a :class:`~repro_torch.dist.partition.PartitionedIndex` base, on
    the base's device.

    Args (constructor):
        base: the frozen full build (any codec; generation 0).
        pipeline: the :class:`~repro_torch.core.build_pipeline.
            BuildPipeline` that built it (``IndexBuilder.pipeline``):
            delta runs stream through the same stage 1-3 device
            pipeline, so an ingested doc's postings are bitwise what a
            full rebuild gives it.
        delta_shards: shard count of the delta index (default 1: the
            delta is small by design; compaction folds it into the
            base's ``n_shards``-way layout).
        batch_size: stage 1-3 device batch for ``insert``.
        ckpt_dir: when set, each compaction persists the new generation
            there through :func:`repro_torch.ckpt.save_index`, whose
            tmp-dir + move-aside publish is the on-disk half of the
            epoch swap.

    Mutators (``insert`` / ``delete`` / ``update`` / ``compact``) are
    thread-safe against each other and against concurrent readers; see
    the module docstring for the exactness contracts.  Readers use
    :attr:`view` (one immutable snapshot per call) or the delegating
    ``lookup_pairs`` / ``qd_matrix`` / ``retrieve_topk`` below.
    """

    is_live = True

    def __init__(self, base: PartitionedIndex, pipeline, *,
                 delta_shards: int = 1, batch_size: int = 32,
                 ckpt_dir: Optional[str] = None):
        if not isinstance(base, PartitionedIndex):
            raise TypeError("LiveIndex wraps a PartitionedIndex base, got "
                            f"{type(base).__name__}")
        if delta_shards < 1:
            raise ValueError(f"delta_shards must be >= 1, got {delta_shards}")
        self._lock = threading.RLock()
        self._pl = pipeline
        self._base = base
        self._delta: Optional[PartitionedIndex] = None
        self._delta_runs: list = []
        self._delta_shards = int(delta_shards)
        self._batch_size = int(batch_size)
        self._ckpt_dir = ckpt_dir
        self._doc_len = _host(base.doc_len).astype(np.float32).copy()
        self._seg_len = _host(base.seg_len).astype(np.float32).copy()
        self._alive = np.ones(int(base.n_docs), bool)
        self._n_docs = int(base.n_docs)
        self._n_dead = 0
        self._generation = 0
        self._compaction: Optional[threading.Thread] = None
        self._compaction_error: Optional[BaseException] = None
        self._publish()

    # -- snapshot / delegating reads ----------------------------------------

    @property
    def view(self) -> LiveView:
        """The current immutable serve snapshot (atomic read)."""
        return self._view

    def lookup_pairs(self, term_ids, doc_ids):
        """See :meth:`LiveView.lookup_pairs` (delegates to a snapshot)."""
        return self._view.lookup_pairs(term_ids, doc_ids)

    def qd_matrix(self, query_terms, doc_ids, *, impl=None, tile=None):
        """See :meth:`LiveView.qd_matrix` (delegates to a snapshot)."""
        return self._view.qd_matrix(query_terms, doc_ids, impl=impl,
                                    tile=tile)

    def retrieve_topk(self, query_terms, k, score_block_fn, *,
                      doc_block=None, impl=None, tile=None):
        """See :meth:`LiveView.retrieve_topk` (delegates to a snapshot)."""
        return self._view.retrieve_topk(query_terms, k, score_block_fn,
                                        doc_block=doc_block, impl=impl,
                                        tile=tile)

    # -- index metadata surface (engine / obs) -------------------------------

    @property
    def device(self) -> torch.device:
        return self._base.device

    @property
    def n_docs(self) -> int:
        return self._view.n_docs

    @property
    def doc_len(self) -> torch.Tensor:
        return self._view.doc_len

    @property
    def seg_len(self) -> torch.Tensor:
        return self._view.seg_len

    @property
    def idf(self) -> torch.Tensor:
        return self._base.idf

    @property
    def avg_doc_len(self) -> torch.Tensor:
        return self._view.avg_doc_len

    @property
    def functions(self) -> Tuple[str, ...]:
        return self._base.functions

    def fn_index(self, name: str) -> int:
        return self._base.fn_index(name)

    @property
    def vocab_size(self) -> int:
        return self._base.vocab_size

    @property
    def n_b(self) -> int:
        return self._base.n_b

    @property
    def n_shards(self) -> int:
        return self._base.n_shards

    @property
    def codec(self) -> str:
        return self._base.codec

    @property
    def codec_tile(self) -> int:
        return self._base.codec_tile

    @property
    def nmax(self) -> int:
        return self._base.nmax

    @property
    def doc_ids(self):
        return self._base.doc_ids

    @property
    def term_to_shard(self) -> torch.Tensor:
        return self._base.term_to_shard

    @property
    def base(self) -> PartitionedIndex:
        """The current immutable base generation (tile caches bind it)."""
        return self._base

    @property
    def generation(self) -> int:
        """Bumps once per completed compaction (the epoch number)."""
        return self._generation

    @property
    def nnz(self) -> int:
        v = self._view
        return v.base.nnz + (v.delta.nnz if v.delta is not None else 0)

    @property
    def nbytes(self) -> int:
        v = self._view
        return v.base.nbytes + (v.delta.nbytes if v.delta is not None
                                else 0)

    @property
    def delta_nnz(self) -> int:
        v = self._view
        return v.delta.nnz if v.delta is not None else 0

    @property
    def tombstones(self) -> int:
        return self._n_dead

    # -- mutators -----------------------------------------------------------

    def insert(self, tokens: np.ndarray, seg_ids: np.ndarray,
               *, batch_size: Optional[int] = None) -> np.ndarray:
        """Ingest documents; returns their global doc ids.

        ``tokens`` / ``seg_ids`` are (n, Lp) as for the full build (-1
        token padding).  The docs stream through build stages 1-3 with
        ``doc_start`` at the current corpus end, their runs join the
        delta run list, and the delta index is merged again (stage 4 over
        the accumulated runs; the streamed postings are never
        recomputed)."""
        tokens = np.asarray(tokens)
        seg_ids = np.asarray(seg_ids)
        if tokens.ndim != 2 or tokens.shape != seg_ids.shape:
            raise ValueError(
                f"tokens/seg_ids must be matching (n, Lp) arrays, got "
                f"{tokens.shape} vs {seg_ids.shape}")
        n = int(tokens.shape[0])
        with self._lock, obs.span("live.ingest"):
            doc_start = self._n_docs
            spiller, _ = self._pl.stream_runs(
                tokens, seg_ids, doc_start=doc_start,
                batch_size=batch_size or self._batch_size)
            self._delta_runs.extend(spiller.runs)
            dl, sl = compute_doc_seg_lengths(tokens, seg_ids,
                                             self._base.n_b)
            self._doc_len = np.concatenate([self._doc_len, dl])
            self._seg_len = np.concatenate([self._seg_len, sl], axis=0)
            self._alive = np.concatenate([self._alive, np.ones(n, bool)])
            self._n_docs += n
            self._rebuild_delta()
            self._publish()
        obs.counter("seine_live_ingest_docs_total",
                    "documents ingested into the live index").inc(n)
        return np.arange(doc_start, doc_start + n, dtype=np.int64)

    def delete(self, doc_ids) -> int:
        """Tombstone documents by global id; returns how many were newly
        deleted (already-dead ids are a no-op, never an error).  Deletion
        is immediate for results and permanent: doc ids are never reused
        (an update ingests again under a fresh id)."""
        ids = np.unique(np.atleast_1d(np.asarray(doc_ids, np.int64)))
        with self._lock:
            if ids.size and (ids.min() < 0 or ids.max() >= self._n_docs):
                raise ValueError(
                    f"doc ids out of range [0, {self._n_docs}): "
                    f"{ids[(ids < 0) | (ids >= self._n_docs)][:8]}")
            newly = int(self._alive[ids].sum())
            self._alive[ids] = False
            self._n_dead += newly
            self._publish()
        obs.counter("seine_live_deletes_total",
                    "documents tombstoned in the live index").inc(newly)
        return newly

    def update(self, doc_ids, tokens: np.ndarray, seg_ids: np.ndarray
               ) -> np.ndarray:
        """Replace documents: tombstone the old ids, ingest the new
        content, return the NEW global ids (ids are append-only)."""
        self.delete(doc_ids)
        return self.insert(tokens, seg_ids)

    # -- compaction (the background generation merge + epoch swap) ----------

    def compact(self, *, wait: bool = True) -> Optional[threading.Thread]:
        """Merge base + frozen deltas into a new generation.

        Freezes the delta run list and the tombstone set under the lock,
        runs the stage-4 merger OFF the lock (queries and further inserts
        proceed meanwhile; their runs land after the freeze point and
        survive into the next delta), then swaps the new generation in
        with one snapshot publish, so no reader sees a torn epoch.  The
        view after the swap serves the same bits as the view before it.
        ``wait=False`` runs the merge on a daemon thread;
        :meth:`wait_compaction` joins it and raises its failure, if any.
        """
        with self._lock:
            if self._compaction is not None and self._compaction.is_alive():
                raise RuntimeError("a compaction is already running")
            self._compaction_error = None
            frozen = list(self._delta_runs)
            n_frozen = len(frozen)
            frozen_docs = self._n_docs
            alive_snap = self._alive[:frozen_docs].copy()
            doc_len_snap = self._doc_len[:frozen_docs].copy()
            seg_len_snap = self._seg_len[:frozen_docs].copy()
            base = self._base

        def run():
            try:
                if not wait:
                    # the merge is host work; on a small host it would
                    # time-slice against the serving threads and stretch
                    # the query tail, so the merge thread drops to the
                    # lowest OS priority and yields to any query thread
                    # that wakes (best effort: platforms without
                    # per-thread setpriority run it at normal priority)
                    try:
                        os.setpriority(os.PRIO_PROCESS,
                                       threading.get_native_id(), 19)
                    except (AttributeError, OSError):  # pragma: no cover
                        pass
                with obs.span("live.compact"):
                    runs = [_explode_base(base, alive_snap)]
                    runs += [_filter_run(r, alive_snap) for r in frozen]
                    codec = _COMPACT_CODEC[base.codec]
                    new_base = partitioned_from_runs(
                        runs, base.n_shards, idf=_host(base.idf),
                        doc_len=doc_len_snap, seg_len=seg_len_snap,
                        n_docs=frozen_docs, vocab_size=base.vocab_size,
                        n_b=base.n_b, functions=base.functions,
                        codec=codec,
                        codec_tile=(base.codec_tile or None)
                        if codec != "none" else None,
                        device=base.device)
                    del runs
                    if self._ckpt_dir is not None:
                        from ..ckpt import save_index
                        save_index(self._ckpt_dir, new_base)
                with self._lock:
                    self._base = new_base
                    del self._delta_runs[:n_frozen]
                    self._generation += 1
                    self._rebuild_delta()
                    self._publish()
                obs.counter("seine_live_compactions_total",
                            "completed live-index compactions").inc()
            except BaseException as e:
                self._compaction_error = e
                obs.counter("seine_live_compaction_errors_total",
                            "failed live-index compactions").inc()
                _log.error("compaction failed", err=repr(e))
                if wait:
                    raise

        if wait:
            try:
                run()
            finally:
                self._compaction_error = None
            return None
        t = threading.Thread(target=run, name="seine-live-compaction",
                             daemon=True)
        self._compaction = t
        t.start()
        return t

    def wait_compaction(self) -> None:
        """Join a background :meth:`compact(wait=False) <compact>` and
        raise its failure, if any."""
        t = self._compaction
        if t is not None:
            t.join()
        err, self._compaction_error = self._compaction_error, None
        if err is not None:
            raise err

    # -- internals ----------------------------------------------------------

    def _rebuild_delta(self) -> None:
        """Stage-4 merge of the accumulated delta runs (lock held)."""
        if not self._delta_runs:
            self._delta = None
            return
        base = self._base
        self._delta = partitioned_from_runs(
            self._delta_runs, self._delta_shards, idf=_host(base.idf),
            doc_len=self._doc_len[base.n_docs:],
            seg_len=self._seg_len[base.n_docs:],
            # the live total: pads the delta's doc_ids rows past every
            # real id (the convention the base build uses)
            n_docs=self._n_docs, vocab_size=base.vocab_size,
            n_b=base.n_b, functions=base.functions, codec="none",
            device=base.device)

    def _publish(self) -> None:
        """Build and install a fresh LiveView (lock held).  Its tensors are
        copies: later mutations of the host arrays never reach it."""
        dev = self._base.device
        to_dev = lambda a: torch.from_numpy(a.copy()).to(dev)
        self._view = LiveView(
            base=self._base, delta=self._delta,
            alive=to_dev(self._alive) if self._n_dead else None,
            doc_len=to_dev(self._doc_len), seg_len=to_dev(self._seg_len),
            n_docs=int(self._n_docs))
        if obs.enabled():
            obs.gauge("seine_live_docs",
                      "docs in the live doc-id space (incl. tombstoned)"
                      ).set(self._n_docs)
            obs.gauge("seine_live_delta_nnz",
                      "postings in the live delta index").set(
                self._delta.nnz if self._delta is not None else 0)
            obs.gauge("seine_live_delta_runs",
                      "delta runs awaiting compaction").set(
                len(self._delta_runs))
            obs.gauge("seine_live_tombstones",
                      "tombstoned (deleted) docs").set(self._n_dead)
            obs.gauge("seine_live_generation",
                      "base generation (bumps per compaction)").set(
                self._generation)


def live_index(builder, tokens: np.ndarray, seg_ids: np.ndarray,
               k: int = 1, *, batch_size: int = 32,
               delta_shards: int = 1, ckpt_dir: Optional[str] = None,
               codec: str = "none", codec_tile: Optional[int] = None,
               ) -> LiveIndex:
    """Build a base index from ``tokens`` / ``seg_ids`` and wrap it live:
    :meth:`~repro_torch.core.builder.IndexBuilder.build_partitioned` +
    :class:`LiveIndex` over the builder's pipeline, on its device."""
    base = builder.build_partitioned(
        tokens, seg_ids, k, batch_size=batch_size, codec=codec,
        codec_tile=codec_tile)
    return LiveIndex(base, builder.pipeline, batch_size=batch_size,
                     delta_shards=delta_shards, ckpt_dir=ckpt_dir)


__all__ = ["LiveIndex", "LiveView", "found_counts", "live_index"]
